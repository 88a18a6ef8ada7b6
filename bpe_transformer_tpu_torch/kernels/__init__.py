"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version and a launch counter (see ``_build.py`` for the build)."""
