"""PyTorch + CUDA port of the ``bpe_transformer_tpu`` serving path.

The package imports ``torch`` and numpy only.  Module names mirror the JAX
package (``models/config.py``, ``models/decode.py``, ``serving/engine.py``
...), so each module's counterpart is found at the same relative path.

Every kernel the JAX package wrote in Pallas for the TPU and that the
serving path runs is a hand-written CUDA C++ kernel for Hopper
(``csrc/*.cu``, built at first use by ``kernels/_build.py``).  Each kernel
module keeps a plain PyTorch version beside the kernel: wrappers run it for
CPU tensors only, and launch the kernel (or raise) for CUDA tensors.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; on a
host without CUDA they raise unless the caller passes ``device="cpu"``
(:func:`bpe_transformer_tpu_torch.device.resolve_device`).
"""

from bpe_transformer_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
