"""Where the compiled kernels live (``--compile-cache DIR``; the port's
counterpart of ``bpe_transformer_tpu/utils/compile_cache.py``).

The JAX package points XLA's persistent compilation cache at a directory.
The port has no XLA programs: its compiled artifacts are the ``nvcc`` builds
of ``csrc/*.cu`` (``kernels/_build.py``), one library per source under
``BUILD_ROOT/<hash of the sources and flags>/``.  Pointing ``BUILD_ROOT`` at
a directory that outlives the checkout lets a respawned trainer or a
restarted replica load the libraries instead of compiling them again
(85-145 s for all eight on one H100, ``PERF.md``), and ``warmup`` fills it
ahead of time.
"""

from __future__ import annotations

from pathlib import Path


def enable_compile_cache(cache_dir: str | Path) -> Path:
    """Build and load the CUDA kernels under ``cache_dir`` from now on;
    creates it and returns it.  Libraries loaded before the call stay
    loaded (a process loads each library once)."""
    from bpe_transformer_tpu_torch.kernels import _build

    cache_dir = Path(cache_dir).resolve()
    cache_dir.mkdir(parents=True, exist_ok=True)
    _build.BUILD_ROOT = cache_dir
    return cache_dir


def kernel_sources(config, *, train: bool = False, paged: bool = False,
                   weight_dtypes=(None,), fused_sampling: bool = False,
                   role: str = "both") -> set[str]:
    """The ``csrc/*.cu`` sources (by stem) whose kernels a run launches on
    the card: the training step and eval (``train``), or an engine serving
    ``config``.  The rules are the model's dispatch rules:

    * attention: ``attention_impl`` "flash"/"flash_fused" runs
      ``flash_attention`` (and, in training, ``flash_attention_bwd``); the
      paged engine's chunked prefill does not;
    * the FFN: a SwiGLU FFN at ``ffn_impl="pallas"`` runs ``swiglu`` where
      its weights are at the activation width, a ``gelu`` FFN runs
      ``gelu``; MoE experts and ``silu`` run plain;
    * the decode tick (not on a prefill replica): ``decode_attention_impl``
      "pallas" runs ``decode_attention``, "paged" ``paged_decode_attention``;
      ``fused_sampling`` ends it with ``sample``;
    * int8 weights (``weight_dtypes`` holding "int8") run ``quant_matmul``.
    """
    sources: set[str] = set()
    flash = config.attention_impl in ("flash", "flash_fused")
    act_weights = train or None in weight_dtypes
    if config.ffn_type in (None, "swiglu") and config.ffn_impl == "pallas" and act_weights:
        sources.add("swiglu")
    if config.ffn_type == "gelu":
        sources.add("gelu")
    if train:
        if flash:
            sources |= {"flash_attention", "flash_attention_bwd"}
        return sources
    if flash and not paged:
        sources.add("flash_attention")
    if "int8" in weight_dtypes:
        sources.add("quant_matmul")
    if role != "prefill":
        impl = config.decode_attention_impl
        if impl == "pallas":
            sources.add("decode_attention")
        elif impl == "paged":
            sources.add("paged_decode_attention")
        if fused_sampling:
            sources.add("sample")
    return sources
