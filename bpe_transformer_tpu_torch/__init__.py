"""PyTorch + CUDA port of ``bpe_transformer_tpu``: BPE tokenization,
transformer LM training (one card and across cards) and serving.

The package imports ``torch`` and numpy only.  Module names mirror the JAX
package (``models/config.py``, ``models/decode.py``, ``serving/engine.py``
...), so each module's counterpart is found at the same relative path.

Every kernel the JAX package wrote in Pallas for the TPU is a
hand-written CUDA C++ kernel for Hopper
(``csrc/*.cu``, built at first use by ``kernels/_build.py``).  Each kernel
module keeps a plain PyTorch version beside the kernel: wrappers run it for
CPU tensors only, and launch the kernel (or raise) for CUDA tensors.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; on a
host without CUDA they raise unless the caller passes ``device="cpu"``
(:func:`bpe_transformer_tpu_torch.device.resolve_device`).
"""

from bpe_transformer_tpu_torch._lazy import lazy_attrs

__version__ = "0.1.0"

__all__ = ["BPETokenizer", "BPETrainer", "Tokenizer", "resolve_device", "train_bpe",
           "__version__"]

# Lazy: the fleet's front-end modules (router, controller, fleet, incident,
# the KV wire codec) import without torch.
__getattr__ = lazy_attrs(__name__, {
    "BPETokenizer": "tokenization",
    "BPETrainer": "tokenization",
    "Tokenizer": "tokenization",
    "resolve_device": "device",
    "train_bpe": "tokenization",
})
