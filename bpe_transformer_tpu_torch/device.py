"""Device resolution: the port's counterpart of ``kernels/pallas/runtime.py``.

The JAX package picks Pallas interpret mode whenever the backend is not a
TPU.  The port never falls back silently: an entry point runs on the card
unless its caller asked for the CPU by name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    ``"cuda"`` (the default of every entry point) raises ``RuntimeError``
    when CUDA is unavailable: running on the CPU takes an explicit
    ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' "
            "explicitly to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev
