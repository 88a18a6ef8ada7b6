"""Run manifests: the self-describing header record of every telemetry stream
(the port's rewrite of ``bpe_transformer_tpu/telemetry/manifest.py``: the
device probe reads torch and CUDA, not jax).

A capture JSON or metrics JSONL found weeks later must answer "what code, on
what hardware, at what config produced this?" without the shell history that
launched it.  ``run_manifest`` collects exactly that — config dicts,
torch/CUDA/device facts, git SHA, host — as one JSON-serializable dict with
``kind="manifest"``, logged first into a serving stream.  There is no
``jax_version`` key (the JAX package's ``report`` prints ``?`` for it);
``torch_version``, ``cuda_version``, ``device_kind`` and ``device_count``
take its place, and ``devices`` keeps the shape the JAX tools read.

Everything here degrades gracefully: no git checkout or no card just omits
or nulls those fields rather than failing the run it describes.
"""

from __future__ import annotations

import dataclasses
import platform
import socket
import subprocess
import sys
import time
from pathlib import Path


def git_sha(cwd: str | Path | None = None) -> str | None:
    """The current commit SHA (with ``-dirty`` suffix when the tree has
    uncommitted changes), or None outside a git checkout."""
    if cwd is None:
        cwd = Path(__file__).resolve().parent
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd, capture_output=True, text=True, timeout=5,
        )
        if sha.returncode != 0:
            return None
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        dirty = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=cwd, capture_output=True, text=True, timeout=5,
        )
        suffix = "-dirty" if dirty.returncode == 0 and dirty.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        # The dirty check is best-effort decoration — a slow `git status`
        # (large tree, cold NFS) must not discard the SHA already in hand.
        suffix = ""
    return sha.stdout.strip() + suffix


def _config_dict(config) -> dict | None:
    if config is None:
        return None
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return dataclasses.asdict(config)
    if isinstance(config, dict):
        return dict(config)
    return {"repr": repr(config)}


def host_manifest(kind: str) -> dict:
    """The header record without the device probe: host, interpreter, argv
    and git SHA."""
    return {
        "kind": "manifest",
        "run_kind": kind,
        "time_utc": time.strftime("%Y-%m-%dT%H:%M:%S+00:00", time.gmtime()),
        "host": socket.gethostname(),
        "python": platform.python_version(),
        "argv": list(sys.argv),
        "git_sha": git_sha(),
    }


def device_facts() -> dict:
    """torch/CUDA versions and the first visible card (``device_kind`` is
    ``torch.cuda.get_device_name(0)``; None fields and a ``"cpu"`` platform
    on a host without CUDA)."""
    import torch

    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else None
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_kind": kind,
        "device_count": count,
        "devices": {
            "platform": "gpu" if cuda else "cpu",
            "kind": kind or "cpu",
            "count": count or 1,
        },
    }


def run_manifest(
    kind: str = "train",
    model_config=None,
    loop_config=None,
    parallel: str | None = None,
    extra: dict | None = None,
) -> dict:
    """Build the header record; configs may be dataclasses or dicts."""
    record: dict = host_manifest(kind)
    record.update(device_facts())
    if parallel is not None:
        record["parallel"] = parallel
    if model_config is not None:
        record["model_config"] = _config_dict(model_config)
    if loop_config is not None:
        record["loop_config"] = _config_dict(loop_config)
    if extra:
        record.update(extra)
    return record


def attach_manifest(payload: dict, kind: str, **kwargs) -> dict:
    """Best-effort: embed ``run_manifest(kind, **kwargs)`` as
    ``payload["manifest"]``.  A capture payload must never lose its
    measurement to the manifest: on any failure the payload comes back
    without one and the error goes to stderr."""
    try:
        payload["manifest"] = run_manifest(kind=kind, **kwargs)
    except Exception as exc:
        print(f"manifest attach failed: {exc!r}", file=sys.stderr)
    return payload
