"""Single-file checkpoints, format v1 (port of the dense format of
``bpe_transformer_tpu/checkpointing/checkpoint.py``).

A checkpoint is a pickled dict ``{"format_version": 1, "params",
"opt_state", "iteration", "extra"}`` whose tensors are numpy arrays, written
to a temp file and renamed into place, with a CRC32 sidecar
(``resilience/integrity.py``).  The port writes its own ``AdamWState``; a
checkpoint the JAX package wrote loads here: its pickle names
``bpe_transformer_tpu.optim.adamw.AdamWState``, which the loader maps to the
port's class without importing the JAX package, and any other global of the
JAX package or of JAX is refused.  The JAX package does not read the port's
checkpoints yet, and the sharded directory format (v2) is not ported: both
come with the multi-GPU training slice.

:func:`load_checkpoint_with_fallback` is the resume path: it verifies a
snapshot against its CRC32 sidecar before loading it, quarantines one that
fails and falls back to the newest valid earlier snapshot, with the JAX
package's rules.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import threading
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np
import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.optim.adamw import AdamWState
from bpe_transformer_tpu_torch.resilience.integrity import (
    Crc32Writer,
    candidate_snapshots,
    quarantine,
    snapshot_step,
    verify_checkpoint,
    write_sidecar,
)
from bpe_transformer_tpu_torch.tree import tree_map

_FORMAT_VERSION = 1


def _host_array(t, copy: bool = False) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            raise ValueError("bfloat16 tensors have no numpy dtype; checkpoint float32 masters")
        host = t.detach().cpu()
        if copy and t.device.type == "cpu":
            # A CPU tensor's .cpu() is the tensor itself: copy it when the
            # snapshot must outlive the next in-place update.
            host = host.clone()
        return host.numpy()
    return np.asarray(t)


def _to_host(state, copy: bool = False):
    """The state as numpy arrays; ``copy`` guarantees arrays that share no
    memory with the live tensors."""
    host = lambda t: _host_array(t, copy)  # noqa: E731
    if isinstance(state, AdamWState):
        return AdamWState(
            step=np.asarray(int(state.step), dtype=np.int32),
            m=tree_map(host, state.m),
            v=tree_map(host, state.v),
        )
    return tree_map(host, state)


def save_checkpoint(
    out: str | os.PathLike | BinaryIO,
    *,
    params: Any,
    opt_state: AdamWState | None = None,
    iteration: int = 0,
    extra: dict | None = None,
) -> None:
    """Serialize a training state snapshot to ``out`` (a path, written
    atomically with its CRC32 sidecar, or a binary file object)."""
    payload = {
        "format_version": _FORMAT_VERSION,
        "params": _to_host(params),
        "opt_state": _to_host(opt_state) if opt_state is not None else None,
        "iteration": int(iteration),
        "extra": extra or {},
    }
    if hasattr(out, "write"):
        pickle.dump(payload, out)
        return
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer = Crc32Writer(f)
            pickle.dump(payload, writer)
        os.replace(tmp_name, path)
        write_sidecar(path, writer.crc, writer.size)
    except BaseException:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)
        raise


class _Unpickler(pickle.Unpickler):
    """Maps the JAX package's ``AdamWState`` to the port's and refuses every
    other global of the JAX package or of JAX."""

    def find_class(self, module, name):
        if (module, name) == ("bpe_transformer_tpu.optim.adamw", "AdamWState"):
            return AdamWState
        if module.split(".")[0] in ("bpe_transformer_tpu", "jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}, which the port does not load"
            )
        return super().find_class(module, name)


def load_checkpoint(src: str | os.PathLike | BinaryIO) -> dict:
    """Load a single-file snapshot (path or binary file object); returns the
    payload dict with numpy arrays (:func:`training_state` puts it on a
    device)."""
    if hasattr(src, "read"):
        payload = _Unpickler(src).load()
    else:
        if Path(src).is_dir():
            raise ValueError(
                f"{src} is a directory: the sharded checkpoint format is not ported yet "
                "(it comes with the multi-GPU training slice)"
            )
        with open(src, "rb") as f:
            payload = _Unpickler(f).load()
    version = payload.get("format_version")
    if version != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format version: {version}")
    return payload


def training_state(payload: dict, device: str | torch.device = "cuda"):
    """``(params, opt_state)`` of a loaded payload as tensors on ``device``
    (``opt_state`` None when the checkpoint holds none; its step stays on
    the host, as :mod:`optim.adamw` keeps it)."""
    dev = resolve_device(device)
    to_dev = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    params = tree_map(to_dev, payload["params"])
    opt = payload.get("opt_state")
    if opt is None:
        return params, None
    opt_state = AdamWState(
        step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32),
        m=tree_map(to_dev, opt.m),
        v=tree_map(to_dev, opt.v),
    )
    return params, opt_state


class CheckpointCorruptionError(RuntimeError):
    """No loadable checkpoint: the requested snapshot and every earlier
    sibling failed verification or loading.  ``failures`` lists why."""

    def __init__(self, message: str, failures: list[str]):
        super().__init__(message)
        self.failures = failures


def _quarantine_snapshot(path: Path) -> Path | None:
    """Quarantine a corrupt snapshot; a symlink quarantines its target and
    drops the dangling link."""
    if path.is_symlink():
        try:
            target = path.resolve(strict=False)
        except OSError:
            target = None
        path.unlink()
        if target is not None and (target.exists() or target.is_symlink()):
            return quarantine(target)
        return None
    if path.exists():
        return quarantine(path)
    return None


def load_checkpoint_with_fallback(src: str | os.PathLike, loader=None) -> tuple[dict, Path]:
    """Load ``src``, falling back to the newest earlier valid snapshot in
    its directory when it is corrupt, and quarantining (never deleting)
    every snapshot that fails on the way.  Returns ``(payload, used_path)``.

    ``loader`` defaults to :func:`load_checkpoint`.  As in the JAX package:

    * only snapshots whose step is strictly below the requested one are
      candidates (``latest.ckpt`` has no step: every snapshot is), so a
      resume from an old snapshot is never moved forward;
    * a snapshot whose bytes match its checksum but whose load raises is
      an error of the caller or the environment, not corruption: the
      error is re-raised and the snapshot left in place.  Only a snapshot
      without a sidecar is quarantined for a failed load.
    """
    loader = loader or load_checkpoint
    src = Path(src)
    try:
        exclude = {src.resolve()}
    except OSError:
        exclude = set()
    siblings = candidate_snapshots(src.parent, exclude=exclude)
    src_step = snapshot_step(src.name)
    if src_step is not None:
        siblings = [p for p in siblings if (snapshot_step(p.name) or 0) < src_step]
    failures: list[str] = []
    for path in [src] + siblings:
        result = verify_checkpoint(path)
        if not result.ok:
            failures.append(f"{path}: {'; '.join(result.problems) or 'invalid'}")
            quarantined = _quarantine_snapshot(path)
            print(
                f"checkpoint {path} failed integrity verification"
                + (f" (quarantined as {quarantined})" if quarantined else "")
                + f": {'; '.join(result.problems)}",
                file=sys.stderr,
            )
            continue
        try:
            payload = loader(path)
        except Exception as exc:  # noqa: BLE001 - triaged below
            if not result.warnings:  # every byte matched its checksum
                raise
            failures.append(f"{path}: load failed ({exc})")
            quarantined = _quarantine_snapshot(path)
            print(
                f"checkpoint {path} failed to load ({exc})"
                + (f"; quarantined as {quarantined}" if quarantined else ""),
                file=sys.stderr,
            )
            continue
        if failures:
            print(
                f"resumed from fallback snapshot {path} after {len(failures)} corrupt "
                "candidate(s)",
                file=sys.stderr,
            )
        return payload, path
    raise CheckpointCorruptionError(
        f"no loadable checkpoint at {src} or among its siblings ({len(failures)} "
        "candidate(s) failed; corrupt snapshots were quarantined with a .corrupt suffix)",
        failures,
    )


class AsyncCheckpointer:
    """Overlap checkpoint writing with training (the port of the JAX
    package's dense ``AsyncCheckpointer``).

    ``save()`` copies every tensor to host numpy SYNCHRONOUSLY (a blocking
    copy: the port's AdamW rewrites the parameters and moments in place at
    the next step, so the snapshot must be complete before ``save``
    returns) and hands pickling, the CRC and the file IO to one background
    thread.  At most one write is in flight: the next ``save()`` (or
    ``wait()``/``close()``) joins the previous one first and re-raises any
    error it hit.  The snapshot holds one host copy of the state for the
    duration of the write.
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        """Block until the in-flight write (if any) finishes; re-raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, out: str | os.PathLike, *, params: Any, opt_state: AdamWState | None = None,
             iteration: int = 0, extra: dict | None = None, on_complete=None) -> None:
        """Snapshot now, write in the background.  ``on_complete()`` runs on
        the writer thread after a successful write (the loop points
        ``latest.ckpt`` at the new file there)."""
        self.wait()
        host_params = _to_host(params, copy=True)
        host_opt = _to_host(opt_state, copy=True) if opt_state is not None else None

        def work():
            try:
                save_checkpoint(out, params=host_params, opt_state=host_opt,
                                iteration=iteration, extra=extra)
                if on_complete is not None:
                    on_complete()
            except BaseException as exc:  # noqa: BLE001 - re-raised in wait()
                self._error = exc

        self._thread = threading.Thread(target=work, name="async-checkpoint", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.wait()
