"""Checkpoint retention: keep the last N snapshots, reclaim crash debris (the
port's copy of ``bpe_transformer_tpu/resilience/retention.py``).

A long run with ``--checkpoint-every`` in the thousands writes an unbounded
number of ``step_*.ckpt`` snapshots; on local disks that fills the boot
volume mid-run.  :func:`gc_checkpoints` enforces ``--keep-checkpoints N``
with three safety rules:

* the snapshot ``latest.ckpt`` points at is NEVER deleted (even if it has
  rotated out of the newest N — it is the resume target);
* quarantined ``*.corrupt`` snapshots are left alone (forensic evidence;
  they don't count against N either);
* stranded write debris (``*.ckpt.tmp*`` temp files/dirs and marker-carrying
  ``*.ckpt.old*`` displaced-orphan dirs from crashed saves) is reclaimed
  only when OLDER than the newest valid snapshot — an in-flight async write
  is always at least as new as the snapshot before it.

torch-free; operates purely on the directory layout the training loop writes.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path

from bpe_transformer_tpu_torch.resilience.integrity import (
    sidecar_path,
    snapshot_step,
)

#: The marker the JAX package's sharded checkpoint writer drops in a
#: displaced directory (``bpe_transformer_tpu/checkpointing/checkpoint.py``
#: ``_DISPLACED_MARKER``): a directory left by either package is reclaimed by
#: the same rule.
_DISPLACED_MARKER = ".bt_displaced"
_DEBRIS_RE = re.compile(r"\.ckpt\.(tmp|old)")


def _remove(path: Path) -> None:
    if path.is_dir() and not path.is_symlink():
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            path.unlink()
        except OSError:
            pass


def gc_checkpoints(
    ckpt_dir: str | os.PathLike,
    keep: int,
    log_fn=None,
) -> list[Path]:
    """Delete loop snapshots beyond the newest ``keep`` (see module rules);
    returns the paths removed."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []

    snapshots = sorted(
        (p for p in ckpt_dir.iterdir() if snapshot_step(p.name) is not None),
        key=lambda p: snapshot_step(p.name),
    )
    protected: set[Path] = set()
    latest = ckpt_dir / "latest.ckpt"
    if latest.is_symlink():
        try:
            protected.add(latest.resolve())
        except OSError:
            pass

    removed: list[Path] = []
    for path in snapshots[:-keep] if len(snapshots) > keep else []:
        try:
            if path.resolve() in protected:
                continue
        except OSError:
            continue
        _remove(path)
        side = sidecar_path(path)
        if side.exists():
            _remove(side)
        removed.append(path)
        if log_fn is not None:
            log_fn(f"checkpoint GC: removed {path.name}")

    # Crash debris: tmp/displaced-orphan entries older than the newest valid
    # snapshot can belong to no in-flight write.
    survivors = [p for p in snapshots if p not in removed and p.exists()]
    if survivors:
        newest_mtime = max(p.stat().st_mtime for p in survivors)
        for entry in list(ckpt_dir.iterdir()):
            if not _DEBRIS_RE.search(entry.name):
                continue
            # Displaced-orphan dirs are only reclaimed when they carry the
            # ownership marker the checkpoint writer drops (a user's manual
            # backup named like one is left alone).
            if ".ckpt.old" in entry.name and not (
                entry / _DISPLACED_MARKER
            ).exists():
                continue
            try:
                if entry.stat().st_mtime >= newest_mtime:
                    continue
            except OSError:
                continue
            _remove(entry)
            removed.append(entry)
            if log_fn is not None:
                log_fn(f"checkpoint GC: reclaimed stranded {entry.name}")
    return removed
