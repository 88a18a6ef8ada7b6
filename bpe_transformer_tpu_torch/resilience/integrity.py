"""CRC32 checksums for dense checkpoints (the port's own copy of
``Crc32Writer``, ``sidecar_path``, ``write_sidecar`` and
``atomic_write_json`` from ``bpe_transformer_tpu/resilience/integrity.py``).

A dense ``.ckpt`` gets an atomic JSON sidecar ``<name>.ckpt.crc32.json``
(crc32 + byte size) written after the checkpoint is renamed into place, in
the JAX package's format, so either package's checksum scan reads it.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib
from pathlib import Path

#: Dense-checkpoint sidecar suffix: ``model.ckpt`` -> ``model.ckpt.crc32.json``.
SIDECAR_SUFFIX = ".crc32.json"


class Crc32Writer:
    """File-object wrapper that CRC32s (and counts) everything written, so a
    saver computes the checksum in the same pass as the write."""

    def __init__(self, fileobj):
        self._f = fileobj
        self.crc = 0
        self.size = 0

    def write(self, data) -> int:
        data = bytes(data)
        self.crc = zlib.crc32(data, self.crc)
        self.size += len(data)
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()


def sidecar_path(ckpt_path: str | os.PathLike) -> Path:
    p = Path(ckpt_path)
    return p.with_name(p.name + SIDECAR_SUFFIX)


def atomic_write_json(path: str | os.PathLike, obj) -> None:
    """JSON to ``path`` via a temp file and ``os.replace``: a kill mid-write
    never leaves a truncated file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2)
        os.replace(tmp_name, path)
    except BaseException:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)
        raise


def write_sidecar(ckpt_path: str | os.PathLike, crc: int, size: int) -> None:
    """Atomically write the dense checkpoint's checksum sidecar."""
    atomic_write_json(sidecar_path(ckpt_path), {"crc32": int(crc), "size": int(size)})
