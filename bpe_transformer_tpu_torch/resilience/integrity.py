"""CRC32 checksums, verification, quarantine and valid-snapshot discovery
for checkpoints (the port's own copy of
``bpe_transformer_tpu/resilience/integrity.py``).

A dense ``.ckpt`` gets an atomic JSON sidecar ``<name>.ckpt.crc32.json``
(crc32 + byte size) written after the checkpoint is renamed into place, in
the JAX package's format, so either package's checksum scan reads it.
:func:`verify_checkpoint` checks a file against its sidecar without
unpickling it; :func:`quarantine` renames a snapshot that failed to
``<name>.corrupt`` (never deleting it); :func:`candidate_snapshots` and
:func:`latest_valid_checkpoint` find the loop's ``step_*.ckpt`` snapshots.
``checkpointing.checkpoint.load_checkpoint_with_fallback`` builds the
resume path on these, and :func:`main` is the torch-free
``verify-checkpoint`` command.  A sharded checkpoint directory (format v2)
is verified against its manifest: every file the leaves name is present,
its size and CRC32 match the manifest's ``checksums``, and each sharded
leaf's index boxes cover its shape.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import tempfile
import zlib
from pathlib import Path

#: Dense-checkpoint sidecar suffix: ``model.ckpt`` -> ``model.ckpt.crc32.json``.
SIDECAR_SUFFIX = ".crc32.json"
#: Quarantine suffix for snapshots that failed verification or loading.
CORRUPT_SUFFIX = ".corrupt"
#: Snapshot naming convention of the training loop (``step_%08d.ckpt``).
SNAPSHOT_RE = re.compile(r"^step_(\d+)\.ckpt$")

_CHUNK = 1 << 20


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


def crc32_file(path: str | os.PathLike) -> tuple[int, int]:
    """``(crc32, size)`` of a file, streamed in 1 MiB chunks."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc, size


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


def read_sidecar(ckpt_path: str | os.PathLike) -> dict | None:
    """The sidecar payload, or None when absent or unreadable (a checkpoint
    written before checksums existed: absence is not corruption)."""
    try:
        with open(sidecar_path(ckpt_path)) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return payload if isinstance(payload, dict) else None


@dataclasses.dataclass
class VerifyResult:
    """Outcome of :func:`verify_checkpoint`: ``ok`` means no positive
    evidence of corruption (a file without a sidecar passes with a warning;
    only mismatches fail)."""

    path: str
    format: str  # "dense" | "missing"
    ok: bool
    problems: list[str] = dataclasses.field(default_factory=list)
    warnings: list[str] = dataclasses.field(default_factory=list)
    files_checked: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _verify_dense(path: Path, deep: bool) -> VerifyResult:
    result = VerifyResult(path=str(path), format="dense", ok=True)
    try:
        size = path.stat().st_size
    except OSError as exc:
        result.ok = False
        result.problems.append(f"unreadable: {exc}")
        return result
    if size == 0:
        result.ok = False
        result.problems.append("empty file (truncated write?)")
        return result
    result.files_checked = 1
    sidecar = read_sidecar(path)
    if sidecar is None:
        result.warnings.append(
            "no checksum sidecar (pre-integrity checkpoint); only the pickle header checked"
        )
        with open(path, "rb") as f:
            if f.read(1) != b"\x80":
                result.ok = False
                result.problems.append("not a pickle stream (bad magic byte)")
        return result
    if size != sidecar.get("size"):
        result.ok = False
        result.problems.append(f"size {size} != sidecar {sidecar.get('size')} (truncated?)")
        return result
    if deep:
        crc, _ = crc32_file(path)
        if crc != sidecar.get("crc32"):
            result.ok = False
            result.problems.append(
                f"crc32 mismatch (sidecar {sidecar.get('crc32')}, file {crc})"
            )
    return result


_MANIFEST = "manifest.json"
_ACCEPTED_SHARDED_VERSIONS = (2,)


def _npy_shape(path: Path) -> tuple:
    """Shape of an ``.npy`` file from its header only (no data read)."""
    import numpy as np

    return tuple(np.load(path, mmap_mode="r").shape)


def _verify_sharded(path: Path, deep: bool = True) -> VerifyResult:
    """The JAX package's verdict on a sharded directory: the manifest
    parses, every leaf's shard boxes lie in bounds and cover its shape,
    every named file exists and matches its manifest checksum (size, and
    CRC32 with ``deep``); without checksums, each npy header parses and a
    whole leaf's shape matches."""
    result = VerifyResult(path=str(path), format="sharded", ok=True)
    try:
        with open(path / _MANIFEST) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        result.ok = False
        result.problems.append(f"unreadable manifest: {exc}")
        return result
    if manifest.get("format_version") not in _ACCEPTED_SHARDED_VERSIONS:
        result.ok = False
        result.problems.append(f"unsupported format_version {manifest.get('format_version')!r}")
        return result
    if not isinstance(manifest.get("leaves"), list):
        result.ok = False
        result.problems.append("manifest has no leaves list")
        return result
    checksums = manifest.get("checksums")
    if not isinstance(checksums, dict):
        checksums = None
        result.warnings.append(
            "manifest carries no checksums (pre-integrity checkpoint); only file presence and "
            "shapes checked"
        )
    expected_files = ["treedef.pkl"]
    for record in manifest["leaves"]:
        name = record.get("name", "?")
        shape = tuple(record.get("shape", ()))
        if "shards" in record:
            total = 1
            for dim in shape:
                total *= dim
            covered = 0
            for j, shard in enumerate(record["shards"]):
                expected_files.append(f"{name}.{j:03d}.npy")
                vol = 1
                for (start, stop), dim in zip(shard["index"], shape):
                    if not (0 <= start <= stop <= dim):
                        result.ok = False
                        result.problems.append(
                            f"leaf {name}: shard index {shard['index']} out of bounds for shape "
                            f"{list(shape)}"
                        )
                    vol *= max(stop - start, 0)
                covered += vol
            if covered != total:
                result.ok = False
                result.problems.append(
                    f"leaf {name}: shard files cover {covered}/{total} elements of shape "
                    f"{list(shape)}"
                )
        else:
            expected_files.append(f"{name}.npy")
    for fname in expected_files:
        fpath = path / fname
        if not fpath.exists():
            result.ok = False
            result.problems.append(f"missing file {fname}")
            continue
        result.files_checked += 1
        if checksums is not None:
            entry = checksums.get(fname)
            if entry is None:
                result.warnings.append(f"{fname} has no manifest checksum")
                continue
            crc, size = crc32_file(fpath) if deep else (None, fpath.stat().st_size)
            if size != entry.get("size"):
                result.ok = False
                result.problems.append(
                    f"{fname}: size {size} != manifest {entry.get('size')} (truncated?)")
            elif deep and crc != entry.get("crc32"):
                result.ok = False
                result.problems.append(
                    f"{fname}: crc32 mismatch (manifest {entry.get('crc32')}, file {crc})")
        elif fname.endswith(".npy"):
            record = next((r for r in manifest["leaves"] if fname.startswith(r.get("name", "\0"))),
                          None)
            try:
                shape = _npy_shape(fpath)
            except Exception as exc:  # noqa: BLE001 - any parse failure is evidence
                result.ok = False
                result.problems.append(f"{fname}: unreadable npy ({exc})")
                continue
            if record is not None and "shards" not in record and tuple(
                    record.get("shape", ())) != shape:
                result.ok = False
                result.problems.append(
                    f"{fname}: shape {list(shape)} != manifest {record.get('shape')}")
    return result


def verify_checkpoint(path: str | os.PathLike, deep: bool = True) -> VerifyResult:
    """Integrity verdict for one checkpoint, a dense file (byte size and,
    with ``deep``, CRC32 against its sidecar) or a sharded directory
    (:func:`_verify_sharded`), without unpickling or loading an array."""
    path = Path(path)
    if path.is_dir():
        return _verify_sharded(path, deep)
    if path.exists() or path.is_symlink():
        return _verify_dense(path, deep)
    return VerifyResult(path=str(path), format="missing", ok=False,
                        problems=["no such checkpoint"])


def snapshot_step(path: str | os.PathLike) -> int | None:
    """The step number encoded in a loop snapshot name, or None."""
    match = SNAPSHOT_RE.match(Path(path).name)
    return int(match.group(1)) if match else None


def candidate_snapshots(directory: str | os.PathLike, exclude: set | None = None) -> list[Path]:
    """Loop snapshots (``step_*.ckpt``) under ``directory``, newest step
    first, skipping quarantined entries and the resolved paths in
    ``exclude``."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    exclude = exclude or set()
    out = []
    for entry in os.listdir(directory):
        if snapshot_step(entry) is None:
            continue
        path = directory / entry
        try:
            if path.resolve() in exclude:
                continue
        except OSError:
            continue
        out.append(path)
    return sorted(out, key=snapshot_step, reverse=True)


def latest_valid_checkpoint(directory: str | os.PathLike, deep: bool = True) -> Path | None:
    """The newest snapshot under ``directory`` that passes
    :func:`verify_checkpoint`: ``latest.ckpt`` when it verifies, else the
    step snapshots, newest first."""
    directory = Path(directory)
    latest = directory / "latest.ckpt"
    if (latest.exists() or latest.is_symlink()) and verify_checkpoint(latest, deep).ok:
        return latest
    for path in candidate_snapshots(directory):
        if verify_checkpoint(path, deep).ok:
            return path
    return None


def quarantine(path: str | os.PathLike) -> Path:
    """Rename a corrupt snapshot (and its sidecar) to ``<name>.corrupt``
    (``.corrupt.1``, ... when taken): kept as evidence, never deleted, and
    invisible to :func:`candidate_snapshots`.  Returns the new path."""
    path = Path(path)
    target = path.with_name(path.name + CORRUPT_SUFFIX)
    n = 1
    while target.exists():
        target = path.with_name(f"{path.name}{CORRUPT_SUFFIX}.{n}")
        n += 1
    os.rename(path, target)
    side = sidecar_path(path)
    if side.exists():
        os.rename(side, target.with_name(target.name + SIDECAR_SUFFIX))
    return target


def main(argv: list[str] | None = None) -> int:
    """``verify-checkpoint PATH [--json]``: the JAX package's command and
    exit codes (0 valid, 1 corrupt), without unpickling or importing
    torch."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="verify-checkpoint",
        description="Verify a checkpoint's integrity (checksums + manifest shape check; "
        "torch-free, loads no arrays).",
    )
    parser.add_argument("path", help="dense .ckpt file or sharded directory")
    parser.add_argument("--json", action="store_true", help="machine-readable verdict")
    args = parser.parse_args(argv)

    result = verify_checkpoint(args.path)
    if args.json:
        print(json.dumps(result.to_dict(), indent=2))
    else:
        verdict = "OK" if result.ok else "CORRUPT"
        print(f"{result.path}: {verdict} ({result.format}, {result.files_checked} file(s) checked)")
        for problem in result.problems:
            print(f"  problem: {problem}")
        for warning in result.warnings:
            print(f"  warning: {warning}")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
