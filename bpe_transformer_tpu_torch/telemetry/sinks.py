"""Record sinks: fan structured telemetry records out to stdout / JSONL / wandb.

The port's copy of ``bpe_transformer_tpu/telemetry/sinks.py``.

``MetricsLogger`` is the one write path every telemetry producer shares —
step metrics, span records, run manifests, watchdog events, and footers all
flow through ``log()`` as plain dicts, one JSON line each.  It moved here
from ``utils/metrics.py`` (kept as a re-export shim) when telemetry became
its own subsystem.

Long-lived serving processes add size-based retention: with ``max_bytes``
set, the live JSONL rotates to numbered segments (``metrics.jsonl.1``,
``.2``, ...) at record boundaries — a record is never split across segments —
and the run's manifest record is re-stamped as the first line of each new
segment so ``report``'s latest-manifest resolution works on any segment in
isolation.  Segments beyond ``keep_segments`` are garbage-collected
oldest-first (the same bounded-retention contract as checkpoint GC in
``resilience/retention.py``).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import IO

_SEGMENT_RE = re.compile(r"\.(\d+)$")


def _segment_index(path: Path, live_name: str) -> int | None:
    """``metrics.jsonl.7`` -> 7 for segments of ``live_name``, else None."""
    if not path.name.startswith(live_name + "."):
        return None
    match = _SEGMENT_RE.search(path.name)
    return int(match.group(1)) if match else None


class MetricsLogger:
    """Fan a stream of record dicts out to stdout / JSONL / wandb.

    >>> logger = MetricsLogger(jsonl_path="run/metrics.jsonl")
    >>> logger.log({"step": 1, "loss": 3.2})
    >>> logger.close()

    Every sink is optional; with none configured ``log`` is a no-op, so the
    training loop can call it unconditionally.  ``log`` after ``close`` is
    also a silent no-op (the handle is gone; a crash-path flush must not
    raise a second error over the first).

    ``max_bytes`` enables size-based JSONL rotation (see module docstring);
    ``keep_segments`` bounds how many rotated segments survive GC.
    """

    def __init__(
        self,
        stdout: bool = False,
        jsonl_path: str | Path | None = None,
        wandb_project: str | None = None,
        wandb_config: dict | None = None,
        log_fn=print,
        max_bytes: int | None = None,
        keep_segments: int = 4,
    ):
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if keep_segments < 1:
            raise ValueError(f"keep_segments must be >= 1, got {keep_segments}")
        self._log_fn = log_fn if stdout else None
        self._max_bytes = max_bytes
        self._keep_segments = keep_segments
        self._manifest_line: str | None = None
        # Validate / init the wandb sink before opening the JSONL file so a
        # missing wandb package doesn't leak an open handle or stray file.
        self._wandb = None
        if wandb_project is not None:
            try:
                import wandb
            except ImportError as e:
                raise ImportError(
                    "wandb_project was set but the wandb package is not "
                    "installed; install it or drop the flag"
                ) from e
            self._wandb = wandb.init(project=wandb_project, config=wandb_config)
        self._jsonl: IO[str] | None = None
        self._path: Path | None = None
        self._bytes = 0
        if jsonl_path is not None:
            self._path = Path(jsonl_path)
            self._path.parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self._path, "a")
            try:
                self._bytes = self._path.stat().st_size
            except OSError:
                self._bytes = 0

    def log(self, record: dict) -> None:
        if self._log_fn is not None:
            parts = [
                f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in record.items()
            ]
            self._log_fn("  ".join(parts))
        if self._jsonl is not None:
            line = json.dumps(record) + "\n"
            if record.get("kind") == "manifest":
                # Remember the run header so rotation can re-stamp it at the
                # head of every new segment.
                self._manifest_line = line
            if (
                self._max_bytes is not None
                and self._bytes > 0
                and self._bytes + len(line.encode("utf-8")) > self._max_bytes
            ):
                self._rotate()
                if (
                    self._manifest_line is not None
                    and record.get("kind") != "manifest"
                ):
                    self._jsonl.write(self._manifest_line)
                    self._bytes += len(self._manifest_line.encode("utf-8"))
            self._jsonl.write(line)
            self._jsonl.flush()
            self._bytes += len(line.encode("utf-8"))
        if self._wandb is not None and "kind" not in record:
            # Only flat step/val metrics reach wandb.  Structured records
            # (manifest, spans, events, footer — everything carrying a
            # ``kind``) hold nested dicts wandb can't chart, and logging
            # them with step=None would advance wandb's auto-step past the
            # explicit step values, silently dropping early step records.
            self._wandb.log(record, step=record.get("step"))

    def _rotate(self) -> None:
        """Close the live file, shelve it as the next numbered segment, open
        a fresh live file, and GC segments beyond ``keep_segments``.  Called
        only at a record boundary — a record is never split."""
        assert self._jsonl is not None and self._path is not None
        self._jsonl.close()
        existing = [
            idx
            for p in self._path.parent.iterdir()
            if (idx := _segment_index(p, self._path.name)) is not None
        ]
        next_idx = max(existing, default=0) + 1
        try:
            self._path.rename(
                self._path.with_name(f"{self._path.name}.{next_idx}")
            )
        except OSError:
            pass  # rotation is best-effort; keep appending to the live file
        self._jsonl = open(self._path, "a")
        try:
            self._bytes = self._path.stat().st_size
        except OSError:
            self._bytes = 0
        self._gc_segments()

    def _gc_segments(self) -> list[Path]:
        """Delete rotated segments beyond the newest ``keep_segments``
        (stranded segments from earlier runs included); returns the paths
        removed."""
        assert self._path is not None
        segments = sorted(
            (
                (idx, p)
                for p in self._path.parent.iterdir()
                if (idx := _segment_index(p, self._path.name)) is not None
            ),
        )
        removed: list[Path] = []
        for _, path in segments[: -self._keep_segments] if len(
            segments
        ) > self._keep_segments else []:
            try:
                path.unlink()
                removed.append(path)
            except OSError:
                pass
        return removed

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
