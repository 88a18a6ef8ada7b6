"""Deterministic fault injection: the chaos half of the resilience layer
(the port's copy of ``bpe_transformer_tpu/resilience/faults.py``; it imports
no torch, and :meth:`FaultInjector.poison_params` works on a tree of
tensors).

Recovery code that is never exercised is broken code waiting for a pod
preemption to prove it.  This module injects the real failure modes at
exact, reproducible points so tests can drive every recovery path
end-to-end:

* **NaN state at step K** — poisons one parameter leaf after the step
  crosses K, so the next log boundary detects a genuinely non-finite model
  (exactly what a bad batch/overflow produces) and the rollback path must
  actually restore from disk to recover;
* **kill at step K** — ``SIGKILL`` to self: the hard-preemption case no
  handler can soften (supervisor respawn territory);
* **preempt at step K** — ``SIGTERM`` to self: the graceful path
  (``resilience.signals``);
* **dataset read failure at step K** — an ``OSError`` out of the batch
  sampler (flaky network filesystem), the supervisor's crash-restart case;
* **checkpoint corruption** — :func:`corrupt_file` truncates or bit-flips
  a named file (dense ``.ckpt``, a shard ``.npy``, a manifest) so the
  integrity/fallback path sees real damage.

Serving-addressable faults extend the same plan to the fleet
chaos harness — per-replica via each replica process's own ``BT_FAULTS``:

* **kill at decode tick K** — ``SIGKILL`` mid-decode from the serving
  worker loop: the dying-replica case the controller + supervisor must
  absorb with zero failed requests;
* **HTTP delay / blackhole** — matching request paths (substring, e.g.
  ``/kv/import``) sleep for ``http_delay_s`` or drop the connection
  without a response: the slow/partitioned-peer case the migration
  retry + idempotency machinery must survive;
* **payload corruption** — the exported migration payload is truncated
  or bit-flipped in flight (``corrupt_payload``): the importer's CRC
  must 400 it, never graft it.

Faults fire ONCE.  In-process that is an instance flag; across supervisor
respawns (same env, fresh process) set ``once_dir`` and the firing leaves a
marker file the next process honors — so "kill at step 6" means the FIRST
pass through step 6, and the respawned child survives it, which is exactly
the scenario under test.

The training loop asks for a plan via :func:`from_env` (``BT_FAULTS`` JSON)
— production runs without the env var get a no-op injector and zero
overhead.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to break, and when (steps are loop iteration numbers)."""

    nan_at_step: int | None = None
    kill_at_step: int | None = None
    preempt_at_step: int | None = None
    fail_read_at_step: int | None = None
    # ---- serving faults (fleet chaos) ----
    #: SIGKILL self on the Nth serving decode tick (mid-decode death).
    kill_at_decode_tick: int | None = None
    #: Sleep this long before handling an HTTP request whose path contains
    #: ``http_fault_path`` (slow peer / WAN latency).
    http_delay_s: float | None = None
    #: Drop the connection (no response) for a request whose path contains
    #: ``http_fault_path`` — fires once, so a retry gets through.
    http_blackhole: bool = False
    #: Substring matched against the request path for the two HTTP faults.
    http_fault_path: str = "/kv/import"
    #: Damage exported migration payload bytes in flight:
    #: ``"truncate"`` or ``"flip"`` (fires once).
    corrupt_payload: str | None = None
    #: Directory for cross-process fire-once markers (supervisor respawns).
    once_dir: str | None = None

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        payload = json.loads(text)
        if not isinstance(payload, dict):
            raise ValueError("fault plan must be a JSON object")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(payload) - known)
        if unknown:
            raise ValueError(f"unknown fault plan fields: {', '.join(unknown)}")
        return cls(**payload)


class FaultInjector:
    """Runtime for one :class:`FaultPlan` (or a no-op when ``plan`` is
    None).  The loop calls the hooks unconditionally; every hook is a cheap
    comparison when nothing is planned."""

    def __init__(self, plan: FaultPlan | None):
        self.plan = plan
        self._fired: set[str] = set()

    @classmethod
    def from_env(cls, var: str = "BT_FAULTS") -> "FaultInjector":
        text = os.environ.get(var)
        return cls(FaultPlan.from_json(text) if text else None)

    @property
    def active(self) -> bool:
        return self.plan is not None

    # ------------------------------------------------------------- fire-once

    def _should_fire(self, fault: str, at_step: int | None, step: int) -> bool:
        if at_step is None or step < at_step or fault in self._fired:
            return False
        if self.plan.once_dir:
            marker = Path(self.plan.once_dir) / f"{fault}.fired"
            if marker.exists():
                self._fired.add(fault)
                return False
            marker.parent.mkdir(parents=True, exist_ok=True)
            marker.touch()
        self._fired.add(fault)
        return True

    def _fire_once(self, fault: str) -> bool:
        """Fire-once for faults with no step axis (HTTP, payload)."""
        return self._should_fire(fault, 0, 0)

    # ----------------------------------------------------------------- hooks

    def at_step(self, step: int) -> None:
        """Called at the top of every loop iteration: process-level faults
        (the marker is written BEFORE the kill — a SIGKILL leaves no other
        trace)."""
        if self.plan is None:
            return
        if self._should_fire("preempt", self.plan.preempt_at_step, step):
            os.kill(os.getpid(), signal.SIGTERM)
        if self._should_fire("kill", self.plan.kill_at_step, step):
            os.kill(os.getpid(), signal.SIGKILL)

    def at_decode_tick(self, tick: int) -> None:
        """Called by the serving worker loop once per decode tick:
        SIGKILL-mid-decode (the marker is written before the kill, so the
        supervisor's respawn survives the same tick)."""
        if self.plan is None:
            return
        if self._should_fire(
            "kill_decode", self.plan.kill_at_decode_tick, tick
        ):
            os.kill(os.getpid(), signal.SIGKILL)

    def on_http_request(self, path: str) -> str | None:
        """Called by HTTP handlers before dispatch.  Returns ``"blackhole"``
        when the handler must drop the connection without responding;
        otherwise sleeps any planned delay inline and returns ``None``.
        Both fire once (marker-backed), so a retried request gets through —
        which is exactly what the migration retry path is tested on."""
        if self.plan is None or self.plan.http_fault_path not in path:
            return None
        if self.plan.http_blackhole and self._fire_once("http_blackhole"):
            return "blackhole"
        if self.plan.http_delay_s and self._fire_once("http_delay"):
            time.sleep(self.plan.http_delay_s)
        return None

    def on_export_payload(self, data: bytes) -> bytes:
        """Called on exported migration payload bytes before they leave the
        process: truncate or bit-flip in flight (fires once).  The flip
        lands in the trailing quarter — the array section — so it is the
        case only the v2 CRC catches."""
        if self.plan is None or not self.plan.corrupt_payload:
            return data
        if not self._fire_once("corrupt_payload"):
            return data
        mode = self.plan.corrupt_payload
        if mode == "truncate":
            return data[: max(len(data) // 2, 16)]
        if mode == "flip":
            if not data:
                return data
            buf = bytearray(data)
            pos = (len(buf) * 3) // 4
            buf[pos] ^= 0xFF
            return bytes(buf)
        raise ValueError(f"unknown corrupt_payload mode {mode!r}")

    def on_batch_read(self, step: int) -> None:
        """Called before each batch sample; raises the planned read error."""
        if self.plan is None:
            return
        if self._should_fire("fail_read", self.plan.fail_read_at_step, step):
            raise OSError(
                f"injected dataset read failure at step {step} "
                "(resilience.faults)"
            )

    def poison_params(self, params, step: int):
        """Called after each optimizer update: returns ``params`` with the
        first leaf overwritten by NaN once ``step`` crosses the plan — a
        faithful stand-in for a bad-batch overflow that the rollback path
        must recover from by reloading the last checkpoint."""
        if self.plan is None or not self._should_fire(
            "nan", self.plan.nan_at_step, step
        ):
            return params
        # Imported here: the injector itself must stay importable on
        # torch-free hosts (the supervisor reads the same plan).
        from bpe_transformer_tpu_torch.tree import tree_leaves, tree_unflatten

        leaves = tree_leaves(params)
        poisoned = leaves[0].clone()
        poisoned.fill_(float("nan"))
        return tree_unflatten(params, [poisoned] + leaves[1:])


# ------------------------------------------------------------- file corruption


def corrupt_file(
    path: str | os.PathLike,
    mode: str = "truncate",
    nbytes: int = 64,
) -> None:
    """Damage a file in place the way real failures do.

    ``mode="truncate"`` drops the trailing ``nbytes`` (torn write / full
    disk); ``mode="flip"`` XORs a byte mid-file (bit rot / bad DMA) without
    changing the size — the case only a checksum catches.
    """
    path = Path(path)
    size = path.stat().st_size
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size - nbytes, 0))
    elif mode == "flip":
        if size == 0:
            raise ValueError(f"cannot bit-flip empty file {path}")
        offset = size // 2
        with open(path, "r+b") as f:
            f.seek(offset)
            byte = f.read(1)
            f.seek(offset)
            f.write(bytes([byte[0] ^ 0xFF]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
