"""Supervised restarts: a torch-free parent that keeps a training run alive
(the port's copy of ``bpe_transformer_tpu/resilience/supervisor.py``).

``train --supervise`` runs THIS process as a thin parent: it never imports
torch (so it never touches the card — the child owns it) and loops::

    resume = newest snapshot that passes integrity verification
    spawn `train ... --resume <resume>` as a child process
    child exits 0                -> done
    child exits EXIT_PREEMPTED   -> respawn (the child already checkpointed)
    child crashes (anything else)-> respawn with exponential backoff

The crash-loop breaker mirrors the rollback budget's philosophy: restarts
are only free while the run makes progress.  Each respawn re-reads the
checkpoint directory; when the newest valid snapshot's step advanced since
the last spawn the failure counter resets, otherwise it counts toward
``max_restarts`` — a child that dies before ever checkpointing gets exactly
``max_restarts`` chances, then the supervisor gives up and propagates the
child's exit code.  The fleet controller reads :func:`_describe_exit` for
the replicas it respawns.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import time
from pathlib import Path

from bpe_transformer_tpu_torch.resilience.integrity import (
    latest_valid_checkpoint,
    snapshot_step,
)
from bpe_transformer_tpu_torch.resilience.signals import EXIT_PREEMPTED

__all__ = ["EXIT_PREEMPTED", "supervise"]

#: train flags that belong to the supervisor itself and must not reach the
#: child (it would recurse / reject them).
_PARENT_FLAGS = {"--supervise"}
_PARENT_FLAGS_WITH_VALUE = {"--max-restarts", "--restart-backoff"}


def strip_supervisor_flags(argv: list[str]) -> list[str]:
    """Remove the supervisor-only flags from a raw train argv."""
    out: list[str] = []
    skip = False
    for token in argv:
        if skip:
            skip = False
            continue
        if token in _PARENT_FLAGS:
            continue
        if token in _PARENT_FLAGS_WITH_VALUE:
            skip = True
            continue
        if any(token.startswith(f + "=") for f in _PARENT_FLAGS_WITH_VALUE):
            continue
        out.append(token)
    return out


def _with_resume(argv: list[str], resume: Path | None) -> list[str]:
    """Child argv with ``--resume`` forced to the supervisor's choice (the
    newest VALID snapshot in the checkpoint dir) — a stale user-given
    --resume is replaced, because the supervisor's snapshot is by
    definition newer.  With no supervisor snapshot yet (``resume`` None —
    a fresh run) the argv is left UNTOUCHED: a user-supplied --resume
    there is a warm-start from elsewhere and must survive the first
    spawn."""
    if resume is None:
        return list(argv)
    out: list[str] = []
    skip = False
    for token in argv:
        if skip:
            skip = False
            continue
        if token == "--resume":
            skip = True
            continue
        if token.startswith("--resume="):
            continue
        out.append(token)
    return out + ["--resume", str(resume)]


def _describe_exit(rc: int) -> str:
    if rc == EXIT_PREEMPTED:
        return f"preempted (exit {rc})"
    if rc < 0:
        try:
            return f"killed by {signal.Signals(-rc).name}"
        except ValueError:
            return f"killed by signal {-rc}"
    return f"crashed (exit {rc})"


def _progress_of(path: Path | None) -> int:
    """Step encoded by an already-verified snapshot path (-1 when None) —
    read from the FILENAME, never by loading the state (the parent stays
    cheap and torch-free).  Takes the path rather than scanning so each
    supervise() iteration pays for exactly ONE latest_valid_checkpoint
    sweep (a sweep CRC32s every byte of the newest snapshot — minutes on
    a multi-GB NFS checkpoint, not something to repeat per respawn)."""
    if path is None:
        return -1
    step = snapshot_step(path.name)
    if step is not None:
        return step
    # latest.ckpt: resolve a symlink to its step target; a dense byte copy
    # mirrors the newest step file.
    try:
        step = snapshot_step(path.resolve().name)
    except OSError:
        step = None
    if step is not None:
        return step
    from bpe_transformer_tpu_torch.resilience.integrity import candidate_snapshots

    steps = [snapshot_step(p.name) for p in candidate_snapshots(path.parent)]
    return max((s for s in steps if s is not None), default=0)


def supervise(
    train_argv: list[str],
    checkpoint_dir: str | Path,
    *,
    max_restarts: int = 5,
    backoff_s: float = 1.0,
    backoff_max_s: float = 60.0,
    child_cmd: list[str] | None = None,
    log=print,
    sleep=time.sleep,
) -> int:
    """Run the train command under supervision; returns the final exit code
    (0 on success, the child's last code when the restart budget is spent).

    ``train_argv`` is the full CLI argv INCLUDING the ``train`` subcommand
    (supervisor-only flags already stripped); ``child_cmd`` overrides the
    interpreter invocation (tests substitute a stub child).
    """
    train_argv = strip_supervisor_flags(list(train_argv))
    cmd_prefix = child_cmd or [
        sys.executable, "-m", "bpe_transformer_tpu_torch.training.cli",
    ]
    # Signal forwarding: under docker/k8s/batch schedulers the preemption
    # SIGTERM lands on THIS process (often PID 1), not the child.  Forward
    # it so the child runs its graceful-shutdown path (emergency
    # checkpoint + footer), then exit with the child's code instead of
    # respawning — a signalled supervisor is being told to stop, not to
    # restart.  Handler installation fails off the main thread; the
    # supervisor then simply doesn't forward (tests drive it that way).
    child: list[subprocess.Popen | None] = [None]
    stop_signal: list[int | None] = [None]

    def _forward(signum, frame):
        stop_signal[0] = signum
        proc = child[0]
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signum)
            except OSError:
                pass

    prev_handlers: dict[int, object] = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _forward)
    except ValueError:
        prev_handlers.clear()

    failures = 0
    spawns = 0
    try:
        # ONE integrity sweep per spawn: the scan after each child exit
        # feeds BOTH the progress accounting and the next spawn's
        # --resume.  The sweep itself runs in fast mode (structure +
        # sizes, no CRC pass): the child re-verifies its --resume target
        # with full checksums at load time anyway, so deep-scanning a
        # multi-GB snapshot here would only triple the restart I/O.
        resume = latest_valid_checkpoint(checkpoint_dir, deep=False)
        last_progress = _progress_of(resume)
        while True:
            argv = _with_resume(train_argv, resume)
            spawns += 1
            log(
                f"supervisor: spawn #{spawns}"
                + (f" (resume {resume})" if resume is not None else " (fresh)")
            )
            proc = subprocess.Popen(cmd_prefix + argv)
            child[0] = proc
            try:
                rc = proc.wait()
            finally:
                child[0] = None
            if stop_signal[0] is not None:
                name = signal.Signals(stop_signal[0]).name
                log(
                    f"supervisor: stopping on {name}; child exited "
                    f"({_describe_exit(rc) if rc else 'clean'})"
                )
                return rc
            if rc == 0:
                log(
                    f"supervisor: child finished cleanly after {spawns} "
                    "spawn(s)"
                )
                return 0
            resume = latest_valid_checkpoint(checkpoint_dir, deep=False)
            progress = _progress_of(resume)
            if progress > last_progress:
                failures = 0
                last_progress = progress
            failures += 1
            if failures > max_restarts:
                log(
                    f"supervisor: giving up — {_describe_exit(rc)} and "
                    f"{failures} consecutive failures without checkpoint "
                    f"progress (max_restarts={max_restarts})"
                )
                return rc if rc > 0 else 1
            # Preemption already checkpointed at the stop boundary:
            # respawn fast.  Crashes back off exponentially — the failure
            # may be environmental (filesystem, driver) and hammering
            # makes it worse.
            delay = (
                0.0
                if rc == EXIT_PREEMPTED
                else min(backoff_s * (2 ** (failures - 1)), backoff_max_s)
            )
            log(
                f"supervisor: child {_describe_exit(rc)}; restarting"
                + (f" in {delay:.1f}s" if delay else "")
                + f" ({failures}/{max_restarts} failures without progress)"
            )
            if delay:
                sleep(delay)
            if stop_signal[0] is not None:
                log("supervisor: stop signal during backoff; exiting")
                return EXIT_PREEMPTED
    finally:
        for sig, prev in prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
