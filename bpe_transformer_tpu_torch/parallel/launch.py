"""Start a world of rank processes on this host, as ``torchrun
--nproc-per-node N`` does, for a script that joins it with
:func:`parallel.mesh.initialize_distributed`.

Each rank is ``python <argv...>`` with torchrun's environment (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port).  The first rank that fails stops the
others, so a failure never leaves the rest waiting in a collective: every
process this function starts has ended when it returns or raises.

As a command, ``python -m bpe_transformer_tpu_torch.parallel.launch
--nproc-per-node N -- <python argv...>`` runs one world until it ends,
forwarding SIGTERM and SIGINT to every rank, prints rank 0's standard
output and exits with the first failing rank's code (0 when every rank
succeeded): ``train --supervise --parallel`` respawns such a world whole.
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class LaunchError(RuntimeError):
    """A rank exited non-zero (``returncode``), or the world outlived its
    time limit (``returncode`` None)."""

    def __init__(self, message: str, returncode: int | None = None):
        super().__init__(message)
        self.returncode = returncode


def launch(argv: list, nprocs: int, *, env: dict | None = None, timeout: float = 600.0,
           cwd: str | os.PathLike | None = None, forward_signals: bool = False) -> list[str]:
    """Run ``python <argv>`` as ``nprocs`` ranks of one world and wait for
    them; returns each rank's standard output.  Raises :class:`LaunchError`
    with the failing rank's standard error when a rank exits non-zero or
    the world runs past ``timeout`` seconds; the other ranks are stopped
    (SIGTERM, then SIGKILL after 10 s).  ``forward_signals`` (on the main
    thread) passes a SIGTERM or SIGINT of this process on to every rank
    still running and keeps waiting for them."""
    port = free_port()
    base = {**os.environ, **(env or {})}
    procs, outs, errs = [], [], []
    previous = {}
    if forward_signals:

        def forward(signum, frame):
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signum)

        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, forward)
    with tempfile.TemporaryDirectory(prefix="bt_launch_") as tmp:
        try:
            for rank in range(nprocs):
                out = open(Path(tmp) / f"rank{rank}.out", "w+")  # noqa: SIM115
                err = open(Path(tmp) / f"rank{rank}.err", "w+")  # noqa: SIM115
                outs.append(out)
                errs.append(err)
                rank_env = {**base, "RANK": str(rank), "LOCAL_RANK": str(rank),
                            "WORLD_SIZE": str(nprocs), "LOCAL_WORLD_SIZE": str(nprocs),
                            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
                procs.append(subprocess.Popen([sys.executable, *map(str, argv)], env=rank_env,
                                              cwd=cwd, stdout=out, stderr=err))
            deadline = time.monotonic() + timeout
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if failed is None and time.monotonic() > deadline:
                    _stop(procs)
                    raise LaunchError(
                        f"world of {nprocs} ranks ran past {timeout:.0f} s: "
                        + " | ".join(_tail(e) for e in errs))
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
            if failed is not None:
                _stop(procs)
                raise LaunchError(
                    f"rank {failed} of {nprocs} exited {procs[failed].returncode}; its output: "
                    f"{_tail(outs[failed])}; its errors: {_tail(errs[failed])}",
                    procs[failed].returncode)
            results = []
            for out in outs:
                out.seek(0)
                results.append(out.read())
            return results
        finally:
            _stop(procs)
            for f in outs + errs:
                f.close()
            for sig, handler in previous.items():
                signal.signal(sig, handler)


def _tail(f, n: int = 4000) -> str:
    f.flush()
    f.seek(0)
    return f.read()[-n:]


def _stop(procs) -> None:
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.terminate()
    for p in live:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bpe_transformer_tpu_torch.parallel.launch",
        description="Run a world of rank processes on this host until it ends.")
    parser.add_argument("--nproc-per-node", type=int, required=True)
    parser.add_argument("argv", nargs=argparse.REMAINDER,
                        help="the python arguments of every rank (after --)")
    args = parser.parse_args(argv)
    rank_argv = args.argv[1:] if args.argv[:1] == ["--"] else args.argv
    try:
        outs = launch(rank_argv, args.nproc_per_node, timeout=math.inf, forward_signals=True)
    except LaunchError as exc:
        print(f"launch: {exc}", file=sys.stderr)
        return exc.returncode if exc.returncode and exc.returncode > 0 else 1
    print(outs[0], end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
