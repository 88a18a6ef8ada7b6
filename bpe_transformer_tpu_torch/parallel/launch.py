"""Start a world of rank processes on this host, as ``torchrun
--nproc-per-node N`` does, for a script that joins it with
:func:`parallel.mesh.initialize_distributed`.

Each rank is ``python <argv...>`` with torchrun's environment (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port).  The first rank that fails stops the
others, so a failure never leaves the rest waiting in a collective: every
process this function starts has ended when it returns or raises.
"""

from __future__ import annotations

import os
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
    """A rank exited non-zero, or the world outlived its time limit."""


def launch(argv: list, nprocs: int, *, env: dict | None = None, timeout: float = 600.0,
           cwd: str | os.PathLike | None = None) -> list[str]:
    """Run ``python <argv>`` as ``nprocs`` ranks of one world and wait for
    them; returns each rank's standard output.  Raises :class:`LaunchError`
    with the failing rank's standard error when a rank exits non-zero or
    the world runs past ``timeout`` seconds; the other ranks are stopped
    (SIGTERM, then SIGKILL after 10 s)."""
    port = free_port()
    base = {**os.environ, **(env or {})}
    procs, outs, errs = [], [], []
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
                    f"{_tail(outs[failed])}; its errors: {_tail(errs[failed])}")
            results = []
            for out in outs:
                out.seek(0)
                results.append(out.read())
            return results
        finally:
            _stop(procs)
            for f in outs + errs:
                f.close()


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
