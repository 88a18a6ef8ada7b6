"""What the example scripts share: the default corpus (the repo's own
markdown files joined with ``<|endoftext|>``), the ``--device`` and
``--world`` flags, the world of rank processes a multi-rank script runs in,
and the line that reports the kernels a script launched.

The scripts import it as ``_common`` (their own directory is first on
``sys.path`` when Python runs them)."""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SPECIALS = ["<|endoftext|>"]

if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def add_input_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--input", type=Path, default=None,
                        help="a text file (default: the repo's *.md files joined with "
                        "<|endoftext|>)")


def add_device_args(parser: argparse.ArgumentParser, world: bool = False) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    if world:
        parser.add_argument("--world", type=int, default=1,
                            help="rank processes, one a card (gloo ranks with --device cpu)")


def corpus(args, out_dir: Path) -> Path:
    """``args.input``, or the default corpus written to ``out_dir``."""
    if args.input is not None:
        return args.input
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "corpus.txt"
    path.write_text(SPECIALS[0].join(p.read_text(encoding="utf-8")
                                     for p in sorted(REPO.glob("*.md"))), encoding="utf-8")
    return path


def in_world() -> bool:
    """Whether this process is a rank of a launched world."""
    return "RANK" in os.environ


def run_world(main, world: int) -> int:
    """Run ``main()`` as every rank of a world of ``world`` processes: in
    this process when it already is a rank or ``world`` is 1 (a world of
    one, joined over a free local port), else as ``world`` copies of this
    script started by ``parallel/launch.py``, printing rank 0's output.
    A rank leaves the process group before it exits."""
    from bpe_transformer_tpu_torch.parallel.launch import free_port, launch

    if in_world() or world == 1:
        if not in_world():
            os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", LOCAL_WORLD_SIZE="1",
                              MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
        import torch.distributed as dist

        try:
            return main()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    outs = launch([sys.argv[0], *sys.argv[1:]], world, timeout=1800,
                  env={"PYTHONPATH": os.pathsep.join(filter(None, (
                      str(REPO), os.environ.get("PYTHONPATH"))))})
    print(outs[0], end="", flush=True)
    return 0


def rank0() -> bool:
    return os.environ.get("RANK", "0") == "0"


def report_launches() -> None:
    """Print the kernels this process launched (none on the CPU, where the
    wrappers run their plain versions)."""
    from bpe_transformer_tpu_torch.kernels import _build

    launched = {k: n for k, n in sorted(_build.launches.items()) if n}
    print(f"kernel launches: {launched}", flush=True)
