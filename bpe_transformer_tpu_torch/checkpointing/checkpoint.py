"""Single-file checkpoints, format v1 (port of the dense format of
``bpe_transformer_tpu/checkpointing/checkpoint.py``).

A checkpoint is a pickled dict ``{"format_version": 1, "params",
"opt_state", "iteration", "extra"}`` whose tensors are numpy arrays, written
to a temp file and renamed into place, with a CRC32 sidecar
(``resilience/integrity.py``).  The optimizer state is an ``AdamWState`` or,
from a ZeRO-1 run, a ``ShardedAdamWState`` whose ``m``, ``v`` and ``master``
are the whole ``(N, L)`` rows (``optim/sharded.py``).  Both packages read
each other's checkpoints: the port's pickle names these two classes as the
JAX package's (``bpe_transformer_tpu.optim.adamw.AdamWState``,
``bpe_transformer_tpu.optim.sharded.ShardedAdamWState``) without importing
it, and the loader maps those names to the port's classes and refuses any
other global of the JAX package or of JAX.  Under data or sequence
parallelism rank 0 writes the file, as the JAX loop does
(``training/loop.py``).

The sharded directory format (v2) is the JAX package's, file for file:
``leaf_{i:05d}.npy`` for a leaf held whole, ``leaf_{i:05d}.{j:03d}.npy`` for
each distinct block of a sharded one (in the order of the ranks that first
hold it), ``treedef.pkl`` (the pickled ``jax.tree_util`` structure of
``{"opt_state", "params"}``) and ``manifest.json`` (leaf shapes, dtypes,
shard index boxes and every file's CRC32), built in a temporary directory
and swapped into place.  Under a GSPMD strategy every rank writes the blocks
it is the lowest rank to hold, and rank 0, once every rank's files and
checksums have reached it over a gloo group made for the purpose, writes the
structure and the manifest and swaps the directory in.  Reading places each
leaf onto a target: a rank reads only the parts of the shard files that
overlap the block it holds (memory-mapped), so neither side ever holds the
whole tree on one host.

:func:`load_checkpoint_with_fallback` is the resume path: it verifies a
snapshot against its CRC32 sidecar before loading it, quarantines one that
fails and falls back to the newest valid earlier snapshot, with the JAX
package's rules.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import sys
import tempfile
import threading
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np
import torch

from bpe_transformer_tpu_torch.device import resolve_device
from bpe_transformer_tpu_torch.optim.adamw import AdamWState
from bpe_transformer_tpu_torch.optim.sharded import ShardedAdamWState
from bpe_transformer_tpu_torch.resilience.integrity import (
    Crc32Writer,
    candidate_snapshots,
    quarantine,
    snapshot_step,
    verify_checkpoint,
    write_sidecar,
)
from bpe_transformer_tpu_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

_FORMAT_VERSION = 1
_SHARDED_FORMAT_VERSION = 2
_MANIFEST = "manifest.json"
#: Marker file dropped in displaced-checkpoint temp dirs so recovery/reclaim
#: only ever touches directories this code created.
_DISPLACED_MARKER = ".bt_displaced"


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
    if isinstance(state, ShardedAdamWState):
        return ShardedAdamWState(
            step=np.asarray(int(state.step), dtype=np.int32),
            m=host(state.m), v=host(state.v),
            master=None if state.master is None else host(state.master),
        )
    return tree_map(host, state)


#: The port's optimizer states, pickled under the JAX package's names.
_JAX_NAMES = {
    AdamWState: ("bpe_transformer_tpu.optim.adamw", "AdamWState"),
    ShardedAdamWState: ("bpe_transformer_tpu.optim.sharded", "ShardedAdamWState"),
}


class _GlobalName:
    """A global written into the pickle by module and name, never looked up
    here."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name

    def __call__(self, *args):  # pickle's save_reduce wants a callable
        raise TypeError(f"{self.module}.{self.name} is only a name in a pickle")


class _Pickler(pickle._Pickler):
    """Pickles the optimizer states under the JAX package's class names
    (``reducer_override``), so the JAX package's plain ``pickle.load``
    rebuilds its own classes; the pure-Python pickler, whose dispatch table
    can write a global that cannot be imported here."""

    dispatch = dict(pickle._Pickler.dispatch)

    def _save_global_name(self, obj: _GlobalName) -> None:
        if self.proto >= 4:
            self.save(obj.module)
            self.save(obj.name)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{obj.module}\n{obj.name}\n".encode())
        self.memoize(obj)

    dispatch[_GlobalName] = _save_global_name

    def _save_treedef(self, obj: "_TreeDef") -> None:
        # As jaxlib pickles a PyTreeDef: NEWOBJ of the class, then BUILD
        # with (registry, nodes).
        self.save(_GlobalName(*_TREEDEF_NAME))
        self.write(pickle.EMPTY_TUPLE + pickle.NEWOBJ)
        self.memoize(obj)
        self.save((_GlobalName(*_REGISTRY_NAME), obj.nodes))
        self.write(pickle.BUILD)

    def reducer_override(self, obj):
        name = _JAX_NAMES.get(type(obj))
        if name is None:
            return NotImplemented
        return _GlobalName(*name), tuple(obj)


#: The JAX package's tree structures are jaxlib's ``PyTreeDef`` pickles
#: (jaxlib 0.9.0: class ``jaxlib._jax.pytree.PyTreeDef``, state the default
#: registry and the post-order node list below; older jaxlib named the
#: module ``jaxlib.xla_extension.pytree``).
_TREEDEF_NAME = ("jaxlib._jax.pytree", "PyTreeDef")
_TREEDEF_NAMES = {_TREEDEF_NAME, ("jaxlib.xla_extension.pytree", "PyTreeDef")}
_REGISTRY_NAME = ("jax._src.tree_util", "default_registry")
#: Node kinds of a PyTreeDef's node tuples ``(kind, arity, node_data,
#: custom, num_leaves, num_nodes)``.
_LEAF, _NONE, _TUPLE, _NAMEDTUPLE, _LIST, _DICT = range(6)


class _TreeDef:
    """The structure of a checkpoint tree as jaxlib pickles it: node tuples
    in post-order (dict node data: the sorted keys; named-tuple node data:
    the class)."""

    def __init__(self, nodes=None):
        self.nodes = list(nodes or [])

    def __setstate__(self, state):
        self.nodes = list(state[1])

    @classmethod
    def of(cls, tree) -> "_TreeDef":
        """The structure of a tree of dicts, lists, ``AdamWState``s, None
        and leaves, as JAX flattens it."""
        nodes: list = []

        def visit(node) -> tuple[int, int]:
            if node is None:
                nodes.append((_NONE, 0, None, None, 0, 1))
                return 0, 1
            if isinstance(node, AdamWState):
                kind, data, children = _NAMEDTUPLE, _GlobalName(*_JAX_NAMES[AdamWState]), list(node)
            elif isinstance(node, dict):
                keys = sorted(node)
                kind, data, children = _DICT, keys, [node[k] for k in keys]
            elif isinstance(node, list):
                kind, data, children = _LIST, None, node
            elif isinstance(node, tuple):
                kind, data, children = _TUPLE, None, list(node)
            else:
                nodes.append((_LEAF, 0, None, None, 1, 1))
                return 1, 1
            leaves, count = 0, 1
            for child in children:
                a, b = visit(child)
                leaves, count = leaves + a, count + b
            nodes.append((kind, len(children), data, None, leaves, count))
            return leaves, count

        visit(tree)
        return cls(nodes)

    def unflatten(self, leaves):
        it = iter(leaves)
        stack: list = []
        for kind, arity, data, *_ in self.nodes:
            if kind == _LEAF:
                stack.append(next(it))
                continue
            if kind == _NONE:
                stack.append(None)
                continue
            children = stack[len(stack) - arity:]
            del stack[len(stack) - arity:]
            if kind == _TUPLE:
                stack.append(tuple(children))
            elif kind == _NAMEDTUPLE:
                stack.append(data(*children))
            elif kind == _LIST:
                stack.append(children)
            elif kind == _DICT:
                stack.append(dict(zip(data, children)))
            else:
                raise ValueError(f"treedef.pkl holds a node of kind {kind}, which the port reads not")
        return stack[0]


_Pickler.dispatch[_TreeDef] = _Pickler._save_treedef


def _dump(payload: dict, f) -> None:
    _Pickler(f, protocol=pickle.DEFAULT_PROTOCOL).dump(payload)


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
        _dump(payload, out)
        return
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer = Crc32Writer(f)
            _dump(payload, writer)
        os.replace(tmp_name, path)
        write_sidecar(path, writer.crc, writer.size)
    except BaseException:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)
        raise


class _Unpickler(pickle.Unpickler):
    """Maps the JAX package's optimizer states to the port's and refuses
    every other global of the JAX package or of JAX."""

    _PORT_CLASSES = {name: cls for cls, name in _JAX_NAMES.items()}

    def find_class(self, module, name):
        if (module, name) in self._PORT_CLASSES:
            return self._PORT_CLASSES[module, name]
        if (module, name) in _TREEDEF_NAMES:
            return _TreeDef
        if (module, name) == _REGISTRY_NAME:
            return None
        if module.split(".")[0] in ("bpe_transformer_tpu", "jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}, which the port does not load"
            )
        return super().find_class(module, name)


def load_checkpoint(src: str | os.PathLike | BinaryIO) -> dict:
    """Load a snapshot: a single-file checkpoint (path or binary file
    object) or a sharded directory (whole leaves; crash-stranded orphans
    recovered); returns the payload dict with numpy arrays
    (:func:`training_state` puts it on a device)."""
    if hasattr(src, "read"):
        payload = _Unpickler(src).load()
    else:
        if Path(src).is_dir() or (not Path(src).exists() and sharded_checkpoint_exists(src)):
            return load_checkpoint_sharded(src)
        with open(src, "rb") as f:
            payload = _Unpickler(f).load()
    version = payload.get("format_version")
    if version != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format version: {version}")
    return payload


# ------------------------------------------------- sharded directory format


def _stranded_orphans(path: Path) -> list[Path]:
    """Displaced-checkpoint dirs a crashed save stranded next to ``path``,
    oldest first: named ``<name>.old*``, carrying the ownership marker and
    a complete manifest (the JAX package's rule)."""
    parent = path.parent
    if not parent.is_dir():
        return []
    prefix = path.name + ".old"
    orphans = [parent / entry for entry in os.listdir(parent)
               if entry.startswith(prefix) and (parent / entry / _DISPLACED_MARKER).exists()
               and (parent / entry / "d" / _MANIFEST).exists()]
    return sorted(orphans, key=lambda p: (p / "d").stat().st_mtime)


def sharded_checkpoint_exists(path: str | os.PathLike) -> bool:
    """True when ``path`` is a loadable sharded checkpoint: it has a
    manifest, or a crash-stranded ``<name>.old*/d`` sibling does."""
    p = Path(path)
    return (p / _MANIFEST).exists() or bool(_stranded_orphans(p))


#: ``(world group, writers' group)``: the gloo group made for the world
#: that is current (a world destroyed and joined again gets a new one).
_WRITER_GROUP: tuple = (None, None)


def _writer_group():
    """The gloo group over the world that coordinates sharded writers, made
    once a world (a collective call: every rank makes it at the same save).
    Its own group, so a background write never interleaves with the step's
    collectives."""
    import torch.distributed as dist

    global _WRITER_GROUP
    if _WRITER_GROUP[0] is not dist.group.WORLD:
        _WRITER_GROUP = (dist.group.WORLD, dist.new_group(backend="gloo"))
    return _WRITER_GROUP[1]


def _leaf_snapshots(params, opt_state, layout=None, eager: bool = False):
    """``(records, files, treedef)``: the manifest record of every leaf, in
    the order JAX flattens ``{"opt_state", "params"}``, the ``(filename,
    get_array)`` of the files THIS rank writes, and the structure.  Under
    ``layout`` (a ``parallel.gspmd.GspmdLayout``) a leaf whose blocks
    differ across ranks is written block by block, each by the lowest rank
    that holds it; a leaf held whole (or without a layout) is written by
    rank 0.  ``eager`` copies this rank's arrays to the host now (the
    asynchronous save)."""
    from bpe_transformer_tpu_torch.parallel.sharding import distinct_boxes

    tree = {"params": params, "opt_state": opt_state}
    treedef = _TreeDef.of(tree)
    leaves = [leaf for leaf in tree_leaves(tree) if leaf is not None]
    specs = [None] * len(leaves)
    rank = 0
    if layout is not None:
        import torch.distributed as dist

        rank = dist.get_rank()
        moments = [] if opt_state is None else [()] + layout.leaf_moment_specs * 2
        specs = moments + layout.leaf_specs
    records, files = [], []
    for i, (leaf, spec) in enumerate(zip(leaves, specs, strict=True)):
        name = f"leaf_{i:05d}"
        local = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        boxes = [] if not spec else distinct_boxes(_whole_shape(local, spec, layout), spec,
                                                     layout.mesh)
        whole = list(_whole_shape(local, spec, layout)) if spec else list(local)
        get = (lambda t: lambda: _host_array(t, copy=eager))(leaf)
        record = {"name": name, "shape": whole, "dtype": str(_host_dtype(leaf))}
        if len(boxes) > 1:
            record["shards"] = [{"index": [list(b) for b in box]} for box, _ in boxes]
            files += [(f"{name}.{j:03d}.npy", get) for j, (_, owner) in enumerate(boxes)
                      if owner == rank]
        elif rank == 0:
            files.append((f"{name}.npy", get))
        records.append(record)
    if eager:
        files = [(fname, (lambda a: lambda: a)(get())) for fname, get in files]
    return records, files, treedef


def _whole_shape(local: tuple, spec, layout) -> tuple:
    if not spec:
        return local
    return tuple(d * (layout.mesh.shape.get(a, 1) if a else 1) for d, a in zip(local, spec))


def _host_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return np.dtype(str(leaf.dtype).removeprefix("torch."))
    return np.asarray(leaf).dtype


def _write_sharded_dir(out_dir: Path, treedef, records, files, iteration: int,
                       extra: dict | None, group=None) -> None:
    """Write a snapshot into ``out_dir`` (temp-dir build, then the
    displaced swap).  With ``group`` (the writers' gloo group) rank 0 makes
    the temp dir and sends its name round, every rank writes its files,
    rank 0 gathers the checksums, writes the structure and the manifest and
    swaps the directory in, and every rank returns once it is in place (or
    raises what any rank hit)."""
    import torch.distributed as dist

    rank = dist.get_rank() if group is not None else 0
    tmp = [None]
    if rank == 0:
        out_dir.parent.mkdir(parents=True, exist_ok=True)
        tmp = [tempfile.mkdtemp(dir=out_dir.parent, prefix=out_dir.name + ".tmp")]
    if group is not None:
        dist.broadcast_object_list(tmp, src=0, group=group)
    tmp_dir = Path(tmp[0])
    checksums: dict[str, dict] = {}

    def write(fname: str, dump) -> None:
        with open(tmp_dir / fname, "wb") as f:
            writer = Crc32Writer(f)
            dump(writer)
        checksums[fname] = {"crc32": writer.crc, "size": writer.size}

    error = None
    try:
        for fname, get_array in files:
            write(fname, (lambda get: lambda w: np.save(w, get()))(get_array))
    except Exception as exc:  # noqa: BLE001 - reported to every rank below
        error = f"rank {rank}: {exc!r}"
    gathered = [(checksums, error)]
    if group is not None:
        gathered = [None] * dist.get_world_size() if rank == 0 else None
        dist.gather_object((checksums, error), gathered, dst=0, group=group)
    outcome = [None]
    if rank == 0:
        try:
            errors = [e for _, e in gathered if e]
            if errors:
                raise OSError("; ".join(errors))
            all_sums: dict = {}
            for sums, _ in gathered:
                all_sums.update(sums)
            checksums = all_sums
            write("treedef.pkl", lambda w: _Pickler(w, protocol=pickle.DEFAULT_PROTOCOL).dump(
                treedef))
            manifest = {"format_version": _SHARDED_FORMAT_VERSION, "iteration": int(iteration),
                        "extra": extra or {}, "leaves": records, "checksums": checksums}
            with open(tmp_dir / _MANIFEST, "w") as f:
                json.dump(manifest, f)
            _swap_in(tmp_dir, out_dir)
        except BaseException as exc:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            outcome = [repr(exc)]
            if group is None:
                raise
    if group is not None:
        dist.broadcast_object_list(outcome, src=0, group=group)
        if outcome[0] is not None:
            raise OSError(f"sharded checkpoint {out_dir} was not written: {outcome[0]}")


def _swap_in(tmp_dir: Path, out_dir: Path) -> None:
    """Put a finished directory in place: an existing checkpoint is renamed
    aside first (renamed back if the swap fails; a hard crash in between
    strands it in a marked ``<name>.old*/d`` that loading recovers), then
    removed, and marked orphans of earlier crashed saves are reclaimed."""
    displaced = None
    try:
        if out_dir.exists():
            displaced = Path(tempfile.mkdtemp(dir=out_dir.parent, prefix=out_dir.name + ".old"))
            (displaced / _DISPLACED_MARKER).touch()
            os.rename(out_dir, displaced / "d")
        os.replace(tmp_dir, out_dir)
    except BaseException:
        if displaced is not None and not out_dir.exists() and (displaced / "d").exists():
            os.rename(displaced / "d", out_dir)
            shutil.rmtree(displaced, ignore_errors=True)
        raise
    if displaced is not None:
        shutil.rmtree(displaced, ignore_errors=True)
    prefix = out_dir.name + ".old"
    for entry in os.listdir(out_dir.parent):
        stale = out_dir.parent / entry
        if entry.startswith(prefix) and (stale / _DISPLACED_MARKER).exists():
            shutil.rmtree(stale, ignore_errors=True)


def save_checkpoint_sharded(out_dir: str | os.PathLike, *, params: Any, opt_state: Any = None,
                            iteration: int = 0, extra: dict | None = None,
                            layout=None) -> None:
    """Write a training state into a checkpoint directory (format v2), one
    shard at a time.  Without ``layout`` every leaf is one file (the JAX
    package's single-device directory).  With ``layout`` (a
    ``parallel.gspmd.GspmdLayout``) every rank calls this with its blocks
    of the parameters and moments: each distinct block is written once, by
    the lowest rank that holds it, and every rank returns once the
    directory is in place."""
    records, files, treedef = _leaf_snapshots(params, opt_state, layout)
    group = _writer_group() if layout is not None else None
    _write_sharded_dir(Path(out_dir), treedef, records, files, iteration, extra, group)


def _check_shards_tile(record: dict) -> None:
    """A manifest leaf's shard index boxes must tile its shape exactly
    (pairwise disjoint, volumes summing to the total): else a partial
    manifest would restore uninitialized memory."""
    shape = record["shape"]
    total = int(np.prod(shape)) if shape else 1
    boxes = [s["index"] for s in record["shards"]]
    covered = 0
    for box in boxes:
        vol = 1
        for (start, stop), dim in zip(box, shape):
            if not (0 <= start <= stop <= dim):
                raise ValueError(
                    f"checkpoint leaf {record['name']}: shard index {box} out of bounds for "
                    f"shape {shape}"
                )
            vol *= stop - start
        covered += vol
    disjoint = all(
        any(a1 >= b2 or b1 >= a2 for (a1, a2), (b1, b2) in zip(pa, pb))
        for i, pa in enumerate(boxes) for pb in boxes[i + 1:]
    )
    if covered != total or not disjoint:
        raise ValueError(
            f"checkpoint leaf {record['name']}: shard files cover {covered}/{total} elements"
            + ("" if disjoint else " with overlapping ranges")
            + f" of shape {shape} — incomplete or corrupt manifest "
            "(possibly written from one process of a multi-process mesh)"
        )


def _read_leaf(src_dir: Path, record: dict, box) -> np.ndarray:
    """The part ``box`` (default: all) of one leaf, reading only the parts
    of its shard files that overlap it (memory-mapped)."""
    name, shape = record["name"], record["shape"]
    if not shape:
        return np.load(src_dir / f"{name}.npy")[()]
    box = box or tuple((0, d) for d in shape)
    if "shards" not in record:
        return np.array(np.load(src_dir / f"{name}.npy", mmap_mode="r")[_box_slices(box)])
    _check_shards_tile(record)
    out = np.empty([b - a for a, b in box], dtype=np.dtype(record["dtype"]))
    for j, shard in enumerate(record["shards"]):
        inter = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(box, shard["index"])]
        if any(lo >= hi for lo, hi in inter):
            continue
        arr = np.load(src_dir / f"{name}.{j:03d}.npy", mmap_mode="r")
        src = tuple(slice(lo - c, hi - c) for (lo, hi), (c, _) in zip(inter, shard["index"]))
        dst = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in zip(inter, box))
        out[dst] = arr[src]
    return out


def _box_slices(box) -> tuple:
    return tuple(slice(a, b) for a, b in box)


def load_checkpoint_sharded(src_dir: str | os.PathLike, select=None) -> dict:
    """Load a sharded checkpoint directory; returns the payload dict of
    :func:`load_checkpoint` (numpy leaves).  ``select(path, shape)`` picks
    the part of each leaf to read, a box ``((start, stop), ...)`` or None
    for the whole leaf (``path`` is the leaf's key path in ``{"opt_state",
    "params"}``, ``shape`` its whole shape): a rank resuming a sharded run
    reads only its blocks.  A checkpoint a crashed save left displaced is
    recovered first, as in the JAX package."""
    src_dir = Path(src_dir)
    if not (src_dir / _MANIFEST).exists():
        orphans = _stranded_orphans(src_dir)
        if orphans:
            print(f"checkpoint {src_dir} missing; recovering the copy a crashed save stranded "
                  f"in {orphans[-1]}", file=sys.stderr)
            try:
                os.rename(orphans[-1] / "d", src_dir)
            except OSError:
                # Another loader won the promotion race.
                if not (src_dir / _MANIFEST).exists():
                    raise
            for leftover in orphans:
                shutil.rmtree(leftover, ignore_errors=True)
    with open(src_dir / _MANIFEST) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != _SHARDED_FORMAT_VERSION:
        raise ValueError(
            f"unsupported sharded checkpoint format version: {manifest.get('format_version')}"
        )
    with open(src_dir / "treedef.pkl", "rb") as f:
        treedef = _Unpickler(f).load()
    if not isinstance(treedef, _TreeDef):
        raise ValueError(f"{src_dir / 'treedef.pkl'} holds no tree structure")
    records = manifest["leaves"]
    skeleton = treedef.unflatten(range(len(records)))
    paths = {i: path for path, i in tree_flatten_with_path(skeleton) if i is not None}
    leaves = []
    for i, record in enumerate(records):
        box = select(paths[i], tuple(record["shape"])) if select is not None else None
        leaves.append(_read_leaf(src_dir, record, box))
    tree = treedef.unflatten(leaves)
    return {
        "format_version": _FORMAT_VERSION,
        "params": tree["params"],
        "opt_state": tree["opt_state"],
        "iteration": manifest["iteration"],
        "extra": manifest["extra"],
    }


def training_state(payload: dict, device: str | torch.device = "cuda"):
    """``(params, opt_state)`` of a loaded payload as tensors on ``device``
    (``opt_state`` None when the checkpoint holds none; its step stays on
    the host, as :mod:`optim.adamw` keeps it).  A sharded optimizer state
    is returned as it is (numpy rows): ``optim.sharded.restore_opt_state``
    adapts it to the run."""
    dev = resolve_device(device)
    to_dev = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    params = tree_map(to_dev, payload["params"])
    opt = payload.get("opt_state")
    if opt is None or isinstance(opt, ShardedAdamWState):
        return params, opt
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
             iteration: int = 0, extra: dict | None = None, on_complete=None,
             sharded: bool = False, layout=None) -> None:
        """Snapshot now, write in the background.  ``on_complete()`` runs on
        the writer thread after a successful write (the loop points
        ``latest.ckpt`` at the new file there).  ``sharded`` writes a
        directory (:func:`save_checkpoint_sharded`; under ``layout`` every
        rank calls this with its blocks, and the writers coordinate over
        their own gloo group, never the step's)."""
        self.wait()
        if sharded:
            records, files, treedef = _leaf_snapshots(params, opt_state, layout, eager=True)
            group = _writer_group() if layout is not None else None

            def write():
                _write_sharded_dir(Path(out), treedef, records, files, iteration, extra, group)
        else:
            host_params = _to_host(params, copy=True)
            host_opt = _to_host(opt_state, copy=True) if opt_state is not None else None

            def write():
                save_checkpoint(out, params=host_params, opt_state=host_opt,
                                iteration=iteration, extra=extra)

        def work():
            try:
                write()
                if on_complete is not None:
                    on_complete()
            except BaseException as exc:  # noqa: BLE001 - re-raised in wait()
                self._error = exc

        self._thread = threading.Thread(target=work, name="async-checkpoint", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.wait()
