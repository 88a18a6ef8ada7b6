"""ctypes binding of the port's C++ tokenization engine (the port's copy of
``bpe_transformer_tpu/native/engine.py``).

Builds ``src/bt_native.cpp`` with ``g++`` into a shared library on first use
(cached under ``_build/`` keyed by a hash of the sources, so each source
change compiles exactly once; the library is written to a per-process
temporary name and moved into place with :func:`os.replace`, so concurrent
processes never load a half-written file) and exposes
:func:`pretokenize_offsets`, :func:`train_bpe_merges`,
:class:`NativePretokenCounter` and :class:`NativeBPEEncoder`, the fused
pretokenize-and-encode path of
:class:`~bpe_transformer_tpu_torch.tokenization.BPETokenizer`.

The native path is an accelerator only: the tokenizer and trainer fall back
to the pure-Python path whenever no compiler is present
(:func:`is_available`), and both paths give the same pre-tokens, counts,
merges and ids.  Set ``BT_NATIVE=0`` to turn the native path off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC_DIR = Path(__file__).parent / "src"
_BUILD_DIR = Path(__file__).parent / "_build"
_SOURCES = [_SRC_DIR / "bt_native.cpp", _SRC_DIR / "unicode_classes.inc"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed: str | None = None


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile() -> Path:
    out = _BUILD_DIR / f"libbt_native-{_source_hash()}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden",
        str(_SOURCES[0]), "-o", str(tmp),
    ]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)  # atomic under concurrent builds
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None or _load_failed is not None:
        return _lib
    with _lock:
        if _lib is not None or _load_failed is not None:
            return _lib
        if os.environ.get("BT_NATIVE", "1") == "0":
            _load_failed = "disabled via BT_NATIVE=0"
            return None
        try:
            lib = ctypes.CDLL(str(_compile()))
        except (OSError, subprocess.SubprocessError, FileNotFoundError) as exc:
            _load_failed = f"native build unavailable: {exc!r}"
            return None

        lib.bt_engine_new.restype = ctypes.c_void_p
        lib.bt_engine_new.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.bt_engine_free.restype = None
        lib.bt_engine_free.argtypes = [ctypes.c_void_p]
        lib.bt_encode.restype = ctypes.c_int64
        lib.bt_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.bt_pretokenize.restype = ctypes.c_int64
        lib.bt_pretokenize.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        lib.bt_train_bpe.restype = ctypes.c_int64
        lib.bt_train_bpe.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.bt_counter_new.restype = ctypes.c_void_p
        lib.bt_counter_new.argtypes = []
        lib.bt_counter_free.restype = None
        lib.bt_counter_free.argtypes = [ctypes.c_void_p]
        lib.bt_counter_add.restype = None
        lib.bt_counter_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.bt_counter_add_prefix.restype = ctypes.c_int64
        lib.bt_counter_add_prefix.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.bt_counter_stats.restype = None
        lib.bt_counter_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.bt_counter_items.restype = ctypes.c_int64
        lib.bt_counter_items.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.bt_train_bpe_from_counter.restype = ctypes.c_int64
        lib.bt_train_bpe_from_counter.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def is_available() -> bool:
    """True when the native engine compiled and loaded on this host."""
    return _load() is not None


def unavailable_reason() -> str | None:
    _load()
    return _load_failed


def pretokenize_offsets(text: str) -> list[tuple[int, int]]:
    """(start, end) byte offsets of GPT-2 pre-tokens (scanner parity hook)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(_load_failed or "native engine unavailable")
    data = text.encode("utf-8")
    cap = max(len(data), 1)
    out = (ctypes.c_int64 * (2 * cap))()
    n = lib.bt_pretokenize(data, len(data), out, cap)
    if n < 0:  # cannot happen: a pre-token is at least one byte
        raise RuntimeError("pretokenize capacity underflow")
    return [(out[2 * i], out[2 * i + 1]) for i in range(n)]


def train_bpe_merges(
    words: list[tuple[int, ...]],
    counts: list[int],
    vocab_bytes: list[bytes],
    target_vocab: int,
) -> list[tuple[int, int]]:
    """Run the C++ greedy BPE merge loop.

    ``words``: distinct pre-tokens as id tuples (len >= 2) with parallel
    ``counts`` multiplicities; ``vocab_bytes[id]`` are the initial vocab
    entries (the tie-break compares these byte strings).  Returns the ordered
    merge list as ``(left_id, right_id)`` pairs; merge ``i`` creates id
    ``len(vocab_bytes) + i``.
    """
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError(_load_failed or "native engine unavailable")

    word_data = np.fromiter(
        (t for w in words for t in w), dtype=np.int32
    )
    word_offsets = np.zeros(len(words) + 1, dtype=np.int64)
    np.cumsum([len(w) for w in words], out=word_offsets[1:])
    counts_arr = np.asarray(counts, dtype=np.int64)

    vocab_data = np.frombuffer(b"".join(vocab_bytes), dtype=np.uint8)
    vocab_offsets = np.zeros(len(vocab_bytes) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in vocab_bytes], out=vocab_offsets[1:])

    out_cap = max(target_vocab - len(vocab_bytes), 0)
    out = np.empty(2 * max(out_cap, 1), dtype=np.int32)

    as_ptr = lambda arr, ct: arr.ctypes.data_as(ctypes.POINTER(ct))
    n = lib.bt_train_bpe(
        as_ptr(word_data, ctypes.c_int32),
        as_ptr(word_offsets, ctypes.c_int64),
        len(words),
        as_ptr(counts_arr, ctypes.c_int64),
        as_ptr(vocab_data, ctypes.c_uint8),
        as_ptr(vocab_offsets, ctypes.c_int64),
        len(vocab_bytes),
        target_vocab,
        as_ptr(out, ctypes.c_int32),
        out_cap,
    )
    if n < 0:  # cannot happen: the loop stops at target_vocab
        raise RuntimeError("train_bpe capacity underflow")
    return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]


class NativePretokenCounter:
    """Streaming GPT-2 pre-token counter over the C++ scanner.

    Feed specials-free text parts with :meth:`add`; read the accumulated
    counts with :meth:`items`, or hand the whole counter to
    :meth:`train_bpe` without ever materializing it in Python.
    """

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError(_load_failed or "native engine unavailable")
        self._lib = lib
        self._handle = lib.bt_counter_new()
        if not self._handle:
            raise RuntimeError("bt_counter_new returned NULL")

    def add(self, part: "str | bytes") -> None:
        data = part.encode("utf-8") if isinstance(part, str) else part
        if data:
            self._lib.bt_counter_add(self._handle, data, len(data))

    def add_prefix(self, data: bytes) -> int:
        """Count all pre-tokens ending strictly before the end of ``data``;
        returns bytes consumed (the tail must be re-fed with the next chunk)."""
        if not data:
            return 0
        return self._lib.bt_counter_add_prefix(self._handle, data, len(data))

    def items(self) -> list[tuple[bytes, int]]:
        import numpy as np

        n_items = ctypes.c_int64()
        total_bytes = ctypes.c_int64()
        self._lib.bt_counter_stats(
            self._handle, ctypes.byref(n_items), ctypes.byref(total_bytes)
        )
        n = n_items.value
        str_data = np.empty(max(total_bytes.value, 1), dtype=np.uint8)
        offsets = np.empty(n + 1, dtype=np.int64)
        counts = np.empty(max(n, 1), dtype=np.int64)
        got = self._lib.bt_counter_items(
            self._handle,
            str_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        raw = str_data.tobytes()
        return [
            (raw[offsets[i] : offsets[i + 1]], int(counts[i])) for i in range(got)
        ]

    def train_bpe(
        self, vocab_bytes: list[bytes], target_vocab: int
    ) -> list[tuple[int, int]]:
        """Fused count->train: run the C++ merge loop on this counter."""
        import numpy as np

        vocab_data = np.frombuffer(b"".join(vocab_bytes), dtype=np.uint8)
        vocab_offsets = np.zeros(len(vocab_bytes) + 1, dtype=np.int64)
        np.cumsum([len(v) for v in vocab_bytes], out=vocab_offsets[1:])
        out_cap = max(target_vocab - len(vocab_bytes), 0)
        out = np.empty(2 * max(out_cap, 1), dtype=np.int32)
        n = self._lib.bt_train_bpe_from_counter(
            self._handle,
            vocab_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            vocab_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(vocab_bytes),
            target_vocab,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_cap,
        )
        if n < 0:  # cannot happen: the loop stops at target_vocab
            raise RuntimeError("train_bpe capacity underflow")
        return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bt_counter_free(handle)
            self._handle = None


class NativeBPEEncoder:
    """Fused pretokenize+encode over a compiled merge table.

    Constructed from the same ``(byte_id, pair_rank)`` tables the Python
    encoder compiles, so both paths share one source of truth for greedy
    merge order.
    """

    def __init__(
        self,
        byte_id: list[int | None],
        pair_rank: dict[tuple[int, int], tuple[int, int]],
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(_load_failed or "native engine unavailable")
        self._lib = lib

        byte_arr = (ctypes.c_int32 * 256)(
            *[(-1 if i is None else i) for i in byte_id]
        )
        n = len(pair_rank)
        lefts = (ctypes.c_int32 * n)()
        rights = (ctypes.c_int32 * n)()
        ranks = (ctypes.c_int32 * n)()
        merged = (ctypes.c_int32 * n)()
        for idx, ((left, right), (rank, merged_id)) in enumerate(pair_rank.items()):
            lefts[idx] = left
            rights[idx] = right
            ranks[idx] = rank
            merged[idx] = merged_id
        self._handle = lib.bt_engine_new(byte_arr, n, lefts, rights, ranks, merged)
        if not self._handle:
            raise RuntimeError("bt_engine_new returned NULL")

    def encode_part(self, part: str) -> list[int]:
        """Token ids of a specials-free text part."""
        return self.encode_part_array(part).tolist()

    def encode_part_array(self, part: str) -> "np.ndarray":
        """Token ids of a specials-free text part as an int32 array."""
        import numpy as np

        data = part.encode("utf-8")
        if not data:
            return np.empty(0, dtype=np.int32)
        cap = len(data)
        out = np.empty(cap, dtype=np.int32)
        n = self._lib.bt_encode(
            self._handle, data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        )
        if n < 0:  # cannot happen: ids never outnumber input bytes
            raise RuntimeError("encode capacity underflow")
        return out[:n]

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bt_engine_free(handle)
            self._handle = None
