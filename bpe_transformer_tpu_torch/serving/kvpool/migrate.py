"""KV-slot migration payloads (the port's copy of
``bpe_transformer_tpu/serving/kvpool/migrate.py``): the self-describing wire
format that moves one in-flight generation between replicas.

A payload is everything another replica needs to continue a generation: the
slot's *geometry* (block size, pool dtype, model KV shape, validated by the
importing engine before any block is allocated), its *KV rows* (the written
pool blocks; int8 pools ship their per-block-per-head scale rows beside
them), and its *state machine* (prompt, prefill frontier for mid-prefill
migrations, or the decode state: pending token, position, sampling knobs and
RNG state).  ``PagedEngine.export_slot`` builds one and
``PagedEngine.import_slot`` grafts one; this module owns the host-side dict
<-> bytes codec that the HTTP transport (``/kv/export`` -> ``/kv/import``),
the router and in-process drain evacuation share.

The byte format is the JAX package's, byte for byte: magic, an 8-byte
little-endian header length, a JSON header, then the raw little-endian array
bytes, so a port replica and a JAX replica graft each other's KV.  Version 2
(``BPEKV002``) carries a CRC32 over the (uncompressed) array section and a
codec flag (``zstd`` when the extension is importable, ``zlib`` from the
standard library, else ``raw``), negotiated per transfer through an accept
list (the ``X-KV-Accept`` header on ``/kv/export``).  A bit-flipped or
truncated body fails the CRC or a length check with ``ValueError``, which
the transport answers with a 400.  Version-1 frames (no CRC, no
compression) still decode.

**bfloat16 without ml_dtypes.**  numpy has no bfloat16; the JAX package
reads such rows through the ``ml_dtypes`` extension, which a host with only
numpy and torch lacks.  The port writes bf16 arrays under the dtype string
``"bfloat16"`` exactly as JAX does, and reads them back as their uint16 bit
patterns in a :class:`BFloat16Bits` array (an ``ndarray`` subclass that
remembers the wire dtype); the engine reinterprets those bits as
``torch.bfloat16`` on import.  :func:`wire_dtype` names an array's wire
dtype whichever way it is held (numpy, ml_dtypes or :class:`BFloat16Bits`).

The module imports numpy and the standard library only: the router and the
front-end tools size and forward payloads on hosts without torch.
"""

from __future__ import annotations

import json
import zlib

import numpy as np

try:  # optional: the container may not ship python-zstandard; zlib is
    # the guaranteed stdlib fallback so negotiation always has a codec.
    import zstandard as _zstd  # type: ignore
except ImportError:
    _zstd = None

__all__ = [
    "BFloat16Bits",
    "PAYLOAD_MAGIC",
    "PAYLOAD_MAGIC_V1",
    "HAVE_ZSTD",
    "negotiate_codec",
    "supported_codecs",
    "payload_to_bytes",
    "payload_from_bytes",
    "payload_nbytes",
    "synthetic_decode_payload",
    "wire_dtype",
]

#: Format magic + version.  Bump the digits on any incompatible layout
#: change — import refuses unknown versions instead of misreading rows.
PAYLOAD_MAGIC = b"BPEKV002"
#: The version-1 format: no CRC, no compression.  Still decoded (legacy).
PAYLOAD_MAGIC_V1 = b"BPEKV001"

HAVE_ZSTD = _zstd is not None

#: Codecs this host can encode/decode, best first.
_CODECS = (("zstd",) if HAVE_ZSTD else ()) + ("zlib", "raw")

#: The wire name of bfloat16 rows (numpy has no such dtype).
BF16 = "bfloat16"


class BFloat16Bits(np.ndarray):
    """bfloat16 values held as their uint16 bit patterns: what a bf16 array
    of a payload is on a host without ``ml_dtypes``.  Its wire dtype is
    ``"bfloat16"`` and its bytes are the bf16 bytes."""

    wire_dtype = BF16


def wire_dtype(arr) -> str:
    """The dtype string a payload array travels under: numpy's name, or
    ``"bfloat16"`` for a :class:`BFloat16Bits` array (an ``ml_dtypes``
    bfloat16 array names itself so already)."""
    return getattr(arr, "wire_dtype", None) or str(np.asarray(arr).dtype)


def bf16_bits(bits) -> "BFloat16Bits":
    """View a uint16/int16 array of bf16 bit patterns as :class:`BFloat16Bits`."""
    return np.ascontiguousarray(bits).view(np.uint16).view(BFloat16Bits)


def supported_codecs() -> tuple[str, ...]:
    """Codecs this host can decode, best first — what a replica
    advertises (statusz ``kv_accept``) and sends as ``X-KV-Accept``."""
    return _CODECS


def negotiate_codec(accept: str | None) -> str:
    """Pick the best locally available codec from a comma-separated accept
    list (e.g. the ``X-KV-Accept`` request header on ``/kv/export``).
    ``None``/empty means the peer predates negotiation — send ``raw`` so a
    v1-era importer is never handed a frame it cannot open."""
    if not accept:
        return "raw"
    offered = {tok.strip().lower() for tok in accept.split(",") if tok.strip()}
    for codec in _CODECS:
        if codec in offered:
            return codec
    return "raw"


def _compress(codec: str, data: bytes) -> bytes:
    if codec == "raw":
        return data
    if codec == "zlib":
        return zlib.compress(data, 1)
    if codec == "zstd":
        if _zstd is None:
            raise ValueError("zstd codec requested but zstandard not installed")
        return _zstd.ZstdCompressor(level=3).compress(data)
    raise ValueError(f"unknown KV payload codec {codec!r}")


def _decompress(codec: str, data: bytes, raw_nbytes: int) -> bytes:
    try:
        if codec == "raw":
            return data
        if codec == "zlib":
            return zlib.decompress(data)
        if codec == "zstd":
            if _zstd is None:
                raise ValueError(
                    "KV payload uses zstd but zstandard is not installed here"
                )
            return _zstd.ZstdDecompressor().decompress(
                data, max_output_size=raw_nbytes
            )
    except (zlib.error, MemoryError) as exc:
        raise ValueError(f"corrupt KV payload body ({codec}): {exc}") from None
    except Exception as exc:  # zstd errors are extension-specific types
        if codec == "zstd":
            raise ValueError(
                f"corrupt KV payload body (zstd): {exc}"
            ) from None
        raise
    raise ValueError(f"unknown KV payload codec {codec!r}")


def payload_to_bytes(payload: dict, *, codec: str = "raw") -> bytes:
    """Serialize an ``export_slot`` payload: magic, an 8-byte little-endian
    header length, the JSON header (meta + array manifest + codec +
    CRC32), then the array section — each array's raw bytes in manifest
    order, compressed as one frame when ``codec`` is not ``"raw"``."""
    meta = payload["meta"]
    manifest: list[dict] = []
    chunks: list[bytes] = []
    for i, layer in enumerate(payload["layers"]):
        for name in sorted(layer):
            arr = layer[name]
            manifest.append(
                {
                    "key": f"L{i}/{name}",
                    "dtype": wire_dtype(arr),
                    "shape": list(arr.shape),
                }
            )
            chunks.append(np.ascontiguousarray(arr).tobytes())
    raw = b"".join(chunks)
    body = _compress(codec, raw)
    header = json.dumps(
        {
            "meta": meta,
            "arrays": manifest,
            "codec": codec,
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
            "raw_nbytes": len(raw),
            "body_nbytes": len(body),
        },
        separators=(",", ":"),
    ).encode("utf-8")
    return b"".join(
        [PAYLOAD_MAGIC, len(header).to_bytes(8, "little"), header, body]
    )


def payload_from_bytes(data: bytes) -> dict:
    """Decode :func:`payload_to_bytes` output back into the payload dict.
    Accepts v2 (CRC-checked, optionally compressed) and legacy v1 frames.
    Raises ``ValueError`` on a bad magic, version, truncated body, CRC
    mismatch, or undecodable compression frame — loudly, so the transport
    can 400 instead of grafting garbage KV."""
    if not data.startswith(PAYLOAD_MAGIC[:5]):
        raise ValueError("not a KV migration payload (bad magic)")
    version_2 = data.startswith(PAYLOAD_MAGIC)
    if not version_2 and not data.startswith(PAYLOAD_MAGIC_V1):
        raise ValueError(
            f"unsupported KV payload version {data[:8]!r} "
            f"(expected {PAYLOAD_MAGIC!r} or {PAYLOAD_MAGIC_V1!r})"
        )
    off = len(PAYLOAD_MAGIC)
    if len(data) < off + 8:
        raise ValueError("truncated KV payload (no header length)")
    hlen = int.from_bytes(data[off: off + 8], "little")
    off += 8
    if len(data) < off + hlen:
        raise ValueError("truncated KV payload (header)")
    try:
        header = json.loads(data[off: off + hlen])
    except json.JSONDecodeError as exc:
        raise ValueError(f"corrupt KV payload header: {exc}") from None
    off += hlen
    meta = header["meta"]
    if version_2:
        codec = header.get("codec", "raw")
        body_nbytes = int(header.get("body_nbytes", len(data) - off))
        if len(data) < off + body_nbytes:
            raise ValueError(
                f"truncated KV payload (body: have {len(data) - off} of "
                f"{body_nbytes} bytes)"
            )
        raw = _decompress(
            codec, data[off: off + body_nbytes],
            int(header.get("raw_nbytes", 1 << 31)),
        )
        want_crc = int(header["crc32"]) & 0xFFFFFFFF
        got_crc = zlib.crc32(raw) & 0xFFFFFFFF
        if got_crc != want_crc:
            raise ValueError(
                f"KV payload CRC mismatch (header {want_crc:#010x}, "
                f"body {got_crc:#010x}) — refusing to graft corrupt KV"
            )
        section, sec_off = raw, 0
    else:
        section, sec_off = data, off
    layers: list[dict] = [{} for _ in range(int(meta["num_layers"]))]
    for spec in header["arrays"]:
        bf16 = spec["dtype"] == BF16
        dtype = np.dtype(np.uint16) if bf16 else np.dtype(spec["dtype"])
        shape = tuple(int(d) for d in spec["shape"])
        nbytes = dtype.itemsize * int(np.prod(shape)) if shape else dtype.itemsize
        if len(section) < sec_off + nbytes:
            raise ValueError(
                f"truncated KV payload (array {spec['key']})"
            )
        arr = np.frombuffer(
            section, dtype=dtype, count=int(np.prod(shape)), offset=sec_off,
        ).reshape(shape)
        if bf16:
            arr = arr.view(BFloat16Bits)
        sec_off += nbytes
        layer_idx, name = spec["key"].split("/", 1)
        idx = int(layer_idx[1:])
        if not 0 <= idx < len(layers):
            raise ValueError(
                f"corrupt KV payload: array {spec['key']!r} names layer "
                f"{idx} of {len(layers)}"
            )
        layers[idx][name] = arr
    return {"meta": meta, "layers": layers}


def payload_nbytes(payload: dict) -> int:
    """Raw KV bytes a payload carries (rows + scales, header excluded):
    the transfer-size gauge the migration telemetry reports."""
    return sum(
        int(np.asarray(arr).nbytes)
        for layer in payload["layers"]
        for arr in layer.values()
    )


def synthetic_decode_payload(
    config,
    *,
    block_size: int,
    kv_dtype: str,
    prompt_len: int = 8,
    max_new_tokens: int = 3,
    seed: int = 0,
) -> dict:
    """A zero-KV decode-state payload shaped for ``import_slot``: a graft
    that exercises a decode-role replica's tick and import path without
    running any prefill chunk (the rows are zeros).

    ``config`` is duck-typed (any object with ``num_layers`` /
    ``num_heads`` / ``num_kv_heads`` / ``d_head`` / ``context_length``);
    ``kv_dtype`` is the pool label, ``"int8"`` or the activation dtype
    name, exactly as ``PagedEngine.kv_dtype`` reports it.
    """
    kv_heads = config.num_kv_heads or config.num_heads
    span = min(prompt_len + max_new_tokens, config.context_length)
    n_blocks = -(-span // block_size)
    shape = (n_blocks, kv_heads, block_size, config.d_head)

    def zeros():
        if kv_dtype == BF16:
            return bf16_bits(np.zeros(shape, np.uint16))
        return np.zeros(shape, np.dtype(kv_dtype))

    layers = []
    for _ in range(config.num_layers):
        layer = {"k": zeros(), "v": zeros()}
        if kv_dtype == "int8":
            layer["k_scale"] = np.zeros((n_blocks, kv_heads), np.float32)
            layer["v_scale"] = np.zeros((n_blocks, kv_heads), np.float32)
        layers.append(layer)
    prompt = [1] * prompt_len
    meta = {
        "format": 1,
        "block_size": block_size,
        "kv_dtype": kv_dtype,
        "num_layers": config.num_layers,
        "kv_heads": kv_heads,
        "d_head": config.d_head,
        "context_length": config.context_length,
        "n_blocks": n_blocks,
        "prompt": prompt,
        "prompt_len": prompt_len,
        "next_pos": prompt_len,
        "decoding": True,
        "generated": 1,
        "max_new_tokens": max_new_tokens,
        "stop_id": None,
        "seed": seed,
        "temperature": 0.0,
        "top_k": 0,
        "top_p": 2.0,
        "token": 1,
        "position": prompt_len,
        # PRNGKey(seed) for small seeds is [seed >> 32, seed & 0xffffffff].
        "key": [seed >> 32, seed & 0xFFFFFFFF],
        "request_id": None,
        "emitted": [1],
        "history": prompt + [1],
    }
    return {"meta": meta, "layers": layers}
