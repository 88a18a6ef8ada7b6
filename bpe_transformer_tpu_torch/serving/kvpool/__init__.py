"""Paged KV memory for serving: the block allocator (``blocks``), the radix
prefix cache (``radix``), the paged engine (``paged_engine``) and the KV
wire codec that moves a session between engines (``migrate``)."""

from bpe_transformer_tpu_torch._lazy import lazy_attrs

__all__ = [
    "BlockAllocator",
    "NoFreeBlocksError",
    "PagedEngine",
    "PagedSlotInfo",
    "RadixPrefixCache",
    "payload_from_bytes",
    "payload_nbytes",
    "payload_to_bytes",
    "synthetic_decode_payload",
]

# Lazy: the wire codec (``migrate``) imports without torch.
__getattr__ = lazy_attrs(__name__, {
    "BlockAllocator": "blocks",
    "NoFreeBlocksError": "blocks",
    "PagedEngine": "paged_engine",
    "PagedSlotInfo": "paged_engine",
    "RadixPrefixCache": "radix",
    "payload_from_bytes": "migrate",
    "payload_nbytes": "migrate",
    "payload_to_bytes": "migrate",
    "synthetic_decode_payload": "migrate",
})
