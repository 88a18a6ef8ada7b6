"""Paged KV memory for serving: the block allocator (``blocks``), the radix
prefix cache (``radix``) and the paged engine (``paged_engine``)."""

from bpe_transformer_tpu_torch._lazy import lazy_attrs

__all__ = [
    "BlockAllocator",
    "NoFreeBlocksError",
    "PagedEngine",
    "PagedSlotInfo",
    "RadixPrefixCache",
]

# Lazy: the wire codec (``migrate``) imports without torch.
__getattr__ = lazy_attrs(__name__, {
    "BlockAllocator": "blocks",
    "NoFreeBlocksError": "blocks",
    "PagedEngine": "paged_engine",
    "PagedSlotInfo": "paged_engine",
    "RadixPrefixCache": "radix",
})
