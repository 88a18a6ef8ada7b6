"""Paged KV memory for serving: the block allocator (``blocks``), the radix
prefix cache (``radix``) and the paged engine (``paged_engine``)."""

from bpe_transformer_tpu_torch.serving.kvpool.blocks import BlockAllocator, NoFreeBlocksError
from bpe_transformer_tpu_torch.serving.kvpool.paged_engine import PagedEngine, PagedSlotInfo
from bpe_transformer_tpu_torch.serving.kvpool.radix import RadixPrefixCache

__all__ = [
    "BlockAllocator",
    "NoFreeBlocksError",
    "PagedEngine",
    "PagedSlotInfo",
    "RadixPrefixCache",
]
