"""Token files and batch sampling (the port's own copy of the numpy parts of
``bpe_transformer_tpu/data``)."""

from bpe_transformer_tpu_torch.data.dataset import (
    BatchLoader,
    BatchPrefetcher,
    check_dataset_geometry,
    get_batch,
    load_token_file,
    tokenize_to_memmap,
)

__all__ = ["BatchLoader", "BatchPrefetcher", "check_dataset_geometry", "get_batch",
           "load_token_file", "tokenize_to_memmap"]
