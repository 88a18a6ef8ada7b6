"""Token files and batch sampling (the port's own copy of the numpy parts of
``bpe_transformer_tpu/data``)."""

from bpe_transformer_tpu_torch.data.dataset import (
    BatchLoader,
    check_dataset_geometry,
    get_batch,
    load_token_file,
)

__all__ = ["BatchLoader", "check_dataset_geometry", "get_batch", "load_token_file"]
