"""Host-side tokenization stack (the port's copy of
``bpe_transformer_tpu/tokenization``): pre-tokenization without ``regex``,
BPE training, encoding."""

from bpe_transformer_tpu_torch.tokenization.pretokenization import (
    count_pretokens,
    find_chunk_boundaries,
    iter_pretoken_strings,
    parallel_pretokenization,
    pretokenize,
    pretokenize_text,
    serial_pretokenization,
    split_on_special_tokens,
)
from bpe_transformer_tpu_torch.tokenization.tokenizer import BPETokenizer, Tokenizer
from bpe_transformer_tpu_torch.tokenization.trainer import BPETrainer, train_bpe

__all__ = [
    "BPETokenizer",
    "BPETrainer",
    "Tokenizer",
    "count_pretokens",
    "find_chunk_boundaries",
    "iter_pretoken_strings",
    "parallel_pretokenization",
    "pretokenize",
    "pretokenize_text",
    "serial_pretokenization",
    "split_on_special_tokens",
    "train_bpe",
]
