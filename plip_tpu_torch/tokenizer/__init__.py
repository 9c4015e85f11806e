from .bpe import (
    CLIPBPETokenizer,
    DEFAULT_CONTEXT_LENGTH,
    EOT_TOKEN,
    SOT_TOKEN,
    bytes_to_unicode,
)
from .vocab import (
    CLIP_VOCAB_SIZE,
    default_tokenizer,
    load_hf_vocab,
    load_openai_bpe,
    save_hf_format,
    save_openai_format,
    synthetic_vocab,
    train_bpe,
    vocab_from_merges,
)

__all__ = [
    "CLIPBPETokenizer",
    "DEFAULT_CONTEXT_LENGTH",
    "EOT_TOKEN",
    "SOT_TOKEN",
    "CLIP_VOCAB_SIZE",
    "bytes_to_unicode",
    "default_tokenizer",
    "load_hf_vocab",
    "load_openai_bpe",
    "save_hf_format",
    "save_openai_format",
    "synthetic_vocab",
    "train_bpe",
    "vocab_from_merges",
]
