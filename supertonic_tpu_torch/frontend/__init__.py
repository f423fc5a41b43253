from .chunker import chunk_text, max_len_for_lang, split_sentences
from .normalize import (
    UnicodeProcessor,
    build_default_indexer,
    get_latent_mask,
    length_to_mask,
    preprocess_text,
)

__all__ = [
    "UnicodeProcessor",
    "build_default_indexer",
    "chunk_text",
    "get_latent_mask",
    "length_to_mask",
    "max_len_for_lang",
    "preprocess_text",
    "split_sentences",
]
