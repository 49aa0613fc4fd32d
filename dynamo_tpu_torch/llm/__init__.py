"""LLM library layer: tokenization, preprocessing, detokenization."""

from .tokenizer import (
    ByteTokenizer,
    DecodeStream,
    HFTokenizer,
    SPTokenizer,
    Tokenizer,
    load_tokenizer,
)

__all__ = ["ByteTokenizer", "DecodeStream", "HFTokenizer", "SPTokenizer",
           "Tokenizer", "load_tokenizer"]
