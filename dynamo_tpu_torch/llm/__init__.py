"""LLM library layer: tokenization, preprocessing, detokenization."""

from .tokenizer import ByteTokenizer, DecodeStream, Tokenizer

__all__ = ["ByteTokenizer", "DecodeStream", "Tokenizer"]
