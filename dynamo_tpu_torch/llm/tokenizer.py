"""Tokenizer abstraction + incremental detokenization.

A copy of the part of ``dynamo_tpu/llm/tokenizer.py`` this slice serves
(the reference's lib/llm/src/tokenizers.rs: Encoder/Decoder traits +
DecodeStream:158): the :class:`Tokenizer` interface and the dependency-free
:class:`ByteTokenizer` the ``tiny`` and ``llama3-8b-sim`` presets use. The
HuggingFace and SentencePiece tokenizers are not ported yet.

:class:`DecodeStream` implements UTF-8-safe incremental detokenization: a
token boundary is not a character boundary, so we re-decode a sliding
window and emit only the confirmed new suffix (holding back trailing
replacement chars that indicate an incomplete multi-byte sequence).
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence


class Tokenizer(abc.ABC):
    @abc.abstractmethod
    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ...

    @abc.abstractmethod
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        ...

    @property
    @abc.abstractmethod
    def eos_token_ids(self) -> list[int]:
        ...

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int:
        ...

    @property
    def bos_token_id(self) -> Optional[int]:
        return None

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True,
        tools: list | None = None,
    ) -> str:
        raise NotImplementedError("this tokenizer has no chat template")


class ByteTokenizer(Tokenizer):
    """ids 0-255 = raw bytes; 256 = BOS, 257 = EOS."""

    BOS = 256
    EOS = 257

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            ids = [self.BOS] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        """ids >= 258 (a larger model served through the byte tokenizer,
        e.g. the llama3-8b-sim bench config) decode to one printable
        ASCII char derived from the id. NOT U+FFFD: the incremental
        DecodeStream treats a trailing replacement char as an incomplete
        multibyte sequence and holds output, which would stall streaming
        for every out-of-range token."""
        out = []
        for i in ids:
            if i < 256:
                out.append(bytes([i]))
            elif i >= 258:
                out.append(bytes([33 + (i % 94)]))
        return b"".join(out).decode("utf-8", errors="replace")

    @property
    def eos_token_ids(self) -> list[int]:
        return [self.EOS]

    @property
    def bos_token_id(self) -> Optional[int]:
        return self.BOS

    @property
    def vocab_size(self) -> int:
        return 258

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True,
        tools: list | None = None,
    ) -> str:
        parts = [f"<|{m['role']}|>{m.get('content') or ''}" for m in messages]
        if tools:
            import json as _json

            parts.insert(0, f"<|tools|>{_json.dumps(tools, sort_keys=True)}")
        if add_generation_prompt:
            parts.append("<|assistant|>")
        return "".join(parts)


class DecodeStream:
    """Incremental, UTF-8-safe detokenizer (ref tokenizers.rs:158
    DecodeStream; the sliding-window scheme matches what the engines the
    reference wraps do internally)."""

    def __init__(self, tokenizer: Tokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip_special = skip_special_tokens
        self._ids: list[int] = []
        self._prefix_offset = 0  # start of the re-decode window
        self._read_offset = 0  # tokens already surfaced as text

    def step(self, token_id: int) -> Optional[str]:
        """Feed one token id; return newly-confirmed text (or None)."""
        self._ids.append(token_id)
        prefix_text = self._tok.decode(
            self._ids[self._prefix_offset : self._read_offset], self._skip_special
        )
        new_text = self._tok.decode(self._ids[self._prefix_offset :], self._skip_special)
        if len(new_text) <= len(prefix_text) or new_text.endswith("�"):
            # incomplete multi-byte sequence — hold until the next token
            return None
        delta = new_text[len(prefix_text) :]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return delta

    def flush(self) -> Optional[str]:
        """Emit whatever is still held back (end of stream)."""
        prefix_text = self._tok.decode(
            self._ids[self._prefix_offset : self._read_offset], self._skip_special
        )
        full = self._tok.decode(self._ids[self._prefix_offset :], self._skip_special)
        if len(full) > len(prefix_text):
            self._read_offset = len(self._ids)
            self._prefix_offset = self._read_offset
            return full[len(prefix_text) :]
        return None

    @property
    def token_count(self) -> int:
        return len(self._ids)
