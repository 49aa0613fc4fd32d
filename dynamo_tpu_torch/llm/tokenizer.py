"""Tokenizer abstraction + incremental detokenization.

A copy of ``dynamo_tpu/llm/tokenizer.py`` (the reference's
lib/llm/src/tokenizers.rs: Encoder/Decoder traits + DecodeStream:158):

  * :class:`ByteTokenizer`: dependency-free bytes, for the ``*-sim``
    presets' random weights;
  * :class:`SPTokenizer`: a checkpoint's ``tokenizer.model`` through the
    pure-Python reader of :mod:`.sp_model` (no ``sentencepiece``);
  * :class:`HFTokenizer`: a checkpoint's ``tokenizer.json`` through
    ``transformers``, imported when one is built;
  * :func:`load_tokenizer`: the checkpoint directory's policy.

Chat templates render through ``jinja2``, imported when one renders.

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


class HFTokenizer(Tokenizer):
    """HuggingFace tokenizer from a local checkout (tokenizer.json /
    tokenizer_config.json), ref tokenizers/hf.rs:23."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        eos = self._tok.eos_token_id
        self._eos_ids = [eos] if eos is not None else []
        # llama-3 style: some models define extra end-of-turn tokens
        for name in ("<|eot_id|>", "<|im_end|>", "<|end|>"):
            tid = self._tok.convert_tokens_to_ids(name)
            if tid is not None and tid >= 0 and tid not in self._eos_ids:
                unk = getattr(self._tok, "unk_token_id", None)
                if tid != unk:
                    self._eos_ids.append(tid)

    @property
    def hf(self):
        return self._tok

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    @property
    def eos_token_ids(self) -> list[int]:
        return list(self._eos_ids)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._tok.bos_token_id

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True,
        tools: list | None = None,
    ) -> str:
        # tools flow into the jinja context — function-calling templates
        # (llama-3.1, qwen, mistral v3...) render the tool schemas into
        # the system prompt (ref: the engines the reference wraps pass
        # request.tools through the same HF API)
        return self._tok.apply_chat_template(
            messages, tokenize=False,
            add_generation_prompt=add_generation_prompt,
            tools=tools or None,
        )


class SPTokenizer(Tokenizer):
    """SentencePiece tokenizer from a checkpoint's ``tokenizer.model``
    (ref lib/llm/src/tokenizers/sp.rs:25) — for checkpoints that ship no
    ``tokenizer.json``. Backed by the in-repo model reader/segmenters
    (:mod:`.sp_model`; the sentencepiece wheel is not in this image).

    Special ids follow the checkpoint: ``tokenizer_config.json`` /
    ``special_tokens_map.json`` overrides win when present; otherwise
    the conventional ``<s>``/``</s>`` control pieces are used. A
    ``chat_template`` found in ``tokenizer_config.json`` renders via
    jinja2 (the same engine transformers uses)."""

    def __init__(self, path: str):
        import json
        import os

        model_file = (
            os.path.join(path, "tokenizer.model")
            if os.path.isdir(path) else path
        )
        from .sp_model import CONTROL, SentencePieceModel

        self._sp = SentencePieceModel.load(model_file)
        self._piece_id = {
            p.text: i for i, p in enumerate(self._sp.pieces)
        }
        self._chat_template = None
        self._bos_id = self._piece_id.get("<s>")
        self._eos_ids = [
            i for i, p in enumerate(self._sp.pieces)
            if p.type == CONTROL and p.text in ("</s>", "<|endoftext|>")
        ]
        cfg_dir = path if os.path.isdir(path) else os.path.dirname(path)
        for fname in ("special_tokens_map.json", "tokenizer_config.json"):
            try:
                with open(os.path.join(cfg_dir, fname)) as f:
                    cfg = json.load(f)
            except (OSError, ValueError):
                continue
            bos, eos = cfg.get("bos_token"), cfg.get("eos_token")
            if isinstance(bos, dict):
                bos = bos.get("content")
            if isinstance(eos, dict):
                eos = eos.get("content")
            if bos in self._piece_id:
                self._bos_id = self._piece_id[bos]
            if eos in self._piece_id:
                self._eos_ids = [self._piece_id[eos]]
            if cfg.get("chat_template"):
                self._chat_template = cfg["chat_template"]

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids = self._sp.encode(text)
        if add_special_tokens and self._bos_id is not None:
            ids = [self._bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._sp.decode(ids, skip_special=skip_special_tokens)

    @property
    def eos_token_ids(self) -> list[int]:
        return list(self._eos_ids)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._bos_id

    @property
    def vocab_size(self) -> int:
        return len(self._sp.pieces)

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True,
        tools: list | None = None,
    ) -> str:
        if not self._chat_template:
            raise NotImplementedError("checkpoint has no chat template")
        import jinja2

        env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
        bos = self._sp.pieces[self._bos_id].text if self._bos_id is not None else ""
        eos = self._sp.pieces[self._eos_ids[0]].text if self._eos_ids else ""
        return env.from_string(self._chat_template).render(
            messages=messages, add_generation_prompt=add_generation_prompt,
            tools=tools or None, bos_token=bos, eos_token=eos,
        )


def load_tokenizer(path: str) -> Tokenizer:
    """The checkpoint-dir tokenizer policy (one place): ``tokenizer.json``
    → :class:`HFTokenizer` (fast path), else ``tokenizer.model`` →
    :class:`SPTokenizer`. The reference factories pick hf.rs vs sp.rs by
    the same file probe (lib/llm/src/tokenizers.rs)."""
    import os

    if os.path.exists(os.path.join(path, "tokenizer.json")):
        return HFTokenizer(path)
    if os.path.exists(os.path.join(path, "tokenizer.model")):
        return SPTokenizer(path)
    raise FileNotFoundError(
        f"no tokenizer.json or tokenizer.model under {path!r}"
    )


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
