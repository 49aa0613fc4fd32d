"""The port's tokenizers against the JAX package's, on the repo's fixtures.

* ``tests/data/real_sp``: a real 32,000-piece SentencePiece vocab with the
  HF ``tokenizers`` engine's ids and decodes (``expected.json``);
* ``tests/data/tiny_sp``: a small SentencePiece model with special tokens
  and a chat template in ``tokenizer_config.json``;
* ``tests/data/tiny_tokenizer``: a small HF ``tokenizer.json`` checkout.

Ids, decodes, special ids, chat templates and :class:`DecodeStream`'s
pieces (partial multibyte runes held) must equal the reference's.
"""

import json
import os
import sys

import pytest

from dynamo_tpu.llm import tokenizer as jtok
from dynamo_tpu_torch.llm import tokenizer as ttok

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REAL_SP = os.path.join(DATA, "real_sp", "tinyllama.model")
SP_DIR = os.path.join(DATA, "tiny_sp")
HF_DIR = os.path.join(DATA, "tiny_tokenizer")
with open(os.path.join(DATA, "real_sp", "expected.json")) as _f:
    EXPECTED = json.load(_f)

TEXTS = ["hello world", "the quick brown fox", "  two  spaces ", "café 🦊 done",
         "日本語のテキスト", "tabs\tand\nnewlines", ""]
CHAT = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"}]
PATHS = {"real_sp": REAL_SP, "tiny_sp": SP_DIR, "tiny_hf": HF_DIR}


@pytest.fixture(scope="module")
def pairs():
    """fixture -> (port tokenizer, reference tokenizer)."""
    return {
        "real_sp": (ttok.SPTokenizer(REAL_SP), jtok.SPTokenizer(REAL_SP)),
        "tiny_sp": (ttok.SPTokenizer(SP_DIR), jtok.SPTokenizer(SP_DIR)),
        "tiny_hf": (ttok.HFTokenizer(HF_DIR), jtok.HFTokenizer(HF_DIR)),
    }


def test_real_vocab_matches_the_hf_engine(pairs):
    tok, ref = pairs["real_sp"]
    assert tok.vocab_size == 32000 and tok.bos_token_id == 1
    assert tok.eos_token_ids == ref.eos_token_ids == [2]
    for e in EXPECTED:
        assert tok.encode(e["text"]) == e["ids"] == ref.encode(e["text"]), e["text"]
        assert tok.decode(e["ids"]) == e["decoded"], e["text"]


@pytest.mark.parametrize("name", list(PATHS))
def test_ids_decodes_and_specials_match_the_reference(name, pairs):
    tok, ref = pairs[name]
    assert (tok.vocab_size, tok.bos_token_id, tok.eos_token_ids) == (
        ref.vocab_size, ref.bos_token_id, ref.eos_token_ids)
    for text in TEXTS + [e["text"] for e in EXPECTED]:
        for special in (False, True):
            ids = tok.encode(text, add_special_tokens=special)
            assert ids == ref.encode(text, add_special_tokens=special), text
            for skip in (True, False):
                assert tok.decode(ids, skip) == ref.decode(ids, skip), text


@pytest.mark.parametrize("name", ["tiny_sp", "tiny_hf"])
def test_chat_templates_match_the_reference(name, pairs):
    tok, ref = pairs[name]
    for gen in (True, False):
        out = tok.apply_chat_template(CHAT, add_generation_prompt=gen)
        assert out == ref.apply_chat_template(CHAT, add_generation_prompt=gen)
    assert tok.apply_chat_template(CHAT) == "<|system|>be brief</s><|user|>hi</s><|assistant|>"


def test_sp_without_a_template_refuses(pairs):
    tok, _ = pairs["real_sp"]
    with pytest.raises(NotImplementedError, match="chat template"):
        tok.apply_chat_template(CHAT)


@pytest.mark.parametrize("name", list(PATHS))
def test_decode_stream_matches_the_reference(name, pairs):
    """Piece for piece, with partial multibyte runes held (the emoji is not
    one token in any of the three vocabularies) and no replacement char
    surfaced; the pieces spell the plain decode."""
    tok, ref = pairs[name]
    text = "café 🦊 done, 日本"
    ids = tok.encode(text)
    streams = (ttok.DecodeStream(tok), jtok.DecodeStream(ref))
    got, want = [], []
    for tid in ids:
        got.append(streams[0].step(tid))
        want.append(streams[1].step(tid))
    got.append(streams[0].flush())
    want.append(streams[1].flush())
    assert got == want
    assert None in got[:-1], "no token was held"
    pieces = [p for p in got if p]
    assert "".join(pieces) == tok.decode(ids)
    assert all("�" not in p for p in pieces)
    assert streams[0].token_count == len(ids)


def test_load_tokenizer_policy(tmp_path):
    assert isinstance(ttok.load_tokenizer(HF_DIR), ttok.HFTokenizer)
    assert isinstance(ttok.load_tokenizer(SP_DIR), ttok.SPTokenizer)
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer(str(tmp_path))


def test_hf_tokenizer_needs_transformers(monkeypatch):
    """Where ``transformers`` is missing, a ``tokenizer.json`` checkout
    raises a plain ImportError (no fallback tokenizer); SentencePiece
    checkouts load without it."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        ttok.load_tokenizer(HF_DIR)
    assert ttok.load_tokenizer(SP_DIR).encode("hello") == \
        jtok.SPTokenizer(SP_DIR).encode("hello")
