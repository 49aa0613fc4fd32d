"""Backend stage: incremental detokenization + stop-sequence jail.

Re-design of the reference's Backend (lib/llm/src/backend.rs:62-126): a
bidirectional pipeline operator between the preprocessor and the engine.
Forward: annotate the request with the tokenizer's eos ids. Backward (per
token, the hot path): incrementally decode token ids to text, "jail" any
emitted tail that could be the prefix of a stop sequence until it either
matches (finish with reason=stop, truncated at the match) or diverges
(release the held text) — the reference uses toktrie for the same purpose.
"""

from __future__ import annotations

from typing import AsyncIterator

from ..protocols.common import FinishReason, LLMEngineOutput, PreprocessedRequest
from ..runtime.annotated import Annotated
from ..runtime.engine import AsyncEngine, Context
from ..runtime.pipeline import Operator
from .tokenizer import DecodeStream, Tokenizer


class StopJail:
    """Holds back text that may be the start of a stop sequence."""

    def __init__(self, stops: list[str]):
        self._stops = [s for s in stops if s]
        self._held = ""

    def push(self, text: str) -> tuple[str, bool]:
        """Feed decoded text; returns (text_to_emit, hit_stop)."""
        if not self._stops:
            return text, False
        buf = self._held + text
        # full match anywhere in the buffer?
        cut = -1
        for s in self._stops:
            idx = buf.find(s)
            if idx != -1 and (cut == -1 or idx < cut):
                cut = idx
        if cut != -1:
            self._held = ""
            return buf[:cut], True
        # hold the longest tail that is a proper prefix of some stop string
        hold = 0
        for s in self._stops:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            self._held = buf[-hold:]
            return buf[:-hold], False
        self._held = ""
        return buf, False

    def flush(self) -> str:
        held, self._held = self._held, ""
        return held


class Backend(Operator):
    """Detokenizer stage (Context[PreprocessedRequest] ->
    Annotated[LLMEngineOutput] with .text filled in)."""

    def __init__(self, tokenizer: Tokenizer):
        self._tokenizer = tokenizer

    async def generate(
        self, request: Context, next_engine: AsyncEngine
    ) -> AsyncIterator[Annotated]:
        req: PreprocessedRequest = request.data
        if not req.eos_token_ids:
            req.eos_token_ids = self._tokenizer.eos_token_ids
        decoder = DecodeStream(self._tokenizer, skip_special_tokens=True)
        jail = StopJail(req.stop_conditions.stop)
        finished = False
        async for item in next_engine.generate(request):
            if finished:
                break
            if not isinstance(item, Annotated):
                item = Annotated.from_data(item)
            if item.data is None:
                yield item
                continue
            out: LLMEngineOutput = (
                item.data
                if isinstance(item.data, LLMEngineOutput)
                else LLMEngineOutput.from_dict(item.data)
            )
            text_parts = []
            pieces = []  # per-token INCREMENTAL text (may be "")
            for tid in out.token_ids:
                piece = decoder.step(tid)
                pieces.append(piece or "")
                if piece is not None:
                    text_parts.append(piece)
            if out.logprobs:
                # enrich id-level entries with token text (the engine
                # emits ids + floats; OpenAI responses carry strings).
                # The chosen token's text is the INCREMENTAL decode piece
                # — isolated decode of a byte-level BPE piece yields
                # U+FFFD and would drift text_offset off the streamed
                # text; an incomplete multibyte prefix contributes ""
                # and the completing token carries the full char.
                for tid, piece, entry in zip(
                    out.token_ids, pieces, out.logprobs
                ):
                    entry["token"] = piece
                    entry["top"] = [
                        {
                            "token": self._tokenizer.decode([i]),
                            "logprob": lp,
                        }
                        for i, lp in entry.get("top", [])
                    ]
            if out.is_final():
                tail = decoder.flush()
                if tail:
                    text_parts.append(tail)
            text = "".join(text_parts)
            emit, hit_stop = jail.push(text) if text else ("", False)
            if hit_stop:
                out.finish_reason = FinishReason.STOP
                finished = True
                # propagate upstream so a remote engine stops generating
                # instead of running to max_tokens into a dead stream
                request.context.stop_generating()
            if out.is_final() and not hit_stop:
                emit += jail.flush()
            out.text = emit
            yield Annotated(data=out, event=item.event, comment=item.comment, id=item.id)
            if out.is_final():
                finished = True
