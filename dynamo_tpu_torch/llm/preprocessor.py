"""OpenAI preprocessor: template rendering + tokenization + delta generation.

A copy of ``dynamo_tpu/llm/preprocessor.py`` with the tracing hooks
removed.

Re-design of the reference's OpenAIPreprocessor (lib/llm/src/
preprocessor.rs:63-103 + protocols/openai/chat_completions/delta.rs): a
bidirectional operator. Forward: render the chat template (the model's
jinja2 template via the HF tokenizer, ref preprocessor/prompt/template/*),
tokenize, and extract stop/sampling options into a PreprocessedRequest.
Backward: turn detokenized LLMEngineOutputs into OpenAI
chat.completion.chunk / text_completion deltas, including the requested
``nvext.annotations`` (formatted_prompt, token_ids) as SSE events.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional, Union

from ..protocols.common import LLMEngineOutput, PreprocessedRequest
from ..protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    Usage,
    chat_chunk,
    completion_chunk,
    new_chat_id,
    new_cmpl_id,
)
from ..runtime.annotated import Annotated
from ..runtime.engine import AsyncEngine, Context
from ..runtime.pipeline import Operator
from .tokenizer import Tokenizer

ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"


class OpenAIPreprocessor(Operator):
    def __init__(self, tokenizer: Tokenizer):
        self._tokenizer = tokenizer

    # ---- forward ----
    def preprocess_chat(self, req: ChatCompletionRequest) -> tuple[PreprocessedRequest, str]:
        if req.nvext.use_raw_prompt and len(req.messages) == 1:
            prompt = req.messages[-1].content_text()
        else:
            prompt = self._tokenizer.apply_chat_template(
                [m.to_dict() for m in req.messages], add_generation_prompt=True,
                tools=req.tools,
            )
        token_ids = self._tokenizer.encode(prompt, add_special_tokens=False)
        pre = PreprocessedRequest(
            token_ids=token_ids,
            stop_conditions=req.stops,
            sampling_options=req.sampling,
            model=req.model,
            eos_token_ids=self._tokenizer.eos_token_ids,
            # text-level engines (pystr) consume the rendered prompt; the
            # reference's PreprocessedRequest carries it the same way
            annotations={ANNOTATION_FORMATTED_PROMPT: prompt},
        )
        return pre, prompt

    def preprocess_completion(self, req: CompletionRequest) -> tuple[PreprocessedRequest, str]:
        if isinstance(req.prompt, list) and req.prompt and isinstance(req.prompt[0], int):
            token_ids = list(req.prompt)
            prompt = self._tokenizer.decode(token_ids)
        else:
            prompt = req.prompt
            token_ids = self._tokenizer.encode(prompt, add_special_tokens=True)
        pre = PreprocessedRequest(
            token_ids=token_ids,
            stop_conditions=req.stops,
            sampling_options=req.sampling,
            model=req.model,
            eos_token_ids=self._tokenizer.eos_token_ids,
            annotations={ANNOTATION_FORMATTED_PROMPT: prompt},
        )
        return pre, prompt

    # ---- the operator ----
    async def generate(
        self, request: Context, next_engine: AsyncEngine
    ) -> AsyncIterator[Annotated]:
        req: Union[ChatCompletionRequest, CompletionRequest] = request.data
        is_chat = isinstance(req, ChatCompletionRequest)
        if is_chat:
            pre, prompt = self.preprocess_chat(req)
        else:
            pre, prompt = self.preprocess_completion(req)

        # requested annotations ride the stream as events (ref nvext.rs)
        for ann in req.nvext.annotations:
            if ann == ANNOTATION_FORMATTED_PROMPT:
                yield Annotated.from_annotation(ANNOTATION_FORMATTED_PROMPT, prompt)
            elif ann == ANNOTATION_TOKEN_IDS:
                yield Annotated.from_annotation(ANNOTATION_TOKEN_IDS, pre.token_ids)

        n = getattr(req.sampling, "n", 1) or 1
        if n > 1:
            async for item in self._generate_n(
                request, next_engine, req, pre, is_chat, n
            ):
                yield item
            return

        delta = DeltaGenerator(req, is_chat=is_chat, prompt_tokens=len(pre.token_ids))
        first = True
        async for item in next_engine.generate(request.transfer(pre)):
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
            for chunk in delta.chunks(out, include_role=first):
                yield Annotated(data=chunk, id=item.id)
            first = False
            if out.is_final():
                break


    async def _generate_n(
        self, request: Context, next_engine: AsyncEngine, req, pre,
        is_chat: bool, n: int,
    ) -> AsyncIterator[Annotated]:
        """OpenAI ``n > 1``: fan the request out as n concurrent engine
        sub-streams (per-choice seeds so sampled choices differ; each
        sub-stream gets its own detokenizer state downstream), multiplex
        their chunks under one response id with per-choice indexes, and
        emit one summed usage on the final chunk."""
        import asyncio
        import dataclasses

        delta_id = new_chat_id() if is_chat else new_cmpl_id()
        queue: asyncio.Queue = asyncio.Queue()
        prompt_tokens = len(pre.token_ids)
        completion_total = 0
        # choice 0's prompt blocks are committed to the prefix cache the
        # moment its first token emits; siblings admitted AFTER that point
        # prefix-hit instead of racing n identical prefills through the
        # engine
        first_token_evt = asyncio.Event()

        async def run_choice(i: int) -> None:
            so = dataclasses.replace(
                pre.sampling_options,
                n=1,
                seed=((pre.sampling_options.seed or 0) + i * 1_000_003)
                & 0x7FFFFFFF,
            )
            sub = dataclasses.replace(pre, sampling_options=so)
            delta = DeltaGenerator(
                req, is_chat=is_chat, prompt_tokens=prompt_tokens,
                id=delta_id, index=i, with_usage=False,
            )
            first = True
            try:
                async for item in next_engine.generate(request.transfer(sub)):
                    if not isinstance(item, Annotated):
                        item = Annotated.from_data(item)
                    if item.is_error():
                        queue.put_nowait(("err", item.error or "engine error", 0))
                        return
                    if item.data is None:
                        queue.put_nowait(("item", item, 0))
                        continue
                    out = (
                        item.data
                        if isinstance(item.data, LLMEngineOutput)
                        else LLMEngineOutput.from_dict(item.data)
                    )
                    for chunk in delta.chunks(out, include_role=first):
                        queue.put_nowait(
                            ("item", Annotated(data=chunk, id=item.id), 0)
                        )
                    if i == 0 and out.token_ids:
                        first_token_evt.set()
                    first = False
                    if out.is_final():
                        break
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — a dead choice must not
                # masquerade as a completed one
                first_token_evt.set()  # never strand the sibling launcher
                queue.put_nowait(("err", f"{type(e).__name__}: {e}", 0))
                return
            if i == 0:
                first_token_evt.set()  # zero-token finishes included
            queue.put_nowait(("done", None, delta.completion_tokens))

        loop = asyncio.get_running_loop()
        tasks = [loop.create_task(run_choice(0))]

        async def launch_siblings() -> None:
            await first_token_evt.wait()
            tasks.extend(loop.create_task(run_choice(i)) for i in range(1, n))

        launcher = loop.create_task(launch_siblings())
        try:
            done = 0
            while done < n:
                kind, item, toks = await queue.get()
                if kind == "err":
                    # fail the whole request, matching the n=1 path
                    yield Annotated.from_error(item)
                    return
                if kind == "done":
                    done += 1
                    completion_total += toks
                else:
                    yield item
        finally:
            launcher.cancel()
            for t in tasks:
                t.cancel()
        usage = Usage(
            prompt_tokens=prompt_tokens, completion_tokens=completion_total
        )
        from ..protocols.openai import _now

        yield Annotated(
            data={
                "id": delta_id,
                "object": "chat.completion.chunk" if is_chat
                else "text_completion",
                "created": _now(),
                "model": req.model,
                "choices": [],
                "usage": usage.to_dict(),
            }
        )


class DeltaGenerator:
    """LLMEngineOutput -> OpenAI chunk dicts (ref chat_completions/delta.rs:215)."""

    def __init__(self, req, is_chat: bool, prompt_tokens: int,
                 id: Optional[str] = None, index: int = 0,
                 with_usage: bool = True):
        self.req = req
        self.is_chat = is_chat
        self.id = id or (new_chat_id() if is_chat else new_cmpl_id())
        self.index = index
        self.with_usage = with_usage
        self.prompt_tokens = prompt_tokens
        self.completion_tokens = 0
        # running character offset of emitted logprob tokens in the
        # generated text (legacy completions text_offset field)
        self._lp_text_offset = 0

    def chunks(self, out: LLMEngineOutput, include_role: bool = False) -> list[dict]:
        self.completion_tokens += len(out.token_ids)
        result: list[dict] = []
        text = out.text or ""
        finish = out.finish_reason.to_openai() if out.finish_reason else None
        # usage always rides the final chunk; the HTTP layer strips it for
        # streaming clients that did not ask for include_usage, and the
        # aggregator folds it into non-streaming responses (OpenAI-required)
        usage = None
        if finish is not None and self.with_usage:
            usage = Usage(
                prompt_tokens=out.prompt_tokens or self.prompt_tokens,
                completion_tokens=out.completion_tokens or self.completion_tokens,
            )
        from ..protocols.openai import (
            chat_logprobs_block,
            completion_logprobs_block,
        )

        lps = out.logprobs or None
        if self.is_chat:
            delta: dict = {}
            if include_role:
                delta["role"] = "assistant"
            if text or include_role:
                delta["content"] = text
            if delta or finish is not None or lps:
                result.append(
                    chat_chunk(
                        self.id, self.req.model, delta,
                        finish_reason=finish, usage=usage,
                        index=self.index,
                        logprobs=chat_logprobs_block(lps) if lps else None,
                    )
                )
        else:
            if text or finish is not None or lps:
                lp_block = None
                if lps:
                    lp_block = completion_logprobs_block(
                        lps, start_offset=self._lp_text_offset
                    )
                    self._lp_text_offset += sum(
                        len(e.get("token", "")) for e in lps
                    )
                result.append(
                    completion_chunk(
                        self.id, self.req.model, text,
                        finish_reason=finish, usage=usage,
                        index=self.index,
                        logprobs=lp_block,
                    )
                )
        return result
