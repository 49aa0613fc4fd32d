"""Worker-side OpenAI engine: request dicts -> local pipeline -> chunks.

Parse the request, run the local preprocessor -> detokenizer -> core-engine
pipeline, and yield OpenAI chunk dicts (the reference's StaticFull engine
wiring, launch/dynamo-run/src/lib.rs EngineConfig::StaticFull). A copy of
``dynamo_tpu/llm/openai_engine.py``.
"""

from __future__ import annotations

from typing import AsyncIterator

from ..protocols.openai import ChatCompletionRequest, CompletionRequest, RequestError
from ..runtime.annotated import Annotated
from ..runtime.engine import AsyncEngine, Context
from ..runtime.pipeline import link
from .backend import Backend
from .preprocessor import OpenAIPreprocessor
from .tokenizer import Tokenizer


class OpenAIWorkerEngine(AsyncEngine):
    def __init__(self, tokenizer: Tokenizer, core_engine: AsyncEngine):
        self.tokenizer = tokenizer
        self._core = core_engine
        # text-level engines (pystr) emit text directly — the detokenizer
        # stage would overwrite it from their (empty) token ids, so skip it
        if getattr(core_engine, "text_mode", False):
            self._pipeline = link(OpenAIPreprocessor(tokenizer), core_engine)
        else:
            self._pipeline = link(
                OpenAIPreprocessor(tokenizer), Backend(tokenizer), core_engine
            )

    async def generate(self, request: Context) -> AsyncIterator[Annotated]:
        data = request.data
        if isinstance(data, dict):
            if "token_ids" in data:
                # already preprocessed upstream (KV-routed frontend does
                # tokenization for prefix hashing) -> run the core engine
                async for item in self._core.generate(request):
                    if not isinstance(item, Annotated):
                        item = Annotated.from_data(item)
                    yield item
                return
            try:
                typed = (
                    ChatCompletionRequest.from_dict(data)
                    if "messages" in data
                    else CompletionRequest.from_dict(data)
                )
            except RequestError as e:
                yield Annotated.from_error(str(e))
                return
        else:
            typed = data
        async for item in self._pipeline.generate(request.transfer(typed)):
            yield item
