"""OpenAI-compatible API types + the `nvext` extension namespace.

Re-design of the reference's protocols/openai/* (which wraps the
async-openai crate types): plain dataclasses with permissive from_dict
parsing — unknown fields are ignored, so clients built against richer
OpenAI SDKs still work. The ``nvext`` extension carries engine-specific
knobs (ref protocols/openai/nvext.rs:28: ignore_eos, use_raw_prompt,
annotations...).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from .common import SamplingOptions, StopConditions


class RequestError(ValueError):
    """400-level validation error."""


@dataclass
class NvExt:
    ignore_eos: bool = False
    use_raw_prompt: bool = False
    greed_sampling: bool = False
    annotations: list[str] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "NvExt":
        if not d:
            return NvExt()
        return NvExt(
            ignore_eos=bool(d.get("ignore_eos", False)),
            use_raw_prompt=bool(d.get("use_raw_prompt", False)),
            greed_sampling=bool(d.get("greed_sampling", False)),
            annotations=list(d.get("annotations", [])),
        )


@dataclass
class ChatMessage:
    role: str
    content: Any = None  # str or content-part list
    name: Optional[str] = None
    tool_calls: Optional[list] = None

    def content_text(self) -> str:
        if self.content is None:
            return ""
        if isinstance(self.content, str):
            return self.content
        # content-part list: concatenate text parts
        parts = []
        for part in self.content:
            if isinstance(part, dict) and part.get("type") == "text":
                parts.append(part.get("text", ""))
        return "".join(parts)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"role": self.role, "content": self.content}
        if self.name:
            d["name"] = self.name
        if self.tool_calls:
            d["tool_calls"] = self.tool_calls
        return d


def _common_sampling(d: dict) -> SamplingOptions:
    return SamplingOptions(
        temperature=d.get("temperature"),
        top_p=d.get("top_p"),
        top_k=d.get("top_k"),
        frequency_penalty=d.get("frequency_penalty"),
        presence_penalty=d.get("presence_penalty"),
        repetition_penalty=d.get("repetition_penalty"),
        seed=d.get("seed"),
        n=_int_field(d, "n", 1, lo=1, hi=16),
        # chat schema: logprobs (bool) + top_logprobs (int, 0..20).
        # logprobs:true alone returns each chosen token's logprob with no
        # alternates (top_logprobs defaults to 0, per the OpenAI schema).
        logprobs=(
            _int_field(d, "top_logprobs", 0, lo=0, hi=20)
            if d.get("logprobs") else None
        ),
    )


def _int_field(d: dict, key: str, default: int, lo: int, hi: int) -> int:
    """Validated int request field -> 400 on junk, not a 500."""
    v = d.get(key)
    if v is None:
        return default
    try:
        v = int(v)
    except (TypeError, ValueError):
        raise RequestError(f"{key} must be an integer") from None
    if not lo <= v <= hi:
        raise RequestError(f"{key} must be between {lo} and {hi}")
    return v


def _common_stops(d: dict, nvext: NvExt) -> StopConditions:
    stop = d.get("stop")
    if stop is None:
        stop_list: list[str] = []
    elif isinstance(stop, str):
        stop_list = [stop]
    else:
        stop_list = list(stop)
    if len(stop_list) > 4:
        raise RequestError("at most 4 stop sequences are supported")
    return StopConditions(
        max_tokens=d.get("max_completion_tokens") or d.get("max_tokens"),
        stop=stop_list,
        stop_token_ids=list(d.get("stop_token_ids", [])),
        min_tokens=d.get("min_tokens"),
        ignore_eos=nvext.ignore_eos,
    )


@dataclass
class ChatCompletionRequest:
    model: str
    messages: list[ChatMessage]
    stream: bool = False
    stream_options: dict = field(default_factory=dict)
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stops: StopConditions = field(default_factory=StopConditions)
    nvext: NvExt = field(default_factory=NvExt)
    tools: Optional[list] = None
    response_format: Optional[dict] = None
    raw: dict = field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict) -> "ChatCompletionRequest":
        if "model" not in d:
            raise RequestError("missing required field: model")
        msgs_raw = d.get("messages")
        if not msgs_raw or not isinstance(msgs_raw, list):
            raise RequestError("messages must be a non-empty list")
        messages = []
        for m in msgs_raw:
            if not isinstance(m, dict) or "role" not in m:
                raise RequestError("each message must have a role")
            messages.append(
                ChatMessage(
                    role=m["role"],
                    content=m.get("content"),
                    name=m.get("name"),
                    tool_calls=m.get("tool_calls"),
                )
            )
        nvext = NvExt.from_dict(d.get("nvext"))
        return ChatCompletionRequest(
            model=d["model"],
            messages=messages,
            stream=bool(d.get("stream", False)),
            stream_options=d.get("stream_options") or {},
            sampling=_common_sampling(d),
            stops=_common_stops(d, nvext),
            nvext=nvext,
            tools=d.get("tools"),
            response_format=d.get("response_format"),
            raw=d,
        )


@dataclass
class CompletionRequest:
    model: str
    prompt: Any  # str | list[str] | list[int]
    stream: bool = False
    stream_options: dict = field(default_factory=dict)
    echo: bool = False
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stops: StopConditions = field(default_factory=StopConditions)
    nvext: NvExt = field(default_factory=NvExt)
    raw: dict = field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict) -> "CompletionRequest":
        if "model" not in d:
            raise RequestError("missing required field: model")
        if "prompt" not in d:
            raise RequestError("missing required field: prompt")
        prompt = d["prompt"]
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], str):
            # OpenAI batched prompts need one choice per prompt; not
            # supported yet — reject rather than silently concatenate
            raise RequestError(
                "list-of-strings prompt is not supported; send one request per prompt"
            )
        nvext = NvExt.from_dict(d.get("nvext"))
        sampling = _common_sampling(d)
        # legacy completions schema: logprobs is the top-k count itself
        # (0 = chosen-token logprobs with no alternates)
        if d.get("logprobs") is not None:
            sampling.logprobs = _int_field(d, "logprobs", 0, lo=0, hi=20)
        return CompletionRequest(
            model=d["model"],
            prompt=d["prompt"],
            stream=bool(d.get("stream", False)),
            stream_options=d.get("stream_options") or {},
            echo=bool(d.get("echo", False)),
            sampling=sampling,
            stops=_common_stops(d, nvext),
            nvext=nvext,
            raw=d,
        )


# ---------------- responses ----------------


def _now() -> int:
    return int(time.time())


def new_chat_id() -> str:
    return "chatcmpl-" + uuid.uuid4().hex[:24]


def new_cmpl_id() -> str:
    return "cmpl-" + uuid.uuid4().hex[:24]


@dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0

    def to_dict(self) -> dict:
        return {
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "total_tokens": self.prompt_tokens + self.completion_tokens,
        }


def chat_chunk(
    id: str,
    model: str,
    delta: dict,
    finish_reason: Optional[str] = None,
    created: Optional[int] = None,
    usage: Optional[Usage] = None,
    index: int = 0,
    logprobs: Optional[dict] = None,
) -> dict:
    """One chat.completion.chunk SSE object."""
    out = {
        "id": id,
        "object": "chat.completion.chunk",
        "created": created or _now(),
        "model": model,
        "choices": [
            {"index": index, "delta": delta, "finish_reason": finish_reason,
             "logprobs": logprobs}
        ],
    }
    if usage is not None:
        out["usage"] = usage.to_dict()
    return out


def chat_logprobs_block(entries: list) -> dict:
    """OpenAI chat logprobs schema from the backend's enriched entries."""
    return {
        "content": [
            {
                "token": e.get("token", ""),
                "logprob": e.get("logprob"),
                "top_logprobs": e.get("top", []),
            }
            for e in entries
        ]
    }


def completion_logprobs_block(entries: list, start_offset: int = 0) -> dict:
    """Legacy completions logprobs schema.

    Distinct token ids can decode to the same string (BPE byte /
    whitespace pieces); the dict comprehension would silently drop all
    but the last, so collisions keep the MAX logprob (the alternative a
    client ranking by probability would want). ``text_offset`` is the
    character offset of each token in the generated text, starting at
    ``start_offset`` (the caller's running offset across stream chunks).
    """
    tops = []
    for e in entries:
        d: dict = {}
        for t in e.get("top", []):
            k = t["token"]
            if k not in d or t["logprob"] > d[k]:
                d[k] = t["logprob"]
        tops.append(d)
    offsets, off = [], start_offset
    for e in entries:
        offsets.append(off)
        off += len(e.get("token", ""))
    return {
        "tokens": [e.get("token", "") for e in entries],
        "token_logprobs": [e.get("logprob") for e in entries],
        "top_logprobs": tops,
        "text_offset": offsets,
    }


def completion_chunk(
    id: str,
    model: str,
    text: str,
    finish_reason: Optional[str] = None,
    created: Optional[int] = None,
    usage: Optional[Usage] = None,
    index: int = 0,
    logprobs: Optional[dict] = None,
) -> dict:
    out = {
        "id": id,
        "object": "text_completion",
        "created": created or _now(),
        "model": model,
        "choices": [
            {"index": index, "text": text, "finish_reason": finish_reason,
             "logprobs": logprobs}
        ],
    }
    if usage is not None:
        out["usage"] = usage.to_dict()
    return out
