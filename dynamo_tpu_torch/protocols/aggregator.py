"""Stream -> full-response aggregation (the stream=false path).

Re-design of the reference's aggregators
(protocols/openai/chat_completions/aggregator.rs:462,
completions/aggregator.rs:343): the service always streams internally and
folds chunks into a single OpenAI response for non-streaming clients
(ref http/service.rs:24-26).
"""

from __future__ import annotations

from typing import Iterable, Optional


def _merge_tool_calls(acc: list, deltas: list) -> None:
    for d in deltas:
        idx = d.get("index", 0)
        while len(acc) <= idx:
            acc.append({"index": len(acc), "type": "function",
                        "function": {"name": "", "arguments": ""}})
        slot = acc[idx]
        if d.get("id"):
            slot["id"] = d["id"]
        fn = d.get("function") or {}
        if fn.get("name"):
            slot["function"]["name"] = fn["name"]
        if fn.get("arguments"):
            slot["function"]["arguments"] += fn["arguments"]


def aggregate_chat_chunks(chunks: Iterable[dict]) -> dict:
    """Fold chat.completion.chunk dicts into one chat.completion."""
    chunks = list(chunks)
    if not chunks:
        raise ValueError("empty stream")
    base = chunks[0]
    choices: dict[int, dict] = {}
    usage: Optional[dict] = None
    created = base.get("created")
    for ch in chunks:
        if ch.get("usage"):
            usage = ch["usage"]
        for choice in ch.get("choices", []):
            idx = choice.get("index", 0)
            acc = choices.setdefault(
                idx,
                {
                    "index": idx,
                    "message": {"role": "assistant", "content": ""},
                    "finish_reason": None,
                    "logprobs": None,
                },
            )
            delta = choice.get("delta", {})
            if delta.get("role"):
                acc["message"]["role"] = delta["role"]
            if delta.get("content"):
                acc["message"]["content"] += delta["content"]
            if delta.get("reasoning_content"):
                acc["message"].setdefault("reasoning_content", "")
                acc["message"]["reasoning_content"] += delta["reasoning_content"]
            if delta.get("tool_calls"):
                acc["message"].setdefault("tool_calls", [])
                _merge_tool_calls(acc["message"]["tool_calls"], delta["tool_calls"])
            if choice.get("finish_reason"):
                acc["finish_reason"] = choice["finish_reason"]
            lp = choice.get("logprobs")
            if lp and lp.get("content"):
                if acc["logprobs"] is None:
                    acc["logprobs"] = {"content": []}
                acc["logprobs"]["content"].extend(lp["content"])
    out = {
        "id": base.get("id"),
        "object": "chat.completion",
        "created": created,
        "model": base.get("model"),
        "choices": [choices[i] for i in sorted(choices)],
    }
    if usage:
        out["usage"] = usage
    return out


def aggregate_completion_chunks(chunks: Iterable[dict]) -> dict:
    """Fold text_completion chunks into one completion response."""
    chunks = list(chunks)
    if not chunks:
        raise ValueError("empty stream")
    base = chunks[0]
    choices: dict[int, dict] = {}
    usage: Optional[dict] = None
    for ch in chunks:
        if ch.get("usage"):
            usage = ch["usage"]
        for choice in ch.get("choices", []):
            idx = choice.get("index", 0)
            acc = choices.setdefault(
                idx, {"index": idx, "text": "", "finish_reason": None, "logprobs": None}
            )
            acc["text"] += choice.get("text", "")
            if choice.get("finish_reason"):
                acc["finish_reason"] = choice["finish_reason"]
            lp = choice.get("logprobs")
            if lp and lp.get("tokens"):
                if acc["logprobs"] is None:
                    acc["logprobs"] = {
                        "tokens": [], "token_logprobs": [],
                        "top_logprobs": [], "text_offset": [],
                    }
                acc["logprobs"]["tokens"].extend(lp["tokens"])
                acc["logprobs"]["token_logprobs"].extend(lp["token_logprobs"])
                acc["logprobs"]["top_logprobs"].extend(lp["top_logprobs"])
                acc["logprobs"]["text_offset"].extend(
                    lp.get("text_offset", [])
                )
    out = {
        "id": base.get("id"),
        "object": "text_completion",
        "created": base.get("created"),
        "model": base.get("model"),
        "choices": [choices[i] for i in sorted(choices)],
    }
    if usage:
        out["usage"] = usage
    return out
