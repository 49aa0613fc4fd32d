"""Engine-internal request/response protocol.

Re-design of the reference's common protocols
(lib/llm/src/protocols/common/{preprocessor,llm_backend}.rs, common.rs):
the *preprocessed* request (token ids + stop conditions + sampling options)
that flows frontend->worker, and the per-step engine output (token ids +
finish reason) that flows back. These are the only types the engine
sees — all OpenAI surface area is translated away by the preprocessor.
"""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass, field
from typing import Any, Optional


class FinishReason(str, enum.Enum):
    EOS = "eos"
    LENGTH = "length"
    STOP = "stop"
    CANCELLED = "cancelled"
    ERROR = "error"

    def to_openai(self) -> str:
        return {
            FinishReason.EOS: "stop",
            FinishReason.STOP: "stop",
            FinishReason.LENGTH: "length",
            FinishReason.CANCELLED: "stop",
            FinishReason.ERROR: "error",
        }[self]


@dataclass
class StopConditions:
    """ref: protocols/common.rs StopConditions."""

    max_tokens: Optional[int] = None
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    min_tokens: Optional[int] = None
    ignore_eos: bool = False

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "StopConditions":
        return StopConditions(**{k: d[k] for k in d if k in StopConditions.__dataclass_fields__})


@dataclass
class SamplingOptions:
    """ref: protocols/common.rs SamplingOptions."""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    n: int = 1
    logprobs: Optional[int] = None

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SamplingOptions":
        return SamplingOptions(
            **{k: d[k] for k in d if k in SamplingOptions.__dataclass_fields__}
        )


@dataclass
class PreprocessedRequest:
    """What the frontend sends to a worker
    (ref: protocols/common/preprocessor.rs:25 PreprocessedRequest)."""

    token_ids: list[int]
    stop_conditions: StopConditions = field(default_factory=StopConditions)
    sampling_options: SamplingOptions = field(default_factory=SamplingOptions)
    model: str = ""
    eos_token_ids: list[int] = field(default_factory=list)
    annotations: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "token_ids": self.token_ids,
            "stop_conditions": self.stop_conditions.to_dict(),
            "sampling_options": self.sampling_options.to_dict(),
            "model": self.model,
            "eos_token_ids": self.eos_token_ids,
            "annotations": self.annotations,
        }

    @staticmethod
    def from_dict(d: dict) -> "PreprocessedRequest":
        return PreprocessedRequest(
            token_ids=list(d["token_ids"]),
            stop_conditions=StopConditions.from_dict(d.get("stop_conditions", {})),
            sampling_options=SamplingOptions.from_dict(d.get("sampling_options", {})),
            model=d.get("model", ""),
            eos_token_ids=list(d.get("eos_token_ids", [])),
            annotations=d.get("annotations", {}),
        )


@dataclass
class LLMEngineOutput:
    """One streamed step from the engine
    (ref: protocols/common/llm_backend.rs:27 LLMEngineOutput)."""

    token_ids: list[int] = field(default_factory=list)
    text: Optional[str] = None
    cum_log_probs: Optional[float] = None
    # per-token logprob entries aligned with token_ids (filled when the
    # request asked for logprobs): {"logprob": float, "top": [[id, lp]..]},
    # enriched with token text by the detokenizer stage
    logprobs: Optional[list] = None
    finish_reason: Optional[FinishReason] = None
    # usage accounting (filled by the engine on the final chunk)
    prompt_tokens: Optional[int] = None
    completion_tokens: Optional[int] = None
    # KV routing hints
    kv_overlap_blocks: Optional[int] = None

    def is_final(self) -> bool:
        return self.finish_reason is not None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"token_ids": self.token_ids}
        if self.text is not None:
            d["text"] = self.text
        if self.cum_log_probs is not None:
            d["cum_log_probs"] = self.cum_log_probs
        if self.logprobs is not None:
            d["logprobs"] = self.logprobs
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason.value
        if self.prompt_tokens is not None:
            d["prompt_tokens"] = self.prompt_tokens
        if self.completion_tokens is not None:
            d["completion_tokens"] = self.completion_tokens
        return d

    @staticmethod
    def from_dict(d: dict) -> "LLMEngineOutput":
        fr = d.get("finish_reason")
        return LLMEngineOutput(
            token_ids=list(d.get("token_ids", [])),
            text=d.get("text"),
            cum_log_probs=d.get("cum_log_probs"),
            logprobs=d.get("logprobs"),
            finish_reason=FinishReason(fr) if fr else None,
            prompt_tokens=d.get("prompt_tokens"),
            completion_tokens=d.get("completion_tokens"),
        )
