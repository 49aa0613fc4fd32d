"""Wire protocols: engine-internal types, OpenAI API types, SSE codec.

Re-design of the reference's lib/llm/src/protocols/* for Python dataclasses.
"""

from .common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

__all__ = [
    "FinishReason",
    "LLMEngineOutput",
    "PreprocessedRequest",
    "SamplingOptions",
    "StopConditions",
]
