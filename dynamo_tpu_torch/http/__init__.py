"""OpenAI-compatible HTTP frontend (a trimmed copy of ``dynamo_tpu.http``)."""

from .metrics import Metrics
from .service import HttpService, ModelManager

__all__ = ["HttpService", "Metrics", "ModelManager"]
