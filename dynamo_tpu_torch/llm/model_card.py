"""Model Deployment Card (MDC): the metadata record for a served model.

A copy of ``dynamo_tpu/llm/model_card.py`` (the reference's model card,
lib/llm/src/model_card/model.rs:94 ModelDeploymentCard), with
the same JSON: display/service name, tokenizer location,
prompt-template source, context length, KV block size — published to the
bus object store bucket "mdc" with a TTL that the owning worker refreshes
(ref model.rs:42-49, 5-minute TTL), so dead workers' cards age out.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import asdict, dataclass, field
from typing import Optional

MDC_BUCKET = "mdc"
MDC_TTL_SECONDS = 300.0


@dataclass
class ModelDeploymentCard:
    display_name: str
    service_name: str
    model_path: str = ""
    tokenizer_kind: str = "hf"  # "hf" | "sp" (SentencePiece) | "byte"
    context_length: int = 8192
    kv_block_size: int = 16
    model_type: str = "chat"  # "chat" | "completion" | "both"
    # architecture hints for the serving engine
    architecture: str = ""
    dtype: str = "bfloat16"
    extra: dict = field(default_factory=dict)

    def to_json(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @staticmethod
    def from_json(raw: bytes) -> "ModelDeploymentCard":
        d = json.loads(raw)
        known = {k: d[k] for k in d if k in ModelDeploymentCard.__dataclass_fields__}
        return ModelDeploymentCard(**known)

    # ---- object-store publication ----
    async def publish(self, bus, refresh: bool = False):
        put = bus.object_put(
            MDC_BUCKET, self.service_name, self.to_json(), ttl=MDC_TTL_SECONDS
        )
        if asyncio.iscoroutine(put):
            await put

    @staticmethod
    async def load(bus, service_name: str) -> Optional["ModelDeploymentCard"]:
        got = bus.object_get(MDC_BUCKET, service_name)
        if asyncio.iscoroutine(got):
            got = await got
        return ModelDeploymentCard.from_json(got) if got else None


class MdcRefresher:
    """Keep a card alive in the object store while the worker lives."""

    def __init__(self, bus, card: ModelDeploymentCard, interval: float = MDC_TTL_SECONDS / 3):
        self._bus = bus
        self._card = card
        self._interval = interval
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while True:
            await self._card.publish(self._bus, refresh=True)
            await asyncio.sleep(self._interval)

    def stop(self) -> None:
        if self._task:
            self._task.cancel()
            self._task = None
