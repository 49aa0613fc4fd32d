"""Model discovery: store-watched hot add/remove of served models.

A copy of ``dynamo_tpu/http/discovery.py`` (the reference's model
discovery, lib/llm/src/http/service/discovery.rs:38-145 + launch/llmctl),
with the same entries under the same keys: workers (or an operator CLI) register
a ``ModelEntry`` at ``public/models/{type}/{name}`` pointing at a component
endpoint; the HTTP frontend watches the prefix and hot-adds/removes models
from its ModelManager as workers come and go. Entries registered under a
worker's lease vanish with the worker — frontends need no health checks.

Workers serve the *full* OpenAI surface (request dict in, chunk dicts out)
— the frontend stays tokenizer-free and stateless; KV-aware routing runs in
a processor/router component behind the same endpoint scheme (see
dynamo_tpu_torch.kv_router).
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass
from typing import AsyncIterator, Optional

from ..protocols.openai import ChatCompletionRequest, CompletionRequest
from ..runtime.annotated import Annotated
from ..runtime.component import Client, EngineClient
from ..runtime.engine import AsyncEngine, Context
from ..runtime.store import EventKind
from .service import ModelManager

logger = logging.getLogger(__name__)

MODEL_ROOT = "public/models"


@dataclass
class ModelEntry:
    """ref: llmctl ModelEntry (launch/llmctl/src/main.rs:16-100)."""

    name: str
    namespace: str
    component: str
    endpoint: str
    model_type: str = "chat"  # "chat" | "completion" | "both"
    instance: int = 0  # registering worker's lease id — one entry per worker

    def key(self) -> str:
        return f"{MODEL_ROOT}/{self.model_type}/{self.name}/{self.instance:x}"

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @staticmethod
    def from_json(raw: bytes) -> "ModelEntry":
        return ModelEntry(**json.loads(raw))


async def register_model(drt, entry: ModelEntry, use_lease: bool = True) -> None:
    """llmctl add: register under this process's lease so the entry dies
    with the worker."""
    lease = drt.primary_lease_id if use_lease else 0
    if entry.instance == 0:
        entry.instance = drt.primary_lease_id
    put = drt.store.kv_put(entry.key(), entry.to_json(), lease_id=lease)
    if asyncio.iscoroutine(put):
        await put


async def unregister_model(drt, model_type: str, name: str) -> int:
    """llmctl remove: drop every worker's entry for this model."""
    deleted = drt.store.kv_delete_prefix(f"{MODEL_ROOT}/{model_type}/{name}/")
    if asyncio.iscoroutine(deleted):
        deleted = await deleted
    return int(deleted)


async def list_models(drt) -> list[ModelEntry]:
    entries = drt.store.kv_get_prefix(MODEL_ROOT + "/")
    if asyncio.iscoroutine(entries):
        entries = await entries
    return [ModelEntry.from_json(e.value) for e in entries]


class RemoteOpenAIEngine(EngineClient):
    """EngineClient variant speaking raw OpenAI dicts: unwraps typed
    requests to their original JSON before pushing (the worker runs its own
    pre/post-processing)."""

    async def generate(self, request: Context) -> AsyncIterator[Annotated]:
        data = request.data
        if isinstance(data, (ChatCompletionRequest, CompletionRequest)):
            request = request.transfer(data.raw)
        async for item in super().generate(request):
            yield item


class ModelWatcher:
    """ref discovery.rs:58 model_watcher. ``policy`` (round_robin | random)
    picks among the instances that serve a model."""

    def __init__(self, drt, manager: ModelManager, policy: str = "round_robin"):
        self.drt = drt
        self.manager = manager
        self.policy = policy
        self._task: Optional[asyncio.Task] = None
        self._clients: dict[str, Client] = {}
        self._entries: dict[str, ModelEntry] = {}

    async def start(self) -> "ModelWatcher":
        watcher = self.drt.store.watch_prefix(MODEL_ROOT + "/")
        if asyncio.iscoroutine(watcher):
            watcher = await watcher
        for e in watcher.snapshot:
            await self._add(ModelEntry.from_json(e.value))
        self._task = self.drt.runtime.spawn(self._watch(watcher))
        return self

    async def _watch(self, watcher) -> None:
        async for ev in watcher:
            try:
                if ev.kind == EventKind.PUT:
                    await self._add(ModelEntry.from_json(ev.value))
                elif ev.kind == EventKind.DELETE:
                    self._remove_by_key(ev.key)
                # RESUMED: post-reconnect reconcile marker — the replayed
                # puts/deletes above already brought the registry current
            except Exception:  # noqa: BLE001
                logger.exception("model watcher error for %s", ev.key)

    async def _add(self, entry: ModelEntry) -> None:
        key = entry.key()
        old = self._clients.pop(key, None)
        if old is not None:
            old.stop()  # worker re-registered under the same key
        client = await (
            self.drt.namespace(entry.namespace)
            .component(entry.component)
            .endpoint(entry.endpoint)
            .client()
            .start()
        )
        self._clients[key] = client
        self._entries[key] = entry
        engine = RemoteOpenAIEngine(client, policy=self.policy)
        if entry.model_type in ("chat", "both"):
            self.manager.add_chat_model(entry.name, engine)
        if entry.model_type in ("completion", "both"):
            self.manager.add_completion_model(entry.name, engine)
        logger.info("discovered model %s -> %s/%s/%s",
                    entry.name, entry.namespace, entry.component, entry.endpoint)

    def _remove_by_key(self, key: str) -> None:
        entry = self._entries.pop(key, None)
        client = self._clients.pop(key, None)
        if client is not None:
            client.stop()
        if entry is None:
            return
        # only drop the model when no other live worker still serves it
        still_served = any(
            e.name == entry.name and e.model_type == entry.model_type
            for e in self._entries.values()
        )
        if still_served:
            return
        if entry.model_type in ("chat", "both"):
            self.manager.remove_chat_model(entry.name)
        if entry.model_type in ("completion", "both"):
            self.manager.remove_completion_model(entry.name)
        logger.info("removed model %s", entry.name)
