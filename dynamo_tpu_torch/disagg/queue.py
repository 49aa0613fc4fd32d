"""Prefill work queue: a copy of ``dynamo_tpu/disagg/queue.py``.

A thin typed wrapper over a bus work queue (ack + visibility-timeout
redelivery): the in-process bus's ``work_queue`` or the hub's
``RemoteWorkQueue``. If a prefill worker dies mid-request the item
redelivers to another worker."""

from __future__ import annotations

from typing import Optional

from .protocols import RemotePrefillRequest

QUEUE_NAME = "prefill_queue"


class PrefillQueue:
    def __init__(self, bus, namespace: str = "dynamo", redeliver_after: float = 60.0):
        self.name = f"{namespace}.{QUEUE_NAME}"
        self._q = bus.work_queue(self.name, redeliver_after=redeliver_after)
        self._deliveries: dict[int, int] = {}

    async def enqueue(self, req: RemotePrefillRequest) -> int:
        r = self._q.push(req.to_bytes())
        if hasattr(r, "__await__"):
            r = await r
        return r

    async def dequeue(
        self, timeout: Optional[float] = None
    ) -> Optional[tuple[int, RemotePrefillRequest]]:
        item = await self._q.pop(timeout)
        if item is None:
            return None
        # keep a bounded map of delivery counts for poison-pill cutoffs
        if len(self._deliveries) > 4096:
            self._deliveries.clear()
        self._deliveries[item.id] = item.deliveries
        return item.id, RemotePrefillRequest.from_bytes(item.payload)

    def deliveries(self, item_id: int) -> int:
        return self._deliveries.get(item_id, 1)

    async def ack(self, item_id: int) -> bool:
        r = self._q.ack(item_id)
        if hasattr(r, "__await__"):
            r = await r
        return r

    async def nack(self, item_id: int) -> bool:
        r = self._q.nack(item_id)
        if hasattr(r, "__await__"):
            r = await r
        return r

    async def get_depth(self) -> int:
        d = self._q.depth
        if callable(d):  # remote hub queue: depth is an RPC
            d = await d()
        self.last_depth = d
        return d

    # depth snapshot for sync decision paths; refreshed by get_depth()
    last_depth: int = 0

    @property
    def depth(self) -> int:
        d = self._q.depth
        if callable(d):
            return self.last_depth
        return d
