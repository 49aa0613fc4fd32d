"""Conditional disaggregation router: a copy of ``dynamo_tpu/disagg/router.py``.

Decides, per request, whether the prompt's prefill runs locally on the
decode worker or is offloaded to a remote prefill worker. The policy lives
in the control-plane store under ``disagg_config_key`` and hot-reloads
through a prefix watch: one ``kv_put`` retunes ``max_local_prefill_length``
on a live fleet.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from .protocols import DisaggConfig, disagg_config_key

logger = logging.getLogger(__name__)


class ConditionalDisaggRouter:
    def __init__(
        self,
        drt,
        namespace: str,
        model: str,
        default: Optional[DisaggConfig] = None,
    ):
        self.drt = drt
        self.key = disagg_config_key(namespace, model)
        self.config = default or DisaggConfig()
        self._watch_task: Optional[asyncio.Task] = None
        self._watcher = None

    async def start(self) -> None:
        """Publish the current config if absent, then watch for updates."""
        try:
            created = self.drt.store.kv_create(
                self.key, self.config.to_json().encode()
            )
            if asyncio.iscoroutine(created):
                await created
        except Exception:  # noqa: BLE001 — already exists: adopt stored value
            logger.debug("disagg config kv_create raced", exc_info=True)
        entry = self.drt.store.kv_get(self.key)
        if asyncio.iscoroutine(entry):
            entry = await entry
        if entry is not None:
            self.config = DisaggConfig.from_json(entry.value)
        self._watcher = self.drt.store.watch_prefix(self.key)
        if asyncio.iscoroutine(self._watcher):
            self._watcher = await self._watcher
        self._watch_task = asyncio.get_running_loop().create_task(self._watch())

    async def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.cancel()
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None

    async def _watch(self) -> None:
        try:
            async for ev in self._watcher:
                if ev.kind.value == "put" and ev.value:
                    try:
                        self.config = DisaggConfig.from_json(ev.value)
                        logger.info("disagg config reloaded: %s", self.config)
                    except Exception:  # noqa: BLE001
                        logger.exception("bad disagg config at %s", self.key)
        except asyncio.CancelledError:
            pass

    async def update(self, config: DisaggConfig) -> None:
        put = self.drt.store.kv_put(self.key, config.to_json().encode())
        if asyncio.iscoroutine(put):
            await put
        self.config = config

    def prefill_remote(
        self, prefill_length: int, cached_prefix: int, queue_depth: int
    ) -> bool:
        """True → offload. ``prefill_length`` is the prompt length,
        ``cached_prefix`` the tokens already resident in the decode
        worker's prefix cache (only the remainder costs compute)."""
        cfg = self.config
        if not cfg.enabled:
            return False
        effective = prefill_length - cached_prefix
        if effective <= cfg.max_local_prefill_length:
            return False
        if cfg.max_prefill_queue_size and queue_depth >= cfg.max_prefill_queue_size:
            return False
        return True
