"""KV-cache-aware request routing (a copy of ``dynamo_tpu.kv_router``,
the reference's lib/llm/src/kv_router).

Workers publish block stored/removed events; the router maintains a global
prefix index (chained block hashes -> worker sets), scores each request's
cache overlap per worker, combines it with scraped load metrics, and
routes to the best worker. Events, hashes and scrape keys are the
reference's, so torch and JAX workers share one index.
"""

from .indexer import KvIndexer, OverlapScores, PrefixIndex
from .protocols import KvCacheEvent, KvPeerFetchRequest, KvPrefetchHint, RouterEvent
from .publisher import (
    KvEventPublisher,
    KvMetricsAggregator,
    KvPeerServer,
    KvPrefetchListener,
)
from .router import KvRoutedEngine, KvRouter
from .scheduler import KvScheduler, ProcessedEndpoints, SchedulerConfig, WorkerLoad

__all__ = [
    "KvCacheEvent",
    "KvEventPublisher",
    "KvIndexer",
    "KvMetricsAggregator",
    "KvPeerFetchRequest",
    "KvPeerServer",
    "KvPrefetchHint",
    "KvPrefetchListener",
    "KvRoutedEngine",
    "KvRouter",
    "KvScheduler",
    "OverlapScores",
    "PrefixIndex",
    "ProcessedEndpoints",
    "RouterEvent",
    "SchedulerConfig",
    "WorkerLoad",
]
