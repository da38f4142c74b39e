"""KV-aware routing: the radix indexer, load prediction, worker selection
and the router's admission queue (port of `dynamo_tpu/kv_router`)."""

from .indexer import RadixTree, make_radix_tree
from .protocols import (
    KV_EVENT_TOPIC,
    KV_SNAPSHOT_TOPIC,
    LOAD_TOPIC,
    KvCacheCleared,
    KvCacheRemoved,
    KvCacheStored,
    LoadMetrics,
    OverlapScores,
    RouterEvent,
    WorkerWithDpRank,
)
from .scheduler import KvRouterConfig, KvScheduler, SelectionResult, softmax_sample
from .sequences import ActiveSequences

__all__ = [
    "ActiveSequences",
    "KV_EVENT_TOPIC",
    "KV_SNAPSHOT_TOPIC",
    "KvCacheCleared",
    "KvCacheRemoved",
    "KvCacheStored",
    "KvRouterConfig",
    "KvScheduler",
    "LOAD_TOPIC",
    "LoadMetrics",
    "OverlapScores",
    "RadixTree",
    "make_radix_tree",
    "RouterEvent",
    "SelectionResult",
    "WorkerWithDpRank",
    "softmax_sample",
]
