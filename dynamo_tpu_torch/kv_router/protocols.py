"""KV-router wire protocols: cache events and worker identity.

Verbatim copy of `dynamo_tpu/kv_router/protocols.py` (framework-free),
kept here so the PyTorch port never imports the JAX package; the wire
dicts are the reference's, so either package's router reads either's
worker.

Mirrors the reference's engine-agnostic event schema (ref: lib/kv-router/src/
protocols.rs): workers publish ordered KV-cache events (stored / removed /
cleared) with per-worker monotonic event ids used for gap detection
(ref: docs/design-docs/router-design.md "How gap detection works"). Workers
with internal data parallelism address each DP rank separately
(ref: protocols.rs:196-211 WorkerWithDpRank).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Event-plane topic prefix for KV cache events.
KV_EVENT_TOPIC = "kv_events"
# Event-plane topic prefix for worker load metrics (ForwardPassMetrics analog).
LOAD_TOPIC = "load_metrics"
# Whole-index snapshots: emitted when a durable journal rotates (the
# publisher seeds the new generation with current state instead of the
# discarded history); payload = LocalKvIndexer.dump(). Routers load it
# via indexer.load_worker — the same application path as worker resync.
KV_SNAPSHOT_TOPIC = "kv_snapshot"


@dataclasses.dataclass(frozen=True)
class WorkerWithDpRank:
    worker_id: int
    dp_rank: int = 0

    def key(self) -> str:
        return f"{self.worker_id}:{self.dp_rank}"


@dataclasses.dataclass
class KvCacheStored:
    """Blocks entered a worker's reusable prefix cache. `block_hashes` are
    sequence hashes, in order; `parent_hash` is the sequence hash of the
    block preceding block_hashes[0] (None if the sequence head)."""

    block_hashes: list[int]
    parent_hash: Optional[int] = None


@dataclasses.dataclass
class KvCacheRemoved:
    """Blocks evicted from a worker's prefix cache."""

    block_hashes: list[int]


@dataclasses.dataclass
class KvCacheCleared:
    """The worker dropped its entire cache (restart / clear_kv_blocks)."""


@dataclasses.dataclass
class RouterEvent:
    worker_id: int
    event_id: int  # per-(worker, dp_rank) monotonic
    dp_rank: int = 0
    stored: Optional[KvCacheStored] = None
    removed: Optional[KvCacheRemoved] = None
    cleared: bool = False

    def to_wire(self) -> dict:
        out: dict = {"w": self.worker_id, "e": self.event_id, "d": self.dp_rank}
        if self.stored is not None:
            out["s"] = {"b": self.stored.block_hashes, "p": self.stored.parent_hash}
        if self.removed is not None:
            out["r"] = self.removed.block_hashes
        if self.cleared:
            out["c"] = True
        return out

    @classmethod
    def from_wire(cls, data: dict) -> "RouterEvent":
        stored = None
        if "s" in data:
            stored = KvCacheStored(
                block_hashes=list(data["s"]["b"]), parent_hash=data["s"].get("p")
            )
        removed = KvCacheRemoved(list(data["r"])) if "r" in data else None
        return cls(
            worker_id=data["w"],
            event_id=data["e"],
            dp_rank=data.get("d", 0),
            stored=stored,
            removed=removed,
            cleared=bool(data.get("c", False)),
        )


@dataclasses.dataclass
class OverlapScores:
    """Result of an indexer lookup: per (worker, dp_rank), how many leading
    blocks of the request are already cached there; `tree_sizes` is each
    worker's total indexed block count (tie-break signal, ref: selector.rs)."""

    scores: dict[WorkerWithDpRank, int] = dataclasses.field(default_factory=dict)
    tree_sizes: dict[WorkerWithDpRank, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LoadMetrics:
    """Worker load snapshot published on the event plane; feeds both the KV
    router's decode-load term and the planner's load-based mode (ref:
    common/forward_pass_metrics.py ForwardPassMetrics)."""

    worker_id: int
    dp_rank: int = 0
    active_blocks: int = 0
    total_blocks: int = 0
    active_requests: int = 0
    waiting_requests: int = 0
    kv_usage: float = 0.0
    # per-iteration timing for planner regression
    step_wall_ms: float = 0.0
    prefill_tokens_in_step: int = 0
    decode_tokens_in_step: int = 0
    # step decomposition (perf/steptrace.py): device window vs host
    # residual of the last step, so planners can tell a host-bound pool
    # (more chips won't move it) from a device-bound one before scaling
    device_ms_in_step: float = 0.0
    host_ms_in_step: float = 0.0
    # Graceful drain plane (docs/fault-tolerance.md departure ladder):
    # a draining worker is vacating — routers stop selecting it and
    # decay its radix state, planners count it as departing capacity
    # (its backlog is migrating out, not a scale-up signal).
    draining: bool = False

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, data: dict) -> "LoadMetrics":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})
