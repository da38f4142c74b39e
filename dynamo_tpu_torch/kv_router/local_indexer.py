"""Worker-side local KV indexer — the resync source of truth.

Verbatim copy of `dynamo_tpu/kv_router/local_indexer.py`.

Every worker keeps a record of its OWN cached blocks (hash -> parent) in
event order. Routers use it two ways (ref: lib/llm/src/kv_router/
worker_query.rs + router-design.md "How gap detection works"):

  * **bootstrap**: a router that discovers a live worker (e.g. after a
    router restart) queries `kv_blocks` and loads the full dump — no
    durable event log needed to recover routing state;
  * **gap recovery**: when the event stream skips an id, the router
    re-queries this worker and replaces its view.

Thread-safe: the engine scheduler thread records; the asyncio endpoint
reads dumps.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional


class LocalKvIndexer:
    def __init__(self, worker_id: int, dp_rank: int = 0) -> None:
        self.worker_id = worker_id
        self.dp_rank = dp_rank
        self._lock = threading.Lock()
        # hash -> parent hash (None = root); insertion order = store order,
        # so dumps replay parents before children.
        self._blocks: "OrderedDict[int, Optional[int]]" = OrderedDict()
        self.last_event_id = -1

    def on_stored(self, event_id: int, block_hashes: list[int],
                  parent: Optional[int]) -> None:
        with self._lock:
            prev = parent
            for h in block_hashes:
                self._blocks[h] = prev
                prev = h
            self.last_event_id = event_id

    def on_removed(self, event_id: int, block_hashes: list[int]) -> None:
        with self._lock:
            for h in block_hashes:
                self._blocks.pop(h, None)
            self.last_event_id = event_id

    def on_cleared(self, event_id: int) -> None:
        with self._lock:
            self._blocks.clear()
            self.last_event_id = event_id

    def block_count(self) -> int:
        with self._lock:
            return len(self._blocks)

    def dump(self) -> dict:
        """Wire payload served on the `kv_blocks` endpoint."""
        with self._lock:
            return {
                "worker_id": self.worker_id,
                "dp_rank": self.dp_rank,
                "last_event_id": self.last_event_id,
                "blocks": [[parent, h] for h, parent in self._blocks.items()],
            }
