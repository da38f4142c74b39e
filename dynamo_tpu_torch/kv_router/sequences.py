"""Active-sequence load prediction per worker.

Verbatim copy of `dynamo_tpu/kv_router/sequences.py`.

The router must estimate each worker's load *including requests it just
routed* that the worker hasn't reported yet (ref: lib/kv-router/src/sequences/
multi_worker.rs ActiveSequencesMultiWorker). Lifecycle per request:
add on routing decision -> mark_prefill_completed on first output token ->
free on completion (ref: section 3.3). Published LoadMetrics snapshots
reconcile drift when they arrive.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

from .protocols import LoadMetrics, WorkerWithDpRank


@dataclasses.dataclass
class _ActiveRequest:
    worker: WorkerWithDpRank
    isl_tokens: int
    overlap_blocks: int
    prefill_pending: bool
    added_at: float


class ActiveSequences:
    def __init__(self, block_size: int) -> None:
        self.block_size = block_size
        self._requests: dict[str, _ActiveRequest] = {}
        # predicted deltas on top of last published worker snapshot
        self._prefill_tokens: dict[WorkerWithDpRank, int] = {}
        self._decode_blocks: dict[WorkerWithDpRank, int] = {}
        self._published: dict[WorkerWithDpRank, LoadMetrics] = {}

    def add_request(
        self,
        request_id: str,
        worker: WorkerWithDpRank,
        isl_tokens: int,
        overlap_blocks: int,
    ) -> None:
        new_prefill = max(0, isl_tokens - overlap_blocks * self.block_size)
        self._requests[request_id] = _ActiveRequest(
            worker, isl_tokens, overlap_blocks, True, time.monotonic()
        )
        self._prefill_tokens[worker] = self._prefill_tokens.get(worker, 0) + new_prefill
        blocks = math.ceil(isl_tokens / self.block_size) if isl_tokens else 0
        self._decode_blocks[worker] = self._decode_blocks.get(worker, 0) + blocks

    def mark_prefill_completed(self, request_id: str) -> None:
        req = self._requests.get(request_id)
        if req is None or not req.prefill_pending:
            return
        req.prefill_pending = False
        new_prefill = max(0, req.isl_tokens - req.overlap_blocks * self.block_size)
        worker = req.worker
        self._prefill_tokens[worker] = max(
            0, self._prefill_tokens.get(worker, 0) - new_prefill
        )

    def free(self, request_id: str) -> None:
        req = self._requests.pop(request_id, None)
        if req is None:
            return
        if req.prefill_pending:
            new_prefill = max(0, req.isl_tokens - req.overlap_blocks * self.block_size)
            self._prefill_tokens[req.worker] = max(
                0, self._prefill_tokens.get(req.worker, 0) - new_prefill
            )
        blocks = math.ceil(req.isl_tokens / self.block_size) if req.isl_tokens else 0
        self._decode_blocks[req.worker] = max(
            0, self._decode_blocks.get(req.worker, 0) - blocks
        )

    def update_published(self, metrics: LoadMetrics) -> None:
        self._published[WorkerWithDpRank(metrics.worker_id, metrics.dp_rank)] = metrics

    def remove_worker(self, worker: WorkerWithDpRank) -> None:
        self._prefill_tokens.pop(worker, None)
        self._decode_blocks.pop(worker, None)
        self._published.pop(worker, None)
        for rid in [r for r, req in self._requests.items() if req.worker == worker]:
            del self._requests[rid]

    def remove_worker_id(self, worker_id: int) -> None:
        """Drop every dp-rank of a deregistered worker."""
        for worker in {
            w for w in (set(self._prefill_tokens) | set(self._decode_blocks)
                        | set(self._published)
                        | {req.worker for req in self._requests.values()})
            if w.worker_id == worker_id
        }:
            self.remove_worker(worker)

    # -- scheduler inputs --------------------------------------------------

    def prefill_tokens(self, worker: WorkerWithDpRank) -> Optional[int]:
        """Predicted not-yet-prefilled tokens queued on the worker."""
        return self._prefill_tokens.get(worker)

    def decode_blocks(self, worker: WorkerWithDpRank) -> Optional[int]:
        """Best estimate of active KV blocks: published snapshot if fresh,
        plus predicted growth from requests routed since."""
        published = self._published.get(worker)
        predicted = self._decode_blocks.get(worker)
        if published is None:
            return predicted
        if predicted is None:
            return published.active_blocks
        # Snapshots lag routing decisions; take the max to avoid dogpiling a
        # worker whose snapshot predates a burst we just sent it.
        return max(published.active_blocks, predicted)

    def kv_usage(self, worker: WorkerWithDpRank) -> Optional[float]:
        published = self._published.get(worker)
        return published.kv_usage if published is not None else None

    def active_request_count(self) -> int:
        return len(self._requests)
