"""Router-tier admission queue: gate scheduling behind worker capacity.

Under saturation the reference router does NOT route immediately — requests
park in a priority queue and drain as workers free capacity, with pluggable
ordering policies (ref: lib/kv-router/src/scheduling/queue.rs SchedulerQueue,
scheduling/policy.rs):

  * fcfs — key = priority_jump - arrival_offset. Pure (adjusted) arrival
    order; optimizes tail TTFT.
  * lcfs — key = priority_jump + arrival_offset. Favors newest arrivals;
    for policy experiments.
  * wspt — Weighted Shortest Processing Time (Smith's rule):
    key = (1 + priority_jump) / new_tokens, new_tokens = isl minus the best
    cached overlap (the selector routes to the best-overlap worker, so the
    realized overlap is well-approximated by the best available). Optimizes
    MEAN TTFT: short or well-cached requests jump long cold ones.

Higher key schedules first, WITHIN a priority class: the parked heap is
class-strict (interactive > standard > batch, docs/multi-tenancy.md) —
a newly arrived higher-class request overtakes every parked lower-class
entry at drain time, so batch backlog can never head-of-line-block
interactive traffic. The busy check parks a request only when EVERY
eligible worker sits above `threshold_frac` of its token budget
(ref: queue.rs all_workers_busy); requests pinned to specific workers by
the caller bypass the check, matching the reference's allowed_worker_ids
escape hatch. `update()` is called on prefill-complete/free and drains in
priority order while capacity lasts — each drained request books its load
via add_request so the next busy check sees fresh state.

Port of `dynamo_tpu/kv_router/queue.py` with the same policies, keys and
drain order. A request about to park is first checked as the reference
checks it (runtime/admission.py): a tenant over its weighted fair share is
refused, then a deadline that cannot survive the backlog ahead of it at the
measured drain rate (the entries this queue dequeues). Both raise
AdmissionRefused, which the frontend answers with 503 and Retry-After.
"""

from __future__ import annotations

import asyncio
import dataclasses
import heapq
import itertools
import logging
import time
from typing import Callable, Optional, Sequence

from ..llm.protocols import class_rank
from ..runtime.admission import (
    QueueWaitEstimator,
    check_admission,
    check_tenant_admission,
    get_tenant_ledger,
)
from ..runtime.resilience import Deadline
from .protocols import OverlapScores, WorkerWithDpRank
from .scheduler import KvScheduler, SelectionResult

log = logging.getLogger("dynamo_tpu_torch.kv_router.queue")

# Effectively disables the token-budget gate for workers that don't publish
# one (ref: queue.rs DEFAULT_MAX_BATCHED_TOKENS).
DEFAULT_MAX_BATCHED_TOKENS = 10_000_000


@dataclasses.dataclass
class QueuedRequest:
    """What the queue needs to order, gate, and finally schedule a request.

    When `request_id` is set the queue books the selection into the slot
    tracker itself (scheduler.add_request) the moment the decision is made —
    synchronously, so the drain loop's next busy check sees the load and one
    free slot can't dogpile the whole backlog onto a single worker
    (ref: queue.rs schedule() -> slots.add_request)."""

    candidates: list[WorkerWithDpRank]
    block_hashes: Sequence[int]
    isl_tokens: int
    priority_jump: float = 0.0
    pinned: bool = False  # caller fixed the worker set: bypass the gate
    overlaps: Optional[OverlapScores] = None
    request_id: Optional[str] = None
    # End-to-end deadline budget (runtime/resilience.py): a request about to
    # park is refused (AdmissionRefused -> 503 + Retry-After) when it cannot
    # survive the backlog, instead of parking to a late 504.
    deadline: Optional[Deadline] = None
    # Session-affinity residency (dynamo_tpu/session): the worker id a
    # live session last landed on; the selector biases toward it.
    affinity_worker: Optional[int] = None
    # Multi-tenant QoS (docs/multi-tenancy.md): class is STRICT in the
    # parking heap — every interactive entry drains before any standard
    # entry, which drains before any batch entry; the policy key only
    # orders WITHIN a class. tenant keys the fair-share quota check when
    # the request is about to park.
    priority_class: str = "standard"
    tenant: str = ""


def fcfs_key(arrival_offset: float, req: QueuedRequest,
             block_size: int) -> float:
    return max(req.priority_jump, 0.0) - arrival_offset


def lcfs_key(arrival_offset: float, req: QueuedRequest,
             block_size: int) -> float:
    return max(req.priority_jump, 0.0) + arrival_offset


def wspt_key(arrival_offset: float, req: QueuedRequest,
             block_size: int) -> float:
    weight = 1.0 + max(req.priority_jump, 0.0)
    best_overlap = max(req.overlaps.scores.values(), default=0) \
        if req.overlaps is not None else 0
    new_tokens = max(req.isl_tokens - best_overlap * block_size, 1)
    return weight / new_tokens


POLICIES: dict[str, Callable[[float, QueuedRequest, int], float]] = {
    "fcfs": fcfs_key,
    "lcfs": lcfs_key,
    "wspt": wspt_key,
}


class SchedulerQueue:
    """Admission gate in front of a KvScheduler.

    `threshold_frac=None` disables queueing entirely: every request
    schedules immediately (the reference default until the queue feature is
    switched on).
    """

    def __init__(
        self,
        scheduler: KvScheduler,
        threshold_frac: Optional[float] = None,
        policy: str = "fcfs",
        max_batched_tokens: Optional[Callable[[WorkerWithDpRank],
                                              Optional[int]]] = None,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(
                f"unknown queue policy {policy!r} (expected "
                f"{'|'.join(POLICIES)})")
        self.scheduler = scheduler
        self.threshold_frac = threshold_frac
        self.policy_name = policy
        self._key_fn = POLICIES[policy]
        self._max_batched = max_batched_tokens or (lambda w: None)
        # heapq is a min-heap; store (-class_rank, -key). Class rank
        # leads the tuple so drain order is class-STRICT: a newly
        # arrived interactive entry lands ahead of every parked batch
        # entry and update() pops it first — the parked-entry priority
        # inversion fix (an arrival-offset-bearing key would otherwise
        # let a long-parked batch entry outrank a fresh interactive
        # one). The monotone tiebreak keeps equal-key entries FIFO and
        # makes entries totally ordered so the heap never compares
        # QueuedRequest objects.
        self._heap: list[tuple[int, float, int, QueuedRequest,
                               asyncio.Future]] = []
        self._seq = itertools.count()
        self._start = time.monotonic()
        self._ticker: Optional[asyncio.Task] = None
        # Worker load includes snapshots PUBLISHED by workers (other router
        # replicas' traffic) — capacity can return without any local
        # prefill-complete/free event. A periodic drain tick while anything
        # is parked covers that path.
        self.tick_interval = 0.25
        # Deadline-aware admission over the parking heap: drains are the
        # entries update() dequeues; the depth a new arrival waits behind
        # is the heap itself (passed as `extra` at check time).
        self.wait_estimator = QueueWaitEstimator(pool="router_queue")

    # -- introspection ------------------------------------------------------

    @property
    def pending_count(self) -> int:
        return len(self._heap)

    # -- admission ----------------------------------------------------------

    def _worker_busy(self, worker: WorkerWithDpRank, threshold: float) -> bool:
        seq = self.scheduler.sequences
        budget = self._max_batched(worker)
        if budget is None:
            budget = DEFAULT_MAX_BATCHED_TOKENS
        block_size = self.scheduler.config.block_size
        prefill = seq.prefill_tokens(worker)
        decode_blocks = seq.decode_blocks(worker)
        active_tokens = (prefill or 0) + (decode_blocks or 0) * block_size
        return active_tokens > threshold * budget

    def _all_busy(self, candidates: Sequence[WorkerWithDpRank],
                  threshold: float) -> bool:
        # No eligible workers -> NOT busy: fall through to select_worker,
        # which raises the proper no-candidates error (ref: queue.rs
        # all_workers_busy returning false when nothing was checked).
        checked = False
        for worker in candidates:
            checked = True
            if not self._worker_busy(worker, threshold):
                return False
        return checked

    async def schedule(self, req: QueuedRequest) -> SelectionResult:
        """Route `req` now if capacity allows, else park until update()
        drains it. Returns the worker selection; the request is already
        booked into the slot tracker (add_request is the caller's job,
        matching KvScheduler's existing lifecycle split)."""
        if req.overlaps is None:
            req.overlaps = self.scheduler.indexer.find_matches(
                list(req.block_hashes))
        threshold = self.threshold_frac
        # A non-empty backlog gates new arrivals too (ref: queue.rs
        # enqueue): letting a fresh request grab freed capacity ahead of
        # parked ones would invert fcfs/priority exactly under the load the
        # queue exists for.
        if threshold is None or req.pinned or (
                not self._heap
                and not self._all_busy(req.candidates, threshold)):
            return self._select(req)
        # About to park: a tenant over its fair share is refused first
        # (parking is contention), then a budget that cannot survive the
        # backlog ahead of it. tokens=0: the entry edge already deposited
        # this request's cost. Only entries of its class or better are
        # ahead of it; an empty heap estimates no wait.
        check_tenant_admission(get_tenant_ledger(), req.tenant, 0,
                               contended=True)
        rank = class_rank(req.priority_class)
        ahead = sum(1 for neg_rank, *_ in self._heap if -neg_rank >= rank)
        check_admission(self.wait_estimator, req.deadline, extra=ahead,
                        tenant=req.tenant)
        arrival = time.monotonic() - self._start
        key = self._key_fn(arrival, req, self.scheduler.config.block_size)
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        heapq.heappush(self._heap, (-rank, -key, next(self._seq), req,
                                    future))
        log.debug("workers busy or backlog pending; parked request "
                  "(pending=%d)", len(self._heap))
        self._ensure_ticker()
        # Drain immediately: if capacity exists (we parked only to keep
        # ordering), the highest-priority entry — possibly this one —
        # schedules now.
        self.update()
        try:
            # Yield once: if update() resolved earlier-parked futures AND
            # ours, their tasks were scheduled first and must resume
            # (dispatch) first — awaiting an already-done future does not
            # suspend. Inside the try: a cancellation landing on this yield
            # after our grant was booked must hit the unbook handler below.
            await asyncio.sleep(0)
            return await future
        except asyncio.CancelledError:
            # Two flavors of dead entry: still parked (skipped at drain
            # time via future.done()) or already drained — update() booked
            # its load via add_request, and with the awaiter cancelled
            # nobody will ever free it. Unbook here.
            if (req.request_id is not None and future.done()
                    and not future.cancelled()
                    and future.exception() is None):
                self.scheduler.free(req.request_id)
            raise

    def _select(self, req: QueuedRequest) -> SelectionResult:
        result = self.scheduler.select_worker(
            req.candidates, list(req.block_hashes), req.isl_tokens,
            overlaps=req.overlaps, affinity_worker=req.affinity_worker,
        )
        if req.request_id is not None:
            self.scheduler.add_request(req.request_id, result,
                                       req.isl_tokens)
        return result

    def _ensure_ticker(self) -> None:
        if self._ticker is not None and not self._ticker.done():
            return
        self._ticker = asyncio.get_running_loop().create_task(
            self._tick_loop())

    async def _tick_loop(self) -> None:
        while self._heap:
            await asyncio.sleep(self.tick_interval)
            self.update()

    def update(self) -> None:
        """Drain pending requests while capacity lasts. Call after
        prefill-complete and free — the events that return capacity
        (ref: queue.rs update())."""
        threshold = self.threshold_frac
        if threshold is None:
            return
        while self._heap:
            _neg_rank, _neg_key, seq, req, future = self._heap[0]
            if future.done():  # caller gave up (cancelled/timeout)
                heapq.heappop(self._heap)
                continue
            if self._all_busy(req.candidates, threshold):
                return
            heapq.heappop(self._heap)
            # One parked entry drained into service: the rate the admission
            # check divides the backlog by.
            self.wait_estimator.observe_drained(1)
            try:
                # Re-score overlaps at DRAIN time: KV events kept flowing
                # while the request was parked, and routing on the arrival
                # snapshot could chase evicted prefixes. (Policy keys stay
                # frozen at park time — ordering already happened.)
                req.overlaps = self.scheduler.indexer.find_matches(
                    list(req.block_hashes))
                # _select books the load (add_request) before returning, so
                # the next iteration's busy check sees it.
                result = self._select(req)
            except Exception as exc:  # noqa: BLE001 — deliver, don't die
                future.set_exception(exc)
                continue
            future.set_result(result)
