"""Offload manager: asynchronous G1 -> G2 movement with a bounded queue.

Port of `dynamo_tpu/block_manager/offload.py`. The paged KV lives in the
pool the captured step graphs read and write, so device gathers must be
ordered with engine steps: the manager's own thread only STAGES work. Each
gather is submitted to the scheduler thread through a `run_in_step`
executor (the scheduler's `run_in_gap`: it runs in the dispatch/drain gap,
queued on the step stream behind the decode block, so it sees every write
of earlier steps), and the D2H copy of its bundle (the runner's
`bundle_to_host`, into one reused page-locked staging buffer, behind the
bundle's event) and the tier writes run on this thread.

Overlap discipline, as the reference's:

  * gathers are split into sub-batches of `DYNT_OFFLOAD_SUBBATCH` pages so
    no single gather holds the gap for long;
  * sub-batches are double-buffered: while bundle k copies and sinks to G2
    here, sub-batch k+1's gather is already submitted;
  * a bandwidth budget (`DYNT_OFFLOAD_BW_FRAC`) defers the next gather
    after each one by the gather closure's own step-thread time scaled by
    1/frac - 1 (at least one step apart under load);
  * the pending queue is bounded (`DYNT_OFFLOAD_QUEUE_CAP`, drop-oldest,
    counted in dynamo_kvbm_offload_dropped_total): offload is best-effort
    cache population, never backpressure;
  * every block leaves a batch sunk, re-queued, skipped, or counted in
    `dropped`, exactly once.

Onboard (G2/G3/G4 -> G1) stays synchronous at admission, in the scheduler:
it replaces prefill compute. The reference's per-batch trace span is left
out (the port has no tracer).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import env
from ..runtime.metrics import (
    KVBM_OFFLOAD_DEFERRED,
    KVBM_OFFLOAD_DROPPED,
    KVBM_OFFLOAD_QUEUE_DEPTH,
)

log = logging.getLogger("dynamo_tpu_torch.kvbm.offload")

# gather executor: takes a zero-arg fn, returns a Queue of (result, exc) —
# the signature of InferenceScheduler.run_in_step / run_in_gap.
GatherExecutor = Callable[[Callable[[], object]], "object"]


class OffloadManager:
    def __init__(
        self,
        *,
        lookup_pages: Callable[[list[int]], list[Optional[int]]],
        gather: Callable[[np.ndarray], object],
        run_in_step: Optional[GatherExecutor],
        sink: Callable[[int, torch.Tensor, Optional[int]], None],
        batch_size: int = 8,
        skip: Optional[Callable[[int], bool]] = None,
        bw_frac: Optional[float] = None,
        subbatch: Optional[int] = None,
        queue_cap: Optional[int] = None,
        gather_timeout: float = 30.0,
        step_pressure: Optional[Callable[[], float]] = None,
        to_host: Optional[Callable] = None,
    ) -> None:
        """lookup_pages: hash -> current G1 page (None if evicted since);
        gather: page-ids -> device bundle (scheduler-thread only);
        run_in_step: serializes `gather` with engine steps (None = call
        inline, for tests/mocker); sink: receives (hash, block, parent).
        bw_frac/subbatch/queue_cap default from the DYNT_OFFLOAD_* knobs;
        step_pressure (optional) returns the engine's recent step wall
        time in ms — under load the budget also spaces gathers at least
        one step apart. to_host (optional) copies a device bundle (the
        runner's DeviceBundle) to the host on this thread,
        `to_host(bundle, out=staging)`: the runner's `bundle_to_host`,
        into one reused page-locked staging buffer; without it, `gather`
        returns host tensors."""
        self._lookup = lookup_pages
        self._gather = gather
        self._run_in_step = run_in_step
        self._sink = sink
        self._skip = skip or (lambda h: False)
        self._batch = batch_size
        self._bw_frac = float(env("DYNT_OFFLOAD_BW_FRAC")
                              if bw_frac is None else bw_frac)
        self._subbatch = max(1, int(env("DYNT_OFFLOAD_SUBBATCH")
                                    if subbatch is None else subbatch))
        self._queue_cap = max(1, int(env("DYNT_OFFLOAD_QUEUE_CAP")
                                     if queue_cap is None else queue_cap))
        self._gather_timeout = gather_timeout
        self._step_pressure = step_pressure
        self._to_host = to_host
        self._staging: Optional[torch.Tensor] = None
        self._pending: list[tuple[int, Optional[int]]] = []  # (hash, parent)
        self._cond = threading.Condition()
        self._stop = False
        self._inflight = 0
        # Budget state: no gather before this monotonic instant.
        self._next_gather_at = 0.0
        self.dropped = 0  # blocks dropped at the queue cap (mirror of the
        # dynamo_kvbm_offload_dropped_total counter, for tests/usage())
        # Bytes sunk, and the seconds this thread spent in the D2H copies
        # and in the tier sinks (the offload's rates; this thread only)
        self.sunk_bytes = 0
        self.copy_seconds = 0.0
        self.sink_seconds = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kvbm-offload")
        self._thread.start()

    # -- producer side (scheduler thread) ---------------------------------

    def notify_stored(self, hashes: list[int], parent: Optional[int]) -> None:
        """G1 registered new blocks: queue device→host offload. Called from
        the PagePool on_stored hook. The queue is bounded: a store burst
        past DYNT_OFFLOAD_QUEUE_CAP drops the OLDEST queued blocks (they
        are the least likely to still be in G1 by gather time)."""
        items = []
        prev = parent
        for h in hashes:
            if not self._skip(h):
                items.append((h, prev))
            prev = h
        self._append_bounded(items)

    def _append_bounded(self, items: list) -> None:
        """Append to the pending queue under the cap: overflow drops the
        OLDEST entries (counted), depth gauge updated, worker notified.
        Shared by notify_stored and the timeout re-queue path."""
        with self._cond:
            self._pending.extend(items)
            overflow = len(self._pending) - self._queue_cap
            if overflow > 0:
                del self._pending[:overflow]
                self.dropped += overflow
                KVBM_OFFLOAD_DROPPED.labels().inc(overflow)
            KVBM_OFFLOAD_QUEUE_DEPTH.labels().set(len(self._pending))
            self._cond.notify()

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def dropped_count(self) -> int:
        """Locked read of the dropped counter for cross-thread callers
        (manager.usage() runs on the scheduler/loop side while the
        worker thread increments)."""
        with self._cond:
            return self.dropped

    # -- worker thread -----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait(timeout=0.2)
                if self._stop and not self._pending:
                    return
                batch = self._pending[: self._batch]
                del self._pending[: self._batch]
                KVBM_OFFLOAD_QUEUE_DEPTH.labels().set(len(self._pending))
                self._inflight += 1
            try:
                self._offload_batch(batch)
            except Exception:  # noqa: BLE001 — offload is best-effort
                log.exception("offload batch failed (%d blocks)", len(batch))
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _offload_batch(self, batch: list[tuple[int, Optional[int]]]) -> None:
        self._do_offload_batch(batch)

    def _do_offload_batch(self, batch) -> int:
        """Sub-batched, double-buffered offload: sub-batch k+1's gather is
        submitted to the step thread BEFORE bundle k's D2H + tier sink run
        here, so the transfer of one bundle overlaps the gather of the
        next. Returns total bytes sunk.

        Exactly-once ledger: every block leaves this function either
        sunk, re-queued (gather timeout), legitimately skipped (evicted
        from G1 before gather / shutdown), or COUNTED as dropped. A
        mid-batch exception (sink tier full, gather blowup) previously
        vanished the batch's remaining blocks with no trace — the
        dropped counter is the contract that offload loss is always
        visible (DJ5xx sweep)."""
        subs = [batch[i : i + self._subbatch]
                for i in range(0, len(batch), self._subbatch)]
        pending: Optional[tuple[list, object, list]] = None
        total_bytes = 0
        acct = [0]  # blocks sunk, re-queued, or skipped so far —
        # _sink_bundle advances it PER BLOCK so a sink failing midway
        # through a bundle never counts its already-sunk blocks as lost
        inflight = None  # submitted-but-not-awaited gather handle
        try:
            for sub in subs:
                if self._stop:
                    acct[0] += len(sub)  # shutdown: deliberate drop
                    continue
                self._throttle()
                inflight = self._submit_gather(sub)
                if pending is not None:
                    total_bytes += self._sink_bundle(*pending, acct=acct)
                    pending = None
                handle, inflight = inflight, None
                pending = self._await_gather(handle, sub)
                if pending is None:
                    acct[0] += len(sub)  # re-queued or evicted
            if pending is not None:
                total_bytes += self._sink_bundle(*pending, acct=acct)
                pending = None
            return total_bytes
        except Exception:
            if inflight is not None and self._run_in_step is not None:
                # A gather was submitted but never awaited (the sink
                # between submit and await raised): abandon the queued
                # closure so it no-ops instead of running an orphaned,
                # budget-uncharged gather on the step thread.
                inflight[1].set()
            lost = len(batch) - acct[0]
            if lost > 0:
                # Under _cond like every other `dropped` touch: the
                # scheduler thread reads the counter through
                # dropped_count() while this worker-thread increment
                # lands, and `+=` is a read-modify-write (lost-update
                # race reproduced by tests/test_interleave.py::
                # test_offload_dropped_counter_lost_update).
                with self._cond:
                    self.dropped += lost
                KVBM_OFFLOAD_DROPPED.labels().inc(lost)
                log.warning("offload batch failed mid-way; %d block(s) "
                            "dropped (counted)", lost)
            raise

    def _submit_gather(self, sub: list):
        """Dispatch the device gather for one sub-batch. With an executor,
        returns (result queue, abandon event); inline mode returns the
        result directly. The abandon event is set when the waiter gives
        up (timeout/close): a closure still sitting in the scheduler's
        gap queue then returns immediately instead of running an
        orphaned gather whose step-thread time nobody charges to the
        budget — and whose blocks the re-queued retry gathers again."""
        hashes = [h for h, _ in sub]
        abandoned = threading.Event()

        def gather_on_sched():
            if abandoned.is_set():
                return [], None, 0.0
            # Resolve hash->page at gather time ON the scheduler thread:
            # eviction also only runs there, so the mapping cannot go stale
            # between lookup and gather. Only the DEVICE gather runs here
            # (a fresh buffer, microseconds on real silicon); the D2H copy
            # happens on the OFFLOAD thread so decode stepping overlaps
            # the transfer. The closure times itself so the bandwidth
            # budget charges exactly the step-thread time it consumed.
            t0 = time.perf_counter()
            pages = self._lookup(hashes)
            keep = [i for i, p in enumerate(pages) if p is not None]
            if not keep:
                return [], None, time.perf_counter() - t0
            ids = np.asarray([pages[i] for i in keep], np.int32)
            bundle = self._gather(ids)
            return keep, bundle, time.perf_counter() - t0

        if self._run_in_step is None:
            return gather_on_sched()
        return self._run_in_step(gather_on_sched), abandoned

    def _await_gather(self, handle, sub: list):
        """Wait for a submitted gather, honoring close() and re-queueing
        the sub-batch on timeout (a wedged scheduler must not wedge the
        offload thread — satellite fix for the old hard 30s `.get`)."""
        if self._run_in_step is None:
            keep, bundle, g = handle
            self._charge_budget(g)
            return (keep, bundle, sub) if bundle is not None else None
        resultq, abandoned = handle
        deadline = time.monotonic() + self._gather_timeout
        while True:
            try:
                result, exc = resultq.get(timeout=0.5)
                break
            except Exception:  # noqa: BLE001 — queue.Empty: keep waiting
                if self._stop:
                    # Closing: the scheduler's final control drain may
                    # still run the (now no-op) closure, but nobody
                    # needs the result.
                    abandoned.set()
                    return None
                if time.monotonic() >= deadline:
                    log.warning(
                        "offload gather timed out after %.0fs; re-queueing "
                        "%d blocks", self._gather_timeout, len(sub))
                    abandoned.set()
                    self._requeue(sub)
                    return None
        if exc is not None:
            raise exc
        keep, bundle, g = result
        self._charge_budget(g)
        if bundle is None:
            return None
        return keep, bundle, sub

    def _requeue(self, sub: list) -> None:
        self._append_bounded(sub)

    def _host_bundle(self, bundle) -> torch.Tensor:
        """The gathered bundle on the host. A device bundle goes through
        `to_host` into the reused page-locked staging buffer (grown to the
        sub-batch's shape on first use): one DMA copy, waited for here,
        on this thread, never on the scheduler's."""
        if self._to_host is None:
            return bundle
        tensor = getattr(bundle, "tensor", bundle)
        if tensor.device.type == "cpu":
            return tensor
        n, rest = tensor.shape[0], tuple(tensor.shape[1:])
        staging = self._staging
        if (staging is None or tuple(staging.shape[1:]) != rest
                or staging.dtype != tensor.dtype or staging.shape[0] < n):
            staging = self._staging = torch.empty(
                (max(n, self._subbatch),) + rest, dtype=tensor.dtype,
                pin_memory=True)
        return self._to_host(bundle, out=staging[:n])

    def _sink_bundle(self, keep: list, bundle, sub: list,
                     acct: Optional[list] = None) -> int:
        # The slow half, off the step thread: one contiguous D2H of the
        # whole bundle, then per-block sink. `acct` (the batch ledger)
        # advances per block AS IT SINKS, plus the evicted-before-gather
        # blocks up front, so a tier failing midway counts only the
        # genuinely unsunk blocks as dropped.
        if acct is not None:
            # Credit the evicted-before-gather blocks BEFORE the D2H: they
            # are "nothing to sink" whether or not the transfer below
            # blows up, and must never count as dropped.
            acct[0] += len(sub) - len(keep)
        t0 = time.perf_counter()
        host = self._host_bundle(bundle)
        t1 = time.perf_counter()
        for j, i in enumerate(keep):
            h, parent = sub[i]
            self._sink(h, host[j], parent)
            if acct is not None:
                acct[0] += 1
        nbytes = host.numel() * host.element_size()
        self.copy_seconds += t1 - t0
        self.sink_seconds += time.perf_counter() - t1
        self.sunk_bytes += nbytes
        return int(nbytes)

    # -- bandwidth budget --------------------------------------------------

    def _charge_budget(self, gather_secs: float) -> None:
        """A gather that held the step thread for g seconds earns an idle
        gap of g*(1/frac - 1): over time the offload path holds at most
        `frac` of wall time. Under step-time pressure (a reported recent
        step wall time), gathers are additionally spaced at least one
        engine step apart — one sub-batch per dispatch/drain gap."""
        if self._bw_frac <= 0:
            return
        gap = gather_secs * (1.0 / self._bw_frac - 1.0)
        if self._step_pressure is not None:
            try:
                gap = max(gap, float(self._step_pressure()) / 1e3)
            except Exception:  # noqa: BLE001 — pressure is advisory
                pass
        self._next_gather_at = time.monotonic() + gap

    def _throttle(self) -> None:
        """Interruptible wait for the budget window (close() aborts it).
        Deferred time is measured as ELAPSED monotonic time — the wait
        condition is shared with notify_stored, so a store burst wakes
        the wait spuriously and counting requested timeouts would
        overcount by orders of magnitude."""
        start = time.monotonic()
        with self._cond:
            while not self._stop:
                remaining = self._next_gather_at - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=min(0.2, remaining))
        waited = time.monotonic() - start
        if waited > 1e-3:
            KVBM_OFFLOAD_DEFERRED.labels().inc(waited)

    # -- lifecycle ---------------------------------------------------------

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until the queue drains (tests / graceful shutdown)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pending or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(0.2, remaining))
        return True

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
