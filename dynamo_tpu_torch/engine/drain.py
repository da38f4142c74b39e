"""Graceful drain: a worker departs without dropping its live streams.

Port of `dynamo_tpu/engine/drain.py`. The DrainCoordinator runs the
departure ladder on SIGTERM, the worker's `drain` verb on the request
plane, or the status server's POST /drain:

  1. announce: flip the worker to draining in discovery (the card's
     runtime_config) and in its LoadMetrics, so routers stop selecting it;
     the scheduler bounces anything that raced the flip with a migrate.
  2. KV handoff: every eligible live decode sequence parks its computed
     pages with the transfer table and emits a migrate frame carrying
     kv_transfer_params and its resume state (seed, generated tokens); the
     frontend's Migration re-dispatches it to a peer that pulls the KV over
     kv_pull and continues the stream with no token re-prefilled.
  3. cooperative replay: a sequence a handoff cannot carry (mid-prefill,
     logits-processor state, waiting) emits a plain migrate; the peer
     replays prompt + generated tokens.
  4. honest error: at DYNT_DRAIN_DEADLINE_SECS whatever remains
     (unclaimed transfers, prefill-only legs) ends with an in-band error.

The worker deregisters only once `drain()` returns: empty, or expired.
Every state change replays against the `drain_ladder` spec
(`runtime/conformance.py`) when DYNT_CONFORMANCE is on.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ..config import env
from ..runtime import conformance
from ..runtime.metrics import DRAIN_DURATION_MS, DRAIN_SEQUENCES, DRAIN_STATE

log = logging.getLogger("dynamo_tpu_torch.drain")

SERVING, DRAINING, DRAINED = "serving", "draining", "drained"
_STATE_CODE = {SERVING: 0, DRAINING: 1, DRAINED: 2}


def set_drain_state(instance_id: int, state: str) -> None:
    """Export dynamo_drain_state for a worker. Workers stamp SERVING when
    they start serving (the coordinator exists only once a drain starts, so
    without the stamp a dashboard could not tell serving from not scraped);
    the ladder stamps every transition."""
    DRAIN_STATE.labels(worker=f"{instance_id:x}").set(_STATE_CODE[state])
    # every ladder transition, the startup stamp included, flows through
    # here: replay it against the drain_ladder spec
    conformance.observe("drain_ladder", instance_id, state)


class DrainCoordinator:
    """One per worker; owns the departure ladder. Idempotent: the first
    drain() runs the ladder; concurrent and repeated calls (a double
    SIGTERM, a POST /drain racing the signal) await and return the same
    report.

    `worker` surface: .scheduler (InferenceScheduler), .transfers
    (PendingTransferTable), .instance_id, .register_drain_handoff(seq,
    page_ids, computed) -> params or None, and async .announce_draining()."""

    def __init__(self, worker, deadline_secs: Optional[float] = None,
                 handoff: Optional[bool] = None) -> None:
        self.worker = worker
        self.deadline_secs = (env("DYNT_DRAIN_DEADLINE_SECS")
                              if deadline_secs is None else deadline_secs)
        self.handoff_enabled = (bool(env("DYNT_DRAIN_HANDOFF"))
                                if handoff is None else handoff)
        self.state = SERVING
        self._task: Optional[asyncio.Task] = None
        self._set_state(SERVING)

    def _set_state(self, state: str) -> None:
        self.state = state
        set_drain_state(self.worker.instance_id, state)

    async def drain(self, reason: str = "signal") -> dict:
        """Run (or join) the departure ladder; returns the drain report."""
        if not env("DYNT_DRAIN_ENABLE"):
            return {"skipped": True, "reason": "DYNT_DRAIN_ENABLE=0"}
        if self._task is None:
            self._task = asyncio.create_task(self._run(reason))
        return await asyncio.shield(self._task)

    async def _run(self, reason: str) -> dict:
        worker = self.worker
        scheduler = worker.scheduler
        start = time.monotonic()
        deadline = start + max(0.5, self.deadline_secs)
        self._set_state(DRAINING)
        log.info("drain starting (%s): deadline %.1fs handoff=%s",
                 reason, self.deadline_secs, self.handoff_enabled)
        # 1. announce; from here the scheduler bounces raced arrivals
        try:
            await worker.announce_draining()
        except Exception:  # noqa: BLE001 — an announce failure must not
            # stop the vacate; routers still converge through lease expiry
            log.exception("drain announce failed; continuing")
        # One event tick for routers to apply the flip before migrate frames
        # ask them to re-dispatch (else a handoff replay races straight back
        # here and bounces), bounded by the remaining budget.
        settle = min(float(env("DYNT_DRAIN_ANNOUNCE_SETTLE_SECS")),
                     max(0.0, deadline - time.monotonic() - 1.0))
        if settle > 0:
            await asyncio.sleep(settle)
        # 2 + 3. vacate live sequences on the scheduler thread, between
        # steps (pages can change owner safely there)
        register = (worker.register_drain_handoff
                    if self.handoff_enabled else None)
        q = scheduler.run_in_step(
            lambda: scheduler.drain_sweep(register_handoff=register))
        try:
            report, exc = await asyncio.to_thread(
                q.get, True, max(1.0, deadline - time.monotonic()))
        except Exception as exc_:  # noqa: BLE001 — queue.Empty: the
            # scheduler thread is wedged; fall through to the deadline rung
            report, exc = None, exc_
        if exc is not None:
            log.error("drain sweep failed: %r", exc)
            report = {"handoff": [], "replay": [], "pending": [],
                      "sweep_error": repr(exc)}
        # Wait for peers to pull the parked handoffs and for prefill-only
        # transfers to finish, bounded by the deadline.
        errored = 0
        while time.monotonic() < deadline:
            active, waiting = scheduler.queue_depth()
            if active == 0 and waiting == 0 and len(worker.transfers) == 0:
                break
            await asyncio.sleep(0.05)
        else:
            # 4. the deadline rung: expire unclaimed transfers (a peer's
            # late pull then sees "unknown transfer" and replays), then end
            # whatever is still live with an honest error
            expired = worker.transfers.expire_all()
            q = scheduler.run_in_step(
                lambda: scheduler.drain_expire(
                    "worker drain deadline exceeded"))
            try:
                errored, exc = await asyncio.to_thread(q.get, True, 10.0)
            except Exception as exc_:  # noqa: BLE001 — queue.Empty
                errored, exc = 0, exc_
            if exc is not None:
                log.error("drain expire failed: %r", exc)
                errored = 0
            if expired or errored:
                log.warning("drain deadline: expired %d transfer(s), "
                            "errored %d live sequence(s)", expired, errored)
        duration_ms = (time.monotonic() - start) * 1e3
        report = {
            **report,
            "reason": reason,
            "bounced": scheduler.stats.drain_bounced,
            "errored": errored,
            "completed": errored == 0 and not report.get("sweep_error"),
            "duration_ms": round(duration_ms, 3),
        }
        for outcome, count in (("handoff", len(report["handoff"])),
                               ("replay", len(report["replay"])),
                               ("error", errored)):
            if count:
                DRAIN_SEQUENCES.labels(outcome=outcome).inc(count)
        DRAIN_DURATION_MS.labels(
            worker=f"{worker.instance_id:x}").set(duration_ms)
        self._set_state(DRAINED)
        log.info("drain complete in %.0fms: %d handoff, %d replay, "
                 "%d errored, %d bounced", duration_ms,
                 len(report["handoff"]), len(report["replay"]), errored,
                 report["bounced"])
        return report
