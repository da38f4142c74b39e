"""Cold-start ladder — arrival-side observability.

Port of `dynamo_tpu/engine/coldstart.py`. A joining worker walks `fetch ->
load -> compile -> register -> first_token`; each rung is stamped into the
flight recorder and the `dynamo_coldstart_*` metric families, and the
completed total is the planner's scale-up lead time (a planner that knows
arrivals take T seconds projects demand T seconds ahead).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Optional

from ..config import env
from ..runtime import conformance
from ..runtime.flight_recorder import get_recorder
from ..runtime.metrics import (
    COLDSTART_ARRIVALS,
    COLDSTART_PHASE_SECONDS,
    COLDSTART_TOTAL_SECONDS,
)

log = logging.getLogger("dynamo_tpu_torch.coldstart")

PHASES = ("fetch", "load", "compile", "register", "first_token")

# Latest completed ladder totals, process-wide: the planner's lead-time
# source. Guarded by a lock — ladders complete on worker event loops, a
# planner may read from another thread.
_lock = threading.Lock()
_last_total: Optional[float] = None
_ewma_total: Optional[float] = None
_EWMA_ALPHA = 0.3


def _record_total(total: float) -> None:
    global _last_total, _ewma_total
    with _lock:
        _last_total = total
        _ewma_total = (total if _ewma_total is None
                       else _EWMA_ALPHA * total
                       + (1.0 - _EWMA_ALPHA) * _ewma_total)


def observed_cold_start_secs() -> Optional[float]:
    """Smoothed cold-start total across this process's completed arrivals
    (None until one completes). The planner's lead time."""
    with _lock:
        return _ewma_total


def last_cold_start_secs() -> Optional[float]:
    with _lock:
        return _last_total


def reset_observations() -> None:
    """Test isolation hook."""
    global _last_total, _ewma_total
    with _lock:
        _last_total = None
        _ewma_total = None


class ColdStartLadder:
    """One worker's walk up the arrival ladder. Phases may be stamped with
    the `phase` context manager or recorded directly with `mark`;
    `first_token()` closes the ladder."""

    def __init__(self, worker: str, source: str = "unknown") -> None:
        self.worker = worker
        self.source = source        # weights source the fetch resolved
        self.started = time.monotonic()
        self.phases: dict[str, float] = {}
        self.total: Optional[float] = None

    @contextlib.contextmanager
    def phase(self, name: str):
        assert name in PHASES, name
        t0 = time.monotonic()
        try:
            yield self
        finally:
            self.mark(name, time.monotonic() - t0)

    def mark(self, name: str, seconds: float) -> None:
        assert name in PHASES, name
        if self.total is not None:
            # Ladder closed (first_token published the total and the
            # EWMA): a late mark — a lazy graph capture after the first
            # served token — must not mutate the settled record.
            return
        conformance.observe("coldstart", f"{self.worker}:{id(self)}", name)
        self.phases[name] = self.phases.get(name, 0.0) + seconds
        COLDSTART_PHASE_SECONDS.labels(
            worker=self.worker, phase=name).set(self.phases[name])
        get_recorder().event(None, "coldstart_phase", worker=self.worker,
                             phase=name,
                             seconds=round(self.phases[name], 4))

    def first_token(self) -> Optional[float]:
        """Stamp the terminal rung and publish the total. Idempotent — only
        the first served token closes the ladder."""
        if self.total is not None:
            return self.total
        now = time.monotonic()
        accounted = sum(self.phases.values())
        self.mark("first_token", max(0.0, (now - self.started) - accounted))
        self.total = now - self.started
        COLDSTART_TOTAL_SECONDS.labels(worker=self.worker).set(self.total)
        COLDSTART_ARRIVALS.labels(source=self.source).inc()
        _record_total(self.total)
        get_recorder().event(None, "coldstart_complete",
                             worker=self.worker, source=self.source,
                             total_secs=round(self.total, 4),
                             **{f"{k}_secs": round(v, 4)
                                for k, v in self.phases.items()})
        log.info("cold start complete in %.2fs (%s): %s", self.total,
                 self.source,
                 " ".join(f"{k}={self.phases.get(k, 0.0):.2f}s"
                          for k in PHASES))
        budget = float(env("DYNT_COLDSTART_BUDGET_SECS"))
        if budget > 0 and self.total > budget:
            log.warning(
                "cold start %.2fs exceeded the pinned budget %.2fs "
                "(DYNT_COLDSTART_BUDGET_SECS); slowest phase: %s",
                self.total, budget,
                max(self.phases, key=lambda k: self.phases[k]))
        return self.total

    def report(self) -> dict:
        return {"worker": self.worker, "source": self.source,
                "total_secs": self.total,
                "phases": {k: self.phases.get(k) for k in PHASES}}
