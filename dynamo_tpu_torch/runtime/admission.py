"""Deadline-aware admission control: queue-wait estimation and early shed.

Port of `dynamo_tpu/runtime/admission.py`. Every admission edge (the
frontend and the router's admission queue) consults a per-pool queue-wait
estimate and refuses work whose `x-dynt-deadline-ms` budget cannot survive
it, with 503 and a `Retry-After` from the estimated drain time: an
immediate refusal before any work instead of a late 504 after wasted
prefill.

    wait ~ queue_depth / drain_rate

* depth: the router queue's own heap, or the sum of the workers' published
  `waiting_requests` (LoadMetrics) at the frontend;
* drain_rate: an EWMA of drain events (first tokens at the frontend,
  dequeues at the router queue) that decays during silence, so a stalled
  pool estimates an unbounded wait and sheds with a capped Retry-After.

It is conservative: no deadline, an empty queue, or no drain ever seen
(cold start) all admit. `TenantLedger` divides a token-rate capacity among
tenants by weight and refuses a tenant over its share under contention.
Every estimate takes an optional `now` (monotonic seconds), so a caller
can drive it on its own clock.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Optional

from ..config import env
from .metrics import ADMISSION_WAIT_MS, REQUESTS_SHED, TENANT_SHED, bounded_label

# Refuse only when the estimated wait exceeds the remaining budget by the
# DYNT_ADMISSION_MARGIN factor *after* leaving this fraction of budget
# for actual service — a request admitted with exactly queue-wait budget
# still 504s mid-prefill.
_INF_WAIT_MS = float("inf")


class AdmissionRefused(RuntimeError):
    """Raised at an admission edge when a request's deadline budget
    cannot survive the estimated queue wait (`reason="queue"`) or a
    tenant is over its weighted fair share under contention
    (`reason="quota"`). Maps to 503 + `Retry-After` at the frontend —
    NOT a transport failure: routers must neither retry it (the
    condition is pool-wide, not per-instance) nor breaker-penalize
    anyone."""

    def __init__(self, message: str, *, retry_after_s: float,
                 est_wait_ms: float, pool: str,
                 reason: str = "queue") -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.est_wait_ms = est_wait_ms
        self.pool = pool
        self.reason = reason


def clamp_retry_after_s(est_wait_ms: float) -> float:
    """Retry-After seconds from an estimated wait, clamped to the
    DYNT_RETRY_AFTER_MIN/MAX_SECS knobs (inf → the cap). The ONE
    clamping rule every admission edge shares."""
    floor = env("DYNT_RETRY_AFTER_MIN_SECS")
    cap = env("DYNT_RETRY_AFTER_MAX_SECS")
    if math.isinf(est_wait_ms):
        return cap
    return min(cap, max(floor, est_wait_ms / 1e3))


@dataclasses.dataclass
class AdmissionDecision:
    admit: bool
    est_wait_ms: float
    retry_after_s: float
    reason: str = ""


class DrainRateEwma:
    """EWMA of drain events per second over irregular sample times.

    Each `observe(n)` folds `n` units drained since the previous
    observation into the rate with exponential age-weighting
    (half-life `halflife_s`). Reads fold in the silent gap since the
    last drain — a pool that stops draining decays toward rate 0
    instead of reporting its last healthy rate forever (the
    stalled-drain edge case)."""

    def __init__(self, halflife_s: float = 5.0) -> None:
        self.halflife_s = max(1e-3, halflife_s)
        self._rate: Optional[float] = None  # units/sec; None = cold
        self._last: Optional[float] = None  # monotonic time of last obs

    def _decay(self, dt: float) -> float:
        return 0.5 ** (dt / self.halflife_s)

    def observe(self, n: float = 1.0, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self._last is None:
            # First observation anchors the clock; a rate needs an
            # interval. Seed optimistically at n per half-life (the next
            # interval corrects it) — seeding at 0 would make the very
            # first queue estimate infinite.
            self._last = now
            if n > 0:
                self._rate = n / self.halflife_s
            return
        dt = max(1e-6, now - self._last)
        inst = n / dt
        w = self._decay(dt)
        self._rate = inst if self._rate is None else (
            w * self._rate + (1.0 - w) * inst)
        self._last = now

    def rate(self, now: Optional[float] = None) -> Optional[float]:
        """Units/sec, decayed by the silence since the last observation;
        None while cold (no drain ever observed). Silence past one
        half-life is folded in as zero drains observed over the gap —
        so a stalled pool decays toward 0 instead of reporting its last
        healthy rate forever, while the grace window keeps ordinary
        inter-event gaps from discounting a live rate."""
        if self._rate is None or self._last is None:
            return None
        now = time.monotonic() if now is None else now
        gap = max(0.0, now - self._last)
        if gap <= self.halflife_s:
            return self._rate
        return self._rate * self._decay(gap - self.halflife_s)


class QueueWaitEstimator:
    """Per-pool queue-wait estimate = depth / drain-rate EWMA.

    Depth comes either from `set_depth` (edges that own their queue, e.g.
    the router admission heap) or from `update_worker` (edges that read
    worker-published LoadMetrics `waiting_requests`; entries expire after
    `worker_ttl_s` so a dead worker's backlog stops counting).

    Every depth input ages out: worker entries after `worker_ttl_s`, and
    the `set_depth` value after the same TTL. A pool that vanishes from
    discovery (cell loss, namespace teardown) therefore decays to an
    empty queue and the edge falls back to admit, instead of estimating
    an unbounded wait forever against a ghost — its last depth frozen
    while its drain EWMA decays to zero."""

    def __init__(self, pool: str = "default",
                 halflife_s: Optional[float] = None,
                 worker_ttl_s: float = 30.0) -> None:
        if halflife_s is None:
            halflife_s = env("DYNT_ADMISSION_HALFLIFE_SECS")
        self.pool = pool
        self.drain = DrainRateEwma(halflife_s)
        self.worker_ttl_s = worker_ttl_s
        self._depth = 0
        self._depth_t: Optional[float] = None  # when set_depth last fired
        self._workers: dict[int, tuple[int, float]] = {}  # id -> (waiting, t)

    # -- inputs ------------------------------------------------------------

    def observe_drained(self, n: float = 1.0,
                        now: Optional[float] = None) -> None:
        self.drain.observe(n, now=now)

    def set_depth(self, depth: int, now: Optional[float] = None) -> None:
        self._depth = max(0, int(depth))
        self._depth_t = time.monotonic() if now is None else now
        self._workers.clear()

    def update_worker(self, worker_id: int, waiting: int,
                      now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._workers[worker_id] = (max(0, int(waiting)), now)

    def forget_worker(self, worker_id: int) -> None:
        """Positive evidence the worker left (discovery delete): drop
        its backlog immediately instead of waiting out the TTL."""
        self._workers.pop(worker_id, None)

    # -- estimates ---------------------------------------------------------

    def depth(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        if not self._workers:
            if self._depth and self._depth_t is not None \
                    and now - self._depth_t > self.worker_ttl_s:
                # The owning edge stopped reporting (pool vanished from
                # discovery): its stale backlog must not shed arrivals
                # forever against a queue nobody serves.
                self._depth = 0
                self._depth_t = None
            return self._depth
        cutoff = now - self.worker_ttl_s
        for wid in [w for w, (_, ts) in self._workers.items() if ts < cutoff]:
            del self._workers[wid]
        return sum(n for n, _ in self._workers.values())

    def estimate_wait_ms(self, extra: int = 0,
                         now: Optional[float] = None) -> float:
        """Estimated queue wait for an arrival behind `depth() + extra`
        units. 0 for an empty queue; inf for a stalled drain (depth > 0
        and the rate has decayed to ~nothing); 0 while cold (no drain
        evidence yet — admit until there is a measured reason not to)."""
        now = time.monotonic() if now is None else now
        ahead = self.depth(now=now) + max(0, extra)
        if ahead <= 0:
            return 0.0
        rate = self.drain.rate(now=now)
        if rate is None:
            return 0.0  # cold start: no evidence of a stall
        if rate <= 1e-9:
            return _INF_WAIT_MS
        return ahead / rate * 1e3

    def retry_after_s(self, est_wait_ms: float) -> float:
        """Honest Retry-After: the estimated time for the backlog to
        drain, clamped to the registered floor/cap knobs."""
        return clamp_retry_after_s(est_wait_ms)

    def check(self, deadline, extra: int = 0,
              now: Optional[float] = None) -> AdmissionDecision:
        """Admission verdict for a request with `deadline` budget (a
        runtime.resilience.Deadline or None). Refuses when the estimated
        wait, scaled by DYNT_ADMISSION_MARGIN (headroom for the service
        time after the queue), exceeds the remaining budget."""
        est = self.estimate_wait_ms(extra=extra, now=now)
        retry_after = self.retry_after_s(est)
        if deadline is None or est <= 0.0:
            return AdmissionDecision(True, est, retry_after)
        remaining_ms = deadline.remaining() * 1e3
        margin = env("DYNT_ADMISSION_MARGIN")
        if est * margin > remaining_ms:
            return AdmissionDecision(
                False, est, retry_after,
                reason=(f"estimated queue wait {est:.0f}ms (pool "
                        f"{self.pool!r}) exceeds remaining deadline "
                        f"budget {remaining_ms:.0f}ms"))
        return AdmissionDecision(True, est, retry_after)

    def refuse(self, decision: AdmissionDecision) -> AdmissionRefused:
        return AdmissionRefused(decision.reason or "admission refused",
                                retry_after_s=decision.retry_after_s,
                                est_wait_ms=decision.est_wait_ms,
                                pool=self.pool)


def parse_tenant_weights(spec: str) -> dict[str, float]:
    """Parse the DYNT_TENANT_WEIGHTS spec: "tenantA=4,tenantB=1".
    Malformed entries are skipped (a config typo must not take the
    serving plane down)."""
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, raw = part.partition("=")
        try:
            weight = float(raw)
        except ValueError:
            continue
        if name.strip() and weight > 0:
            out[name.strip()] = weight
    return out


class TenantLedger:
    """Sliding-window per-tenant token-rate accounting with weighted
    fair-share refusal.

    Every admitted request deposits its token cost (prompt +
    max_tokens) into its tenant's window; `check` refuses a tenant
    that is over its weighted fair share of the configured capacity
    while the system is CONTENDED — so one tenant's flood 503s *that
    tenant* first (shed reason="quota") instead of degrading everyone
    FCFS. Uncontended traffic under the capacity line is never quota-
    refused: quotas are a contention arbiter, not a hard rate limit.

    fair share of tenant t = capacity * w_t / Σ w_active, where the
    active set is the tenants with traffic inside the window. Untagged
    requests (tenant="") and a zero capacity knob disable the check
    entirely — the pre-QoS behavior."""

    def __init__(self, capacity_tps: Optional[float] = None,
                 window_s: Optional[float] = None,
                 weights: Optional[dict[str, float]] = None,
                 default_weight: Optional[float] = None) -> None:
        self.capacity = float(env("DYNT_TENANT_RATE_LIMIT")
                              if capacity_tps is None else capacity_tps)
        self.window_s = max(1e-3, float(env("DYNT_TENANT_WINDOW_SECS")
                                        if window_s is None else window_s))
        self.weights = (parse_tenant_weights(env("DYNT_TENANT_WEIGHTS"))
                        if weights is None else dict(weights))
        self.default_weight = float(
            env("DYNT_TENANT_DEFAULT_WEIGHT")
            if default_weight is None else default_weight)
        # tenant -> deque[(monotonic_t, tokens)]; _sums mirrors the
        # deque totals so rate() is O(expired) not O(window).
        self._events: dict[str, deque] = {}
        self._sums: dict[str, float] = {}

    def weight_of(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)

    def _prune(self, tenant: str, now: float) -> None:
        q = self._events.get(tenant)
        if q is None:
            return
        cutoff = now - self.window_s
        total = self._sums.get(tenant, 0.0)
        while q and q[0][0] < cutoff:
            total -= q.popleft()[1]
        if q:
            self._sums[tenant] = max(0.0, total)
        else:
            self._events.pop(tenant, None)
            self._sums.pop(tenant, None)

    def observe(self, tenant: str, tokens: float,
                now: Optional[float] = None) -> None:
        """Deposit an ADMITTED request's token cost into the window.
        Called once per request at the entry edge (the frontend);
        downstream edges only read."""
        if not tenant or tokens <= 0:
            return
        now = time.monotonic() if now is None else now
        q = self._events.get(tenant)
        if q is None:
            q = self._events[tenant] = deque()
        q.append((now, float(tokens)))
        self._sums[tenant] = self._sums.get(tenant, 0.0) + float(tokens)
        self._prune(tenant, now)

    def _rates(self, now: float) -> dict[str, float]:
        """One prune sweep -> every active tenant's tokens/s. The ONE
        ledger scan an admission decision performs."""
        for tenant in list(self._events):
            self._prune(tenant, now)
        return {t: s / self.window_s for t, s in self._sums.items()}

    def rate(self, tenant: str, now: Optional[float] = None) -> float:
        """Tokens/s the tenant admitted over the sliding window."""
        now = time.monotonic() if now is None else now
        self._prune(tenant, now)
        return self._sums.get(tenant, 0.0) / self.window_s

    def total_rate(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return sum(self._rates(now).values())

    def _share_of(self, tenant: str, rates: dict[str, float]) -> float:
        """Fair share against an already-pruned rate map: the larger
        of the weighted share (tenants active in the window, candidate
        included) and the capacity the OTHER tenants are not using —
        work-conserving, so a lone flooding tenant may use idle
        capacity but is squeezed back to its weighted share the moment
        the others' demand returns (the sliding window forgets its
        burst within DYNT_TENANT_WINDOW_SECS seconds)."""
        active = set(rates) | {tenant}
        total_w = sum(self.weight_of(t) for t in active)
        weighted = (self.capacity if total_w <= 0
                    else self.capacity * self.weight_of(tenant) / total_w)
        others = sum(r for t, r in rates.items() if t != tenant)
        return max(weighted, self.capacity - others)

    def share(self, tenant: str, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return self._share_of(tenant, self._rates(now))

    def check(self, tenant: str, tokens: float, contended: bool = False,
              now: Optional[float] = None) -> AdmissionDecision:
        """Quota verdict for a request costing `tokens` (0 at
        downstream read-only edges — the entry edge already deposited
        the request's cost, re-adding it would double-count it against
        its own share). Admits unless the system is contended
        (caller-observed queueing, or total demand past capacity) AND
        the tenant is over its fair share."""
        if self.capacity <= 0 or not tenant:
            return AdmissionDecision(True, 0.0, 0.0)
        now = time.monotonic() if now is None else now
        rates = self._rates(now)
        incoming = float(tokens) / self.window_s
        total = sum(rates.values())
        if not contended and total + incoming <= self.capacity:
            return AdmissionDecision(True, 0.0, 0.0)
        share = self._share_of(tenant, rates)
        rate = rates.get(tenant, 0.0)
        if rate + incoming <= share:
            return AdmissionDecision(True, 0.0, 0.0)
        # Honest Retry-After: the window fraction that must age out
        # before this tenant is back under its share.
        excess_frac = 1.0 - share / max(rate + incoming, 1e-9)
        retry = clamp_retry_after_s(excess_frac * self.window_s * 1e3)
        return AdmissionDecision(
            False, 0.0, retry,
            reason=(f"tenant {tenant!r} over fair share "
                    f"({rate:.0f}+{incoming:.0f} tok/s > "
                    f"{share:.0f} tok/s of {self.capacity:.0f} capacity)"))

    def reset(self) -> None:
        self._events.clear()
        self._sums.clear()


_tenant_ledger: Optional[TenantLedger] = None


def get_tenant_ledger() -> TenantLedger:
    """Process-wide ledger shared by the frontend and the router queue
    (they run in one process): a flood observed at the entry edge informs
    the downstream check."""
    global _tenant_ledger
    if _tenant_ledger is None:
        _tenant_ledger = TenantLedger()
    return _tenant_ledger


def reset_tenant_ledger() -> None:
    """Drop the singleton (tests / knob changes)."""
    global _tenant_ledger
    _tenant_ledger = None


def check_tenant_admission(ledger: TenantLedger, tenant: str,
                           tokens: float, contended: bool = False,
                           observe: bool = False) -> AdmissionDecision:
    """Quota edge shared by the admission edges: evaluate, count
    the shed (reason="quota", attributed to the tenant), and raise
    AdmissionRefused on refusal. `observe=True` (the entry edge only)
    deposits admitted tokens into the window — downstream edges must
    not double-count."""
    decision = ledger.check(tenant, tokens, contended=contended)
    if not decision.admit:
        REQUESTS_SHED.labels(reason="quota").inc()
        TENANT_SHED.labels(tenant=bounded_label("tenant",
                                                tenant or "untagged"),
                           reason="quota").inc()
        raise AdmissionRefused(
            decision.reason or "tenant quota exceeded",
            retry_after_s=decision.retry_after_s,
            est_wait_ms=decision.est_wait_ms, pool="tenant",
            reason="quota")
    if observe:
        ledger.observe(tenant, tokens)
    return decision


def admission_enabled() -> bool:
    return bool(env("DYNT_ADMISSION_ENABLE"))


def check_admission(estimator: QueueWaitEstimator, deadline,
                    extra: int = 0,
                    tenant: str = "") -> AdmissionDecision:
    """Edge entry point shared by the frontend and the router admission
    queue: evaluate, publish the pool's
    queue-wait gauge, and raise AdmissionRefused (counted under
    dynamo_requests_shed_total{reason="queue"}, attributed to the
    tenant when the request is tagged) on refusal. A disabled loop
    (DYNT_ADMISSION_ENABLE=0) admits unconditionally and publishes
    nothing — the pure-FCFS baseline the chaos A/B measures against."""
    if not admission_enabled():
        return AdmissionDecision(True, 0.0, 0.0)
    decision = estimator.check(deadline, extra=extra)
    gauge = decision.est_wait_ms
    if math.isinf(gauge):
        gauge = decision.retry_after_s * 1e3
    ADMISSION_WAIT_MS.labels(pool=estimator.pool).set(gauge)
    if not decision.admit:
        REQUESTS_SHED.labels(reason="queue").inc()
        if tenant:
            TENANT_SHED.labels(tenant=bounded_label("tenant", tenant),
                               reason="queue").inc()
        raise estimator.refuse(decision)
    return decision
