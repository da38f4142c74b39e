"""Request-plane resilience primitives: deadlines, retry budgets, circuit
breakers.

Port of `dynamo_tpu/runtime/resilience.py`. A serving plane must fail
bounded: every hop consumes one end-to-end budget instead of stacking flat
timeouts, retries are capped at a fraction of live traffic so a browned-out
backend degrades instead of drawing a retry storm, and repeated failures
trip a breaker that probes its way back.

  * Deadline       - a monotonic budget created once at admission and
                     re-encoded as remaining milliseconds on every hop (the
                     `x-dynt-deadline-ms` request-plane header), so hosts
                     need no wall-clock agreement.
  * RetryPolicy    - decorrelated-jitter backoff: each delay is
                     uniform(base, prev * 3), capped. The random source is
                     injectable (`rng`).
  * RetryBudget    - a token bucket per client: each completed first
                     attempt deposits `ratio`, each retry withdraws one.
  * CircuitBreaker - closed -> open (after N consecutive failures) ->
                     half-open (after reset_secs, admitting a single probe)
                     -> closed on the probe's success, open on its failure.

The breaker serializes its transitions with a lock; the rest is
asyncio-single-threaded.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from typing import Any, Callable, Optional

from ..config import env
from .metrics import (
    BREAKER_STATE,
    BREAKER_TRANSITIONS,
    DEADLINE_EXCEEDED,
    RETRY_BUDGET_BALANCE,
)

DEADLINE_HEADER = "x-dynt-deadline-ms"


class DeadlineExceeded(RuntimeError):
    """The request's end-to-end budget is spent. Not a transport failure:
    routers neither retry it nor fault-mark the instance that reported it."""


class Deadline:
    """Monotonic end-to-end budget. Created once at admission; every hop
    measures what is left rather than adding its own flat timeout."""

    __slots__ = ("expires_at",)

    def __init__(self, budget_secs: float) -> None:
        self.expires_at = time.monotonic() + budget_secs

    def remaining(self) -> float:
        """Seconds of budget left (can be <= 0)."""
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def bound(self, timeout: Optional[float]) -> float:
        """Clamp a local timeout to the remaining budget, floored at 0."""
        rem = max(0.0, self.remaining())
        if timeout is None:
            return rem
        return min(timeout, rem)

    def to_wire(self) -> dict:
        """Header fragment carrying the budget across one hop, relative
        (remaining ms at send time): immune to clock skew, and re-encoding
        at every hop charges queueing and transfer to the budget."""
        return {DEADLINE_HEADER: max(0, int(self.remaining() * 1e3))}

    @classmethod
    def from_wire(cls, header: Optional[dict]) -> Optional["Deadline"]:
        """The Deadline in request-plane headers; None when the caller
        propagated none or sent a value that is not a number."""
        if not header:
            return None
        raw = header.get(DEADLINE_HEADER)
        if raw is None:
            return None
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            return None
        return cls(ms / 1e3)


class DeadlineWatchdog:
    """Cancels the current task when a deadline expires; `.fired` tells the
    watchdog's own cancel (report the overrun) from an external one (a
    client cancel frame or a lost connection, which keeps propagating)."""

    __slots__ = ("fired", "_timer")

    def __init__(self) -> None:
        self.fired = False
        self._timer: Optional[asyncio.TimerHandle] = None

    def arm(self, deadline: Optional[Deadline]) -> "DeadlineWatchdog":
        if deadline is not None:
            task = asyncio.current_task()
            assert task is not None

            def _fire(task: "asyncio.Task" = task) -> None:
                self.fired = True
                task.cancel()

            self._timer = asyncio.get_running_loop().call_later(
                max(0.0, deadline.remaining()), _fire)
        return self

    def disarm(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


async def bounded_wait(coro: Any, timeout: Optional[float],
                       deadline: Optional[Deadline], what: str) -> Any:
    """Await `coro` under `timeout` clamped to the deadline. A timeout the
    deadline caused raises DeadlineExceeded (the request was late), any
    other asyncio.TimeoutError (the peer is sick)."""
    if deadline is not None:
        timeout = deadline.bound(timeout)
    try:
        if timeout is not None:
            return await asyncio.wait_for(coro, timeout)
        return await coro
    except asyncio.TimeoutError:
        if deadline is not None and deadline.expired():
            DEADLINE_EXCEEDED.labels(component="client").inc()
            raise DeadlineExceeded(
                f"deadline exceeded waiting on {what}") from None
        raise


class RetryPolicy:
    """Decorrelated-jitter exponential backoff and an attempt cap. `rng`
    (anything with `uniform`) defaults to the `random` module."""

    __slots__ = ("base_secs", "cap_secs", "max_attempts", "rng")

    def __init__(self, base_secs: float = 0.05, cap_secs: float = 2.0,
                 max_attempts: int = 3, rng: Any = None) -> None:
        self.base_secs = base_secs
        self.cap_secs = cap_secs
        self.max_attempts = max_attempts
        self.rng = rng

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(base_secs=env("DYNT_RETRY_BACKOFF_BASE_MS") / 1e3,
                   cap_secs=env("DYNT_RETRY_BACKOFF_CAP_MS") / 1e3,
                   max_attempts=env("DYNT_RETRY_MAX_ATTEMPTS"))

    def next_delay(self, prev: Optional[float] = None) -> float:
        """min(cap, uniform(base, prev * 3)); prev is None on the first
        retry."""
        prev = self.base_secs if prev is None else prev
        rng = random if self.rng is None else self.rng
        return min(self.cap_secs,
                   rng.uniform(self.base_secs,
                               max(self.base_secs, prev * 3.0)))


class RetryBudget:
    """Token bucket capping retries at a fraction of live traffic: every
    completed first attempt deposits `ratio`, every retry withdraws one;
    `min_tokens` seeds the bucket so a cold client can still retry."""

    __slots__ = ("ratio", "cap", "_balance", "_endpoint")

    def __init__(self, ratio: float = 0.2, min_tokens: float = 3.0,
                 cap: float = 20.0, endpoint: str = "") -> None:
        self.ratio = ratio
        self.cap = max(cap, min_tokens)
        self._balance = min(min_tokens, self.cap)
        self._endpoint = endpoint
        self._observe()

    @classmethod
    def from_env(cls, endpoint: str = "") -> "RetryBudget":
        return cls(ratio=env("DYNT_RETRY_BUDGET_RATIO"),
                   min_tokens=env("DYNT_RETRY_BUDGET_MIN"),
                   endpoint=endpoint)

    def _observe(self) -> None:
        if self._endpoint:
            RETRY_BUDGET_BALANCE.labels(endpoint=self._endpoint).set(
                self._balance)

    @property
    def balance(self) -> float:
        return self._balance

    def deposit(self) -> None:
        """Credit one unit of live traffic."""
        self._balance = min(self.cap, self._balance + self.ratio)
        self._observe()

    def try_spend(self) -> bool:
        """Withdraw one retry token; False when the budget is spent."""
        if self._balance < 1.0:
            return False
        self._balance -= 1.0
        self._observe()
        return True


# Breaker states, with the encoding of the dynamo_circuit_breaker_state gauge
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_VALUE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """closed -> open -> half-open breaker with single-probe recovery: a
    still-sick backend costs one request per reset window."""

    __slots__ = ("failure_threshold", "reset_secs", "state", "_failures",
                 "_opened_at", "_probe_inflight", "_on_transition", "_lock")

    def __init__(self, failure_threshold: int = 1, reset_secs: float = 5.0,
                 on_transition: Optional[Callable[[str], None]] = None,
                 ) -> None:
        self.failure_threshold = failure_threshold
        self.reset_secs = reset_secs
        self.state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._on_transition = on_transition
        self._lock = threading.Lock()

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        if self._on_transition is not None:
            self._on_transition(state)

    def can_attempt(self) -> bool:
        """Non-mutating check for candidate filtering: closed, open with
        its reset window elapsed, or half-open with no probe out."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                return time.monotonic() - self._opened_at >= self.reset_secs
            return not self._probe_inflight

    def try_acquire(self) -> bool:
        """Dispatch gate: the half-open probe slot is reserved here, just
        before the request goes out."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if time.monotonic() - self._opened_at < self.reset_secs:
                    return False
                self._transition(HALF_OPEN)
                self._probe_inflight = True
                return True
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def release_probe(self) -> None:
        """Return an acquired probe slot without a verdict (the attempt
        ended in a way that says nothing of the instance's health)."""
        with self._lock:
            self._probe_inflight = False

    def record_success(self, probe: bool = False) -> None:
        """`probe=True` only from the attempt that owns the probe slot."""
        with self._lock:
            self._failures = 0
            if probe:
                self._probe_inflight = False
            if self.state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self, probe: bool = False) -> None:
        with self._lock:
            now = time.monotonic()
            if self.state == HALF_OPEN:
                if probe:
                    self._probe_inflight = False
                self._opened_at = now
                self._transition(OPEN)
                return
            if self.state == OPEN:
                # A failure while open (direct dispatch skips try_acquire)
                # re-arms the reset window.
                self._opened_at = now
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = now
                self._transition(OPEN)

    def reset(self) -> None:
        """External evidence of health (discovery re-confirmed the
        instance): drop all failure state."""
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            self._transition(CLOSED)


class BreakerBoard:
    """Per-instance CircuitBreakers of one endpoint, exporting their state
    and transitions on the metrics registry."""

    def __init__(self, endpoint: str, failure_threshold: Optional[int] = None,
                 reset_secs: Optional[float] = None) -> None:
        self.endpoint = endpoint
        self.failure_threshold = (env("DYNT_BREAKER_FAILURES")
                                  if failure_threshold is None
                                  else failure_threshold)
        self.reset_secs = (env("DYNT_BREAKER_RESET_SECS")
                           if reset_secs is None else reset_secs)
        self._breakers: dict[int, CircuitBreaker] = {}

    def get(self, instance_id: int) -> CircuitBreaker:
        breaker = self._breakers.get(instance_id)
        if breaker is None:
            def observe(state: str, iid: int = instance_id) -> None:
                BREAKER_STATE.labels(
                    endpoint=self.endpoint, instance=f"{iid:x}"
                ).set(_STATE_VALUE[state])
                BREAKER_TRANSITIONS.labels(
                    endpoint=self.endpoint, state=state).inc()

            breaker = CircuitBreaker(self.failure_threshold, self.reset_secs,
                                     on_transition=observe)
            BREAKER_STATE.labels(endpoint=self.endpoint,
                                 instance=f"{instance_id:x}").set(
                _STATE_VALUE[CLOSED])
            self._breakers[instance_id] = breaker
        return breaker

    def reset(self, instance_id: int) -> None:
        breaker = self._breakers.get(instance_id)
        if breaker is not None:
            breaker.reset()

    def drop(self, instance_id: int) -> None:
        """Forget a deregistered instance, its gauge series too."""
        if self._breakers.pop(instance_id, None) is not None:
            try:
                BREAKER_STATE.remove(self.endpoint, f"{instance_id:x}")
            except KeyError:
                pass
