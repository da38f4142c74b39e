"""PushRouter - instance selection and fault-aware dispatch.

Port of `dynamo_tpu/runtime/push_router.py` with its five modes:
round_robin, random, p2c (power of two choices on local in-flight counts),
kv (an external selector callback) and direct (ref: lib/runtime/src/
pipeline/network/egress/push_router.rs:71,113-120). The KV router engine,
as the reference's, routes through a round_robin router to the instance it
chose.

A transport failure feeds the instance's circuit breaker (a `BreakerBoard`
per endpoint: closed -> open -> half-open single probe); discovery
re-confirming an instance resets its breaker. A failure before the first
output is retried on another instance after a decorrelated-jitter backoff
(`RetryPolicy`), paid from a `RetryBudget` shared by this router, so a
browned-out fleet degrades instead of drawing a retry storm; each retry (or
its denial) goes on the request's flight-recorder timeline. An end-to-end
`Deadline` is re-encoded onto every attempt's headers and bounds the whole
loop. A watcher marks a vacating instance as draining (`set_draining`): no
mode but direct selects it until its discovery record is deleted.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import logging
import random
from typing import Any, AsyncIterator, Awaitable, Callable, Optional

from .component import Client
from .flight_recorder import get_recorder
from .metrics import RETRIES_TOTAL
from .request_plane import ConnectionLost, EndpointNotFound
from .resilience import (
    HALF_OPEN,
    BreakerBoard,
    Deadline,
    DeadlineExceeded,
    RetryBudget,
    RetryPolicy,
)

log = logging.getLogger("dynamo_tpu_torch.push_router")


class NoInstancesAvailable(RuntimeError):
    pass


class PushRouter:
    def __init__(
        self,
        client: Client,
        mode: str = "round_robin",
        selector: Optional[Callable[[Any, list[int]], Awaitable[int]]] = None,
        retry_policy: Optional[RetryPolicy] = None,
        retry_budget: Optional[RetryBudget] = None,
        breakers: Optional[BreakerBoard] = None,
    ) -> None:
        assert mode in ("round_robin", "random", "direct", "kv", "p2c"), mode
        self.client = client
        self.mode = mode
        self._selector = selector
        self._rr = itertools.count()
        self._inflight: dict[int, int] = {}
        subject = client.endpoint.subject
        self.policy = retry_policy or RetryPolicy.from_env()
        self.budget = retry_budget or RetryBudget.from_env(subject)
        self.breakers = breakers or BreakerBoard(subject)
        # Instances a watcher marked as vacating. A card re-put does not
        # clear the mark (a draining worker republishes its card with the
        # flag set, and drains are terminal); the delete at deregistration
        # does.
        self._draining: set[int] = set()
        client.on_change(self._on_instance_change)

    def _on_instance_change(self, kind: str, record: dict) -> None:
        # A put re-confirms the instance; a delete forgets it.
        iid = record.get("instance_id")
        if iid is None:
            return
        if kind == "put":
            self.breakers.reset(iid)
        if kind == "delete":
            self.breakers.drop(iid)
            self._draining.discard(iid)

    def mark_down(self, instance_id: int) -> None:
        """Record a transport failure against an instance's breaker."""
        self.breakers.get(instance_id).record_failure()

    def set_draining(self, instance_id: int, draining: bool = True) -> bool:
        """Mark or unmark an instance as vacating. Returns True only on a
        transition, so callers drop derived state (radix entries, wait
        estimates) once, not on every load-metrics tick."""
        if draining == (instance_id in self._draining):
            return False
        if draining:
            self._draining.add(instance_id)
        else:
            self._draining.discard(instance_id)
        return True

    def available(self) -> list[int]:
        return [iid for iid in self.client.instance_ids()
                if iid not in self._draining
                and self.breakers.get(iid).can_attempt()]

    async def _pick(self, body: Any, instance_id: Optional[int],
                    allowed: Optional[set] = None) -> int:
        if self.mode == "direct":
            if instance_id is None:
                raise ValueError("direct mode requires instance_id")
            return instance_id
        avail = self.available()
        if allowed is not None:
            # capability filter: only instances holding a LoRA adapter
            avail = [i for i in avail if i in allowed]
        if instance_id is not None:
            # Explicit target: honoured only while it is live and its
            # breaker admits traffic, else fail fast so the caller
            # re-selects.
            if instance_id not in avail:
                raise NoInstancesAvailable(
                    f"{self.client.endpoint.subject}: instance "
                    f"{instance_id:x} unavailable")
            return instance_id
        if not avail:
            raise NoInstancesAvailable(self.client.endpoint.subject)
        if self.mode == "round_robin":
            return avail[next(self._rr) % len(avail)]
        if self.mode == "random":
            return random.choice(avail)
        if self.mode == "p2c":
            # Power-of-two-choices on local in-flight counts.
            a, b = (random.sample(avail, 2) if len(avail) >= 2
                    else (avail[0], avail[0]))
            return (a if self._inflight.get(a, 0) <= self._inflight.get(b, 0)
                    else b)
        assert self._selector is not None, "kv mode requires a selector"
        return await self._selector(body, avail)

    async def generate(self, body: Any, instance_id: Optional[int] = None,
                       headers: Optional[dict] = None,
                       deadline: Optional[Deadline] = None,
                       allowed: Optional[set] = None,
                       ) -> AsyncIterator[Any]:
        """Route and stream. On a transport failure before any output the
        instance's breaker records a failure and, if the retry budget
        admits it, another instance is tried after a jittered backoff; a
        failure after output is raised as ConnectionLost (migration is the
        pipeline's concern, llm/engine.py). The deadline (also read from
        `headers`) is re-encoded onto every attempt and bounds the loop.
        `allowed` restricts the candidates (the instances holding a
        request's LoRA adapter)."""
        await self.client.start()
        if deadline is None:
            deadline = Deadline.from_wire(headers)
        subject = self.client.endpoint.subject
        attempts = 0
        prev_delay: Optional[float] = None
        while True:
            if deadline is not None and deadline.expired():
                raise DeadlineExceeded(f"deadline exceeded routing {subject}")
            iid = await self._pick(body, instance_id, allowed)
            breaker = self.breakers.get(iid)
            owns_probe = False
            if self.mode != "direct":
                if not breaker.try_acquire():
                    # Lost the half-open probe slot in a race: an explicit
                    # target fails fast so the upstream selector re-picks.
                    if instance_id is not None:
                        raise NoInstancesAvailable(
                            f"{subject}: instance {iid:x} breaker open")
                    continue
                # A True acquire with the breaker now half-open means this
                # attempt holds the single probe slot.
                owns_probe = breaker.state == HALF_OPEN
            hdrs = dict(headers or {})
            if deadline is not None:
                # Remaining ms at send time: backoff sleeps and failed
                # attempts are charged to the budget.
                hdrs.update(deadline.to_wire())
            self._inflight[iid] = self._inflight.get(iid, 0) + 1
            yielded = False
            settled = False  # the breaker got a success or failure verdict
            try:
                async with contextlib.aclosing(
                        self.client.direct(body, iid, hdrs)) as stream:
                    async for item in stream:
                        if not yielded:
                            breaker.record_success(probe=owns_probe)
                            settled = True
                            self.budget.deposit()
                        yielded = True
                        yield item
                if not yielded:
                    # An empty but clean stream still proves the instance up.
                    breaker.record_success(probe=owns_probe)
                    settled = True
                    self.budget.deposit()
                return
            except DeadlineExceeded:
                # The request was late, not the worker broken: no breaker
                # failure and no retry.
                raise
            except (ConnectionLost, EndpointNotFound, KeyError,
                    asyncio.TimeoutError) as exc:
                breaker.record_failure(probe=owns_probe)
                settled = True
                log.warning("instance %x faulted (%r) breaker=%s", iid, exc,
                            breaker.state)
                if yielded or self.mode == "direct":
                    raise ConnectionLost(str(exc)) from exc
                attempts += 1
                # One attempt per live instance (+1), even when the policy
                # cap is lower.
                if attempts >= max(self.policy.max_attempts,
                                   len(self.client.instances) + 1):
                    raise
                if not self.budget.try_spend():
                    RETRIES_TOTAL.labels(endpoint=subject,
                                         outcome="denied").inc()
                    get_recorder().event(None, "retry_denied",
                                         endpoint=subject)
                    log.warning("retry budget exhausted for %s", subject)
                    raise
                RETRIES_TOTAL.labels(endpoint=subject,
                                     outcome="allowed").inc()
                # on the request's timeline (the task's current request id)
                get_recorder().event(None, "retry", endpoint=subject,
                                     instance=f"{iid:x}", attempt=attempts)
                prev_delay = self.policy.next_delay(prev_delay)
                delay = prev_delay
                if deadline is not None:
                    delay = deadline.bound(delay)
                await asyncio.sleep(delay)
            finally:
                if owns_probe and not settled:
                    # The probe ended with no verdict (deadline, application
                    # error, caller closed the stream): return the slot, or
                    # the instance is locked out for good.
                    breaker.release_probe()
                self._inflight[iid] = max(0, self._inflight.get(iid, 1) - 1)
