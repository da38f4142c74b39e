"""PushRouter — instance selection and fault-aware dispatch.

Port of `dynamo_tpu/runtime/push_router.py` with its five modes:
round_robin, random, p2c (power of two choices on local in-flight counts),
kv (an external selector callback) and direct (ref: lib/runtime/src/
pipeline/network/egress/push_router.rs:71,113-120). The KV router engine,
as the reference's, routes through a round_robin router to the instance it
chose. A transport failure marks its instance down for DOWN_COOLDOWN_SECS,
the reference's default breaker (one failure opens it, re-admission after
5 s); discovery re-confirming the instance clears the mark (ref:
push_router.rs:8-16,103-107). A watcher marks a vacating instance as
draining (`set_draining`): no mode but direct selects it until its
discovery record is deleted.

Not ported yet: the reference's retries, retry budget and half-open probes
— a transport failure before any output is raised to the caller instead of
retried.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import random
import time
from typing import Any, AsyncIterator, Awaitable, Callable, Optional

from .component import Client
from .request_plane import ConnectionLost, EndpointNotFound

log = logging.getLogger("dynamo_tpu_torch.push_router")

# How long a marked-down instance stays out of rotation (the reference's
# DYNT_BREAKER_RESET_SECS default).
DOWN_COOLDOWN_SECS = 5.0


class NoInstancesAvailable(RuntimeError):
    pass


class PushRouter:
    def __init__(
        self,
        client: Client,
        mode: str = "round_robin",
        selector: Optional[Callable[[Any, list[int]], Awaitable[int]]] = None,
    ) -> None:
        assert mode in ("round_robin", "random", "direct", "kv", "p2c"), mode
        self.client = client
        self.mode = mode
        self._selector = selector
        self._rr = itertools.count()
        self._inflight: dict[int, int] = {}
        # instance id -> monotonic time its down-mark expires
        self._down: dict[int, float] = {}
        # Instances a watcher marked as vacating. A card re-put does not
        # clear the mark (a draining worker republishes its card with the
        # flag set, and drains are terminal); the delete at deregistration
        # does.
        self._draining: set[int] = set()
        client.on_change(self._on_instance_change)

    def _on_instance_change(self, kind: str, record: dict) -> None:
        # A put re-confirms the instance; a delete forgets it.
        iid = record.get("instance_id")
        self._down.pop(iid, None)
        if kind == "delete":
            self._draining.discard(iid)

    def mark_down(self, instance_id: int) -> None:
        """Take an instance out of rotation after a transport failure."""
        self._down[instance_id] = time.monotonic() + DOWN_COOLDOWN_SECS

    def set_draining(self, instance_id: int, draining: bool = True) -> bool:
        """Mark or unmark an instance as vacating. Returns True only on a
        transition, so callers drop derived state (radix entries) once,
        not on every load-metrics tick."""
        if draining == (instance_id in self._draining):
            return False
        if draining:
            self._draining.add(instance_id)
        else:
            self._draining.discard(instance_id)
        return True

    def available(self) -> list[int]:
        now = time.monotonic()
        return [iid for iid in self.client.instance_ids()
                if iid not in self._draining
                and self._down.get(iid, 0.0) <= now]

    def _pick(self, instance_id: Optional[int]) -> int:
        if self.mode == "direct":
            if instance_id is None:
                raise ValueError("direct mode requires instance_id")
            return instance_id
        avail = self.available()
        if instance_id is not None:
            # Explicit target: honoured only while it is live.
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
        raise AssertionError(f"{self.mode} mode picks in _select")

    async def _select(self, body: Any, instance_id: Optional[int]) -> int:
        """`_pick`, or the kv mode's selector over the available
        instances."""
        if self.mode != "kv" or instance_id is not None:
            return self._pick(instance_id)
        assert self._selector is not None, "kv mode requires a selector"
        avail = self.available()
        if not avail:
            raise NoInstancesAvailable(self.client.endpoint.subject)
        return await self._selector(body, avail)

    async def generate(self, body: Any, instance_id: Optional[int] = None,
                       headers: Optional[dict] = None) -> AsyncIterator[Any]:
        """Route and stream. A transport failure marks the instance down and
        is raised as ConnectionLost."""
        await self.client.start()
        iid = await self._select(body, instance_id)
        self._inflight[iid] = self._inflight.get(iid, 0) + 1
        try:
            async with contextlib.aclosing(
                    self.client.direct(body, iid, headers)) as stream:
                async for item in stream:
                    yield item
        except (ConnectionLost, EndpointNotFound, KeyError,
                TimeoutError) as exc:
            self.mark_down(iid)
            log.warning("instance %x faulted (%r)", iid, exc)
            raise ConnectionLost(str(exc)) from exc
        finally:
            self._inflight[iid] = max(0, self._inflight.get(iid, 1) - 1)
