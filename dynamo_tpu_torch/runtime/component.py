"""Namespace / Component / Endpoint hierarchy and endpoint clients.

Port of `dynamo_tpu/runtime/component.py` (ref: lib/runtime/src/
component.rs: Namespace :412, Component :142, Endpoint :321). Serving an
endpoint registers an instance record in discovery under the runtime's
lease — the reference's record, field for field, so either package's
clients route to either package's instances; clients watch the instance
prefix and route to live instances (ref: component/client.rs:28).

An endpoint served with a `health_check_payload` is probed with it by the
runtime's HealthCheckManager (runtime/health_check.py) once it has been
idle; a request carrying the `x-dynt-canary` header is such a probe and
does not count as traffic for the idle clock.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
import uuid
from typing import Any, AsyncIterator, Callable, Optional, TYPE_CHECKING

from .discovery import INSTANCE_PREFIX
from .metrics import EndpointMetrics
from .request_plane import Handler, RequestContext

if TYPE_CHECKING:
    from .distributed import DistributedRuntime

log = logging.getLogger("dynamo_tpu_torch.component")


def new_instance_id() -> int:
    """63-bit instance id (ref: instance ids derive from etcd lease i64s)."""
    return uuid.uuid4().int >> 65


class Namespace:
    def __init__(self, runtime: "DistributedRuntime", name: str) -> None:
        self.runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)


class Component:
    def __init__(self, namespace: Namespace, name: str) -> None:
        self.namespace = namespace
        self.name = name

    @property
    def runtime(self) -> "DistributedRuntime":
        return self.namespace.runtime

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    @property
    def path(self) -> str:
        return f"{self.namespace.name}/{self.name}"


class Endpoint:
    def __init__(self, component: Component, name: str) -> None:
        self.component = component
        self.name = name

    @property
    def runtime(self) -> "DistributedRuntime":
        return self.component.runtime

    @property
    def subject(self) -> str:
        return f"{self.component.path}/{self.name}"

    @property
    def instance_prefix(self) -> str:
        return f"{INSTANCE_PREFIX}/{self.subject}/"

    async def serve_endpoint(self, handler: Handler,
                             instance_id: Optional[int] = None,
                             health_check_payload: Optional[Any] = None,
                             ) -> "ServedEndpoint":
        """Register `handler` on the request plane and advertise the instance
        (ref: bindings rust/lib.rs:815 serve_endpoint -> PushEndpoint.start).
        `health_check_payload` opts into canary probing."""
        instance_id = (instance_id if instance_id is not None
                       else new_instance_id())
        served = ServedEndpoint(self, instance_id, handler,
                                health_check_payload=health_check_payload)
        await served.start()
        return served

    def client(self) -> "Client":
        return Client(self)


class ServedEndpoint:
    """A live served endpoint instance: handler wrapper with metrics,
    in-flight tracking for graceful drain, and its discovery record."""

    def __init__(self, endpoint: Endpoint, instance_id: int,
                 handler: Handler,
                 health_check_payload: Optional[Any] = None) -> None:
        self.endpoint = endpoint
        self.instance_id = instance_id
        self._handler = handler
        self._shutting_down = False
        self._inflight = 0
        self.health_check_payload = health_check_payload
        self.health_ok = True
        self.last_activity = time.monotonic()
        self._drained = asyncio.Event()
        self._drained.set()
        self._metrics = EndpointMetrics(endpoint.component.namespace.name,
                                        endpoint.component.name,
                                        endpoint.name)
        # Unique wire subject per instance so direct routing works when many
        # instances live in one process (tests) or behind one address.
        self.wire_subject = f"{endpoint.subject}/{instance_id}"

    @property
    def instance_key(self) -> str:
        return f"{self.endpoint.instance_prefix}{self.instance_id}"

    def healthy(self) -> bool:
        """Liveness for /health: serving, not deregistered, and passing
        canaries (ref: health_check.rs HealthCheckManager)."""
        return not self._shutting_down and self.health_ok

    async def start(self) -> None:
        runtime = self.endpoint.runtime
        runtime.request_server.registry.register(self.wire_subject,
                                                 self._wrapped)
        self.record = {
            "instance_id": self.instance_id,
            "address": runtime.request_server.address,
            "subject": self.wire_subject,
            "endpoint": self.endpoint.subject,
            "started_at": time.time(),
            "system_url": runtime.system_url(),
            "metadata": {},
        }
        await runtime.put_leased(self.instance_key, self.record)
        runtime.track_served(self)
        log.info("serving %s instance=%x at %s", self.endpoint.subject,
                 self.instance_id, runtime.request_server.address)

    async def _wrapped(self, body: Any,
                       ctx: RequestContext) -> AsyncIterator[Any]:
        self._inflight += 1
        self._drained.clear()
        start = time.monotonic()
        canary = "x-dynt-canary" in ctx.headers
        if not canary:
            # A canary is not traffic: a wedged handler must not reset its
            # own idle clock and dodge the failures that deregister it.
            self.last_activity = start
        status = "ok"
        try:
            # aclosing: a close of this generator (the request plane's
            # cancel) closes the handler's at once, not at garbage collection
            async with contextlib.aclosing(self._handler(body, ctx)) as gen:
                async for item in gen:
                    yield item
        except asyncio.CancelledError:
            status = "cancelled"
            raise
        except Exception:
            status = "error"
            raise
        finally:
            self._inflight -= 1
            if self._inflight == 0:
                self._drained.set()
            if not canary:
                # A worker grinding through long decodes is active, not
                # idle: canaries queued behind its batch could time out.
                self.last_activity = time.monotonic()
            self._metrics.observe_request(start, status)

    async def shutdown(self, drain_timeout: float = 30.0) -> None:
        """Deregister then drain in-flight requests (ref: graceful_shutdown.py,
        GracefulShutdownTracker lib/runtime/src/distributed.rs:18)."""
        self._shutting_down = True
        runtime = self.endpoint.runtime
        await runtime.delete_leased(self.instance_key)
        if self._inflight > 0:
            try:
                await asyncio.wait_for(self._drained.wait(), drain_timeout)
            except asyncio.TimeoutError:
                log.warning("drain timeout on %s (%d in flight)",
                            self.endpoint.subject, self._inflight)
        runtime.request_server.registry.unregister(self.wire_subject)
        runtime.untrack_served(self)


class Client:
    """Endpoint client: watches discovery for instances, exposes routing
    primitives. Routing policy lives in PushRouter (push_router.py)."""

    def __init__(self, endpoint: Endpoint) -> None:
        self.endpoint = endpoint
        self.instances: dict[int, dict] = {}
        self._watch = None
        self._watch_task: Optional[asyncio.Task] = None
        self._changed = asyncio.Event()
        self._started = False
        self._listeners: list[Callable[[str, dict], None]] = []

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        runtime = self.endpoint.runtime
        self._watch = await runtime.discovery.watch_prefix(
            self.endpoint.instance_prefix)
        self._watch_task = asyncio.create_task(self._watch_loop())
        # Seed synchronously so callers see current instances immediately.
        existing = await runtime.discovery.get_prefix(
            self.endpoint.instance_prefix)
        for record in existing.values():
            self.instances[record["instance_id"]] = record

    def on_change(self, fn: Callable[[str, dict], None]) -> None:
        """Subscribe to instance add/remove events ('put'/'delete', record)."""
        self._listeners.append(fn)

    async def _watch_loop(self) -> None:
        async for event in self._watch:
            if event.kind == "put" and event.value:
                record = event.value
                iid = record["instance_id"]
                known = iid in self.instances
                self.instances[iid] = record
                if not known:
                    for fn in self._listeners:
                        fn("put", record)
            elif event.kind == "delete":
                try:
                    iid = int(event.key.rsplit("/", 1)[-1])
                except ValueError:
                    continue
                record = self.instances.pop(iid, None)
                if record is not None:
                    for fn in self._listeners:
                        fn("delete", record)
            self._changed.set()
            self._changed.clear()

    async def close(self) -> None:
        if self._watch_task:
            self._watch_task.cancel()
            try:
                await self._watch_task
            except asyncio.CancelledError:
                pass
        if self._watch:
            await self._watch.cancel()

    def instance_ids(self) -> list[int]:
        return sorted(self.instances)

    async def wait_for_instances(self, n: int = 1,
                                 timeout: float = 30.0) -> list[int]:
        deadline = time.monotonic() + timeout
        await self.start()
        while len(self.instances) < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{self.endpoint.subject}: {len(self.instances)}/{n} "
                    "instances")
            try:
                await asyncio.wait_for(self._changed.wait(),
                                       min(remaining, 0.5))
            except asyncio.TimeoutError:
                pass
        return self.instance_ids()

    def direct(self, body: Any, instance_id: int,
               headers: Optional[dict] = None) -> AsyncIterator[Any]:
        """Route to a specific instance (ref: RouterMode::Direct)."""
        record = self.instances.get(instance_id)
        if record is None:
            raise KeyError(f"instance {instance_id:x} not found for "
                           f"{self.endpoint.subject}")
        client = self.endpoint.runtime.request_client
        return client.call(record["address"], record["subject"], body,
                           headers)
