"""DistributedRuntime — the per-process root of the distributed stack.

Port of `dynamo_tpu/runtime/distributed.py` (ref: lib/runtime/src/
distributed.rs:42): owns the discovery connection with its lease and
keep-alive loop, the request-plane server and client, the event plane's
publishers and subscriber managers (`event_publisher`, `event_subscriber`),
and the system status server. Components, endpoints and clients hang off
it.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from .component import Namespace, ServedEndpoint
from .config import RuntimeConfig
from .discovery import Discovery, Lease, LeaseExpired, make_discovery
from .events import (
    EventPublisher,
    EventSubscriber,
    JournalEventPublisher,
    JournalEventSubscriberManager,
    MemEventPlane,
    ZmqEventPublisher,
    ZmqEventSubscriberManager,
)
from .request_plane import MemRequestPlane, RequestClient, TcpRequestServer
from .status import SystemStatusServer

log = logging.getLogger("dynamo_tpu_torch.distributed")


class DistributedRuntime:
    def __init__(self, config: Optional[RuntimeConfig] = None) -> None:
        self.config = config or RuntimeConfig.from_env()
        self.discovery: Discovery = make_discovery(
            self.config.discovery_backend, path=self.config.discovery_path)
        self.lease: Optional[Lease] = None
        if self.config.request_plane == "mem":
            self.request_server = MemRequestPlane.create_server()
        elif self.config.request_plane == "tcp":
            self.request_server = TcpRequestServer(
                self.config.tcp_host, self.config.tcp_port,
                advertise_host=self.config.tcp_advertise_host)
        else:
            raise NotImplementedError(
                f"request plane {self.config.request_plane!r} is not ported "
                "yet (tcp | mem)")
        self.request_client = RequestClient(
            connect_timeout=self.config.connect_timeout_secs)
        self.status_server: Optional[SystemStatusServer] = None
        self._keepalive_task: Optional[asyncio.Task] = None
        self._served: list[ServedEndpoint] = []
        self._publishers: list[EventPublisher] = []
        self._subscriber_managers: list = []
        self._started = False
        # Everything put under the runtime lease, replayed under a fresh
        # lease if the old one is lost (a discovery outage past the TTL).
        self._leased_records: dict[str, dict] = {}

    async def start(self) -> "DistributedRuntime":
        if self._started:
            return self
        self._started = True
        await self.discovery.start()
        self.lease = await self.discovery.create_lease(
            self.config.lease_ttl_secs)
        self._keepalive_task = asyncio.create_task(self._keepalive_loop())
        await self.request_server.start()
        if self.config.system_enabled:
            self.status_server = SystemStatusServer(self.config.system_port)
            await self.status_server.start()
        log.info("runtime up: request_plane=%s discovery=%s status_port=%s",
                 self.request_server.address, self.config.discovery_backend,
                 self.status_server.port if self.status_server else None)
        return self

    def system_url(self) -> str:
        """Scrape address of this process's status server, advertised on
        discovery records; empty when the status server is off."""
        if self.status_server is None or self.status_server.port is None:
            return ""
        host = self.config.tcp_advertise_host or self.config.tcp_host
        if not host or host == "0.0.0.0":
            host = "127.0.0.1"
        return f"http://{host}:{self.status_server.port}"

    async def put_leased(self, key: str, value: dict) -> None:
        self._leased_records[key] = value
        await self.discovery.put(key, value, self.lease)

    async def delete_leased(self, key: str) -> None:
        self._leased_records.pop(key, None)
        await self.discovery.delete(key)

    async def _keepalive_loop(self) -> None:
        """Refresh the lease at TTL/3; a lost lease is re-granted and every
        leased record replayed under it."""
        assert self.lease is not None
        interval = max(0.05, self.lease.ttl / 3.0)
        while True:
            await asyncio.sleep(interval)
            try:
                await self.discovery.keep_alive(self.lease)
            except LeaseExpired:
                log.error("discovery lease expired — re-granting and "
                          "re-registering %d records",
                          len(self._leased_records))
                await self._recover_lease()
            except Exception as exc:  # noqa: BLE001 — transient backends
                log.warning("lease keep-alive failed: %s", exc)

    async def _recover_lease(self) -> None:
        backoff = 0.2
        while True:
            try:
                self.lease = await self.discovery.create_lease(
                    self.config.lease_ttl_secs)
                for key, value in list(self._leased_records.items()):
                    if key in self._leased_records:
                        await self.discovery.put(key, value, self.lease)
                return
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — backend still down
                log.warning("lease recovery attempt failed: %s", exc)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    # -- event plane -------------------------------------------------------

    def event_publisher(self, namespace: str) -> EventPublisher:
        if self.config.event_plane == "mem":
            return MemEventPlane(cluster=namespace).publisher()
        if self.config.event_plane == "journal":
            publisher = JournalEventPublisher(
                self.config.event_journal_path, namespace,
                max_bytes=self.config.event_journal_max_mb * 2**20)
        else:
            publisher = ZmqEventPublisher(
                namespace, self.discovery, self.lease,
                host=self.config.zmq_host, put_leased=self.put_leased,
                delete_leased=self.delete_leased)
        self._publishers.append(publisher)
        return publisher

    async def event_subscriber(self, namespace: str,
                               topic_prefix: str = "") -> EventSubscriber:
        if self.config.event_plane == "mem":
            return MemEventPlane(cluster=namespace).subscribe(topic_prefix)
        if self.config.event_plane == "journal":
            manager = JournalEventSubscriberManager(
                self.config.event_journal_path, namespace, topic_prefix)
        else:
            manager = ZmqEventSubscriberManager(namespace, self.discovery,
                                                topic_prefix)
        self._subscriber_managers.append(manager)
        return await manager.start()

    def track_served(self, served: ServedEndpoint) -> None:
        self._served.append(served)
        if self.status_server is not None:
            self.status_server.register_health(served.endpoint.subject,
                                               served.healthy)

    def untrack_served(self, served: ServedEndpoint) -> None:
        if served in self._served:
            self._served.remove(served)
        if self.status_server is not None:
            self.status_server.unregister_health(served.endpoint.subject)

    async def shutdown(self) -> None:
        """Graceful shutdown: deregister + drain endpoints, revoke the lease,
        close transports (ref: GracefulShutdownTracker distributed.rs:18)."""
        for served in list(self._served):
            await served.shutdown()
        if self._keepalive_task:
            self._keepalive_task.cancel()
            try:
                await self._keepalive_task
            except asyncio.CancelledError:
                pass
        for manager in self._subscriber_managers:
            await manager.close()
        self._subscriber_managers.clear()
        for publisher in self._publishers:
            await publisher.close()
        self._publishers.clear()
        if self.lease is not None:
            try:
                await self.discovery.revoke_lease(self.lease)
            except Exception:  # noqa: BLE001
                pass
        await self.request_client.close()
        await self.request_server.close()
        if self.status_server is not None:
            await self.status_server.close()
        await self.discovery.close()
        self._started = False
