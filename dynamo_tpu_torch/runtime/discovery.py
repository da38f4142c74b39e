"""Discovery plane: lease-based KV store with prefix watch.

Port of `dynamo_tpu/runtime/discovery.py`. Values are written under a lease
with a TTL kept alive by the owner; when the owner dies the lease expires and
watchers see deletes (ref: docs/design-docs/discovery-plane.md, "Lease-Based
Cleanup", 10s TTL). Two backends:
  * MemDiscovery  — process-local, for tests (many runtimes, one process)
  * FileDiscovery — one shared directory, across processes on a host; watch
                    is poll-based. Its tree is the reference's (same key to
                    path mapping, same JSON records, same lease files), so
                    the two packages read each other's registrations.
etcd and kube are not ported yet.

Keys follow the reference layout:
  v1/instances/{namespace}/{component}/{endpoint}/{instance_id}  -> endpoint info
  v1/mdc/{namespace}/{component}/{endpoint}/{instance_id}        -> model card
"""

from __future__ import annotations

import asyncio
import dataclasses
import errno
import json
import logging
import os
import time
import uuid
from typing import AsyncIterator, Callable, Optional

log = logging.getLogger("dynamo_tpu_torch.discovery")

INSTANCE_PREFIX = "v1/instances"
MODEL_CARD_PREFIX = "v1/mdc"


@dataclasses.dataclass(frozen=True)
class KvEvent:
    """A watch event. kind is 'put' or 'delete'."""

    kind: str
    key: str
    value: Optional[dict] = None


@dataclasses.dataclass
class Lease:
    lease_id: str
    ttl: float


class Discovery:
    """Abstract lease-based KV discovery store."""

    async def start(self) -> None:  # pragma: no cover - trivial
        pass

    async def close(self) -> None:  # pragma: no cover - trivial
        pass

    async def create_lease(self, ttl: float) -> Lease:
        raise NotImplementedError

    async def keep_alive(self, lease: Lease) -> None:
        """Refresh a lease; called periodically by the runtime."""
        raise NotImplementedError

    async def revoke_lease(self, lease: Lease) -> None:
        raise NotImplementedError

    async def put(self, key: str, value: dict, lease: Optional[Lease] = None) -> None:
        raise NotImplementedError

    async def delete(self, key: str) -> None:
        raise NotImplementedError

    async def get_prefix(self, prefix: str) -> dict[str, dict]:
        raise NotImplementedError

    async def watch_prefix(
        self, prefix: str, include_existing: bool = True
    ) -> "Watch":
        raise NotImplementedError


class Watch:
    """A prefix watch: an async iterator of KvEvent plus a cancel handle."""

    def __init__(self, on_cancel: Optional[Callable[["Watch"], None]] = None) -> None:
        self._queue: asyncio.Queue[Optional[KvEvent]] = asyncio.Queue()
        self._cancelled = False
        self._on_cancel = on_cancel

    def _emit(self, event: KvEvent) -> None:
        if not self._cancelled:
            self._queue.put_nowait(event)

    async def cancel(self) -> None:
        self._cancelled = True
        self._queue.put_nowait(None)
        if self._on_cancel is not None:
            self._on_cancel(self)

    def __aiter__(self) -> AsyncIterator[KvEvent]:
        return self

    async def __anext__(self) -> KvEvent:
        event = await self._queue.get()
        if event is None:
            raise StopAsyncIteration
        return event


# ---------------------------------------------------------------------------
# In-memory backend (ref: lib/runtime/src/storage/kv/mem.rs)
# ---------------------------------------------------------------------------


class _MemStore:
    """Shared store so multiple MemDiscovery handles in one process see each
    other — the test analog of one etcd cluster."""

    def __init__(self) -> None:
        self.data: dict[str, dict] = {}
        self.key_lease: dict[str, str] = {}
        self.lease_keys: dict[str, set[str]] = {}
        self.lease_deadline: dict[str, float] = {}
        self.lease_ttl: dict[str, float] = {}
        self.watches: list[tuple[str, Watch, asyncio.AbstractEventLoop]] = []

    def notify(self, event: KvEvent) -> None:
        for entry in list(self.watches):
            prefix, watch, loop = entry
            if loop.is_closed() or watch._cancelled:
                try:
                    self.watches.remove(entry)
                except ValueError:
                    pass
                continue
            if event.key.startswith(prefix):
                loop.call_soon_threadsafe(watch._emit, event)


_MEM_STORES: dict[str, _MemStore] = {}


class MemDiscovery(Discovery):
    def __init__(self, cluster: str = "default", reaper_interval: float = 0.5) -> None:
        self._store = _MEM_STORES.setdefault(cluster, _MemStore())
        self._reaper_interval = reaper_interval
        self._reaper_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        if self._reaper_task is None:
            self._reaper_task = asyncio.create_task(self._reap_loop())

    async def close(self) -> None:
        if self._reaper_task is not None:
            self._reaper_task.cancel()
            try:
                await self._reaper_task
            except asyncio.CancelledError:
                pass
            self._reaper_task = None

    async def _reap_loop(self) -> None:
        while True:
            await asyncio.sleep(self._reaper_interval)
            now = time.monotonic()
            expired = [
                lid
                for lid, deadline in self._store.lease_deadline.items()
                if deadline < now
            ]
            for lid in expired:
                self._expire(lid)

    def _expire(self, lease_id: str) -> None:
        keys = self._store.lease_keys.pop(lease_id, set())
        self._store.lease_deadline.pop(lease_id, None)
        self._store.lease_ttl.pop(lease_id, None)
        for key in keys:
            if self._store.key_lease.get(key) == lease_id:
                self._store.data.pop(key, None)
                self._store.key_lease.pop(key, None)
                self._store.notify(KvEvent("delete", key))

    async def create_lease(self, ttl: float) -> Lease:
        lease = Lease(lease_id=uuid.uuid4().hex, ttl=ttl)
        self._store.lease_deadline[lease.lease_id] = time.monotonic() + ttl
        self._store.lease_ttl[lease.lease_id] = ttl
        self._store.lease_keys.setdefault(lease.lease_id, set())
        return lease

    async def keep_alive(self, lease: Lease) -> None:
        if lease.lease_id not in self._store.lease_deadline:
            raise LeaseExpired(lease.lease_id)
        self._store.lease_deadline[lease.lease_id] = time.monotonic() + lease.ttl

    async def revoke_lease(self, lease: Lease) -> None:
        self._expire(lease.lease_id)

    async def put(self, key: str, value: dict, lease: Optional[Lease] = None) -> None:
        self._store.data[key] = value
        # Re-putting a key rebinds (or clears) its lease, matching etcd.
        old_lease = self._store.key_lease.pop(key, None)
        if old_lease is not None:
            self._store.lease_keys.get(old_lease, set()).discard(key)
        if lease is not None:
            if lease.lease_id not in self._store.lease_deadline:
                raise LeaseExpired(lease.lease_id)
            self._store.key_lease[key] = lease.lease_id
            self._store.lease_keys[lease.lease_id].add(key)
        self._store.notify(KvEvent("put", key, value))

    async def delete(self, key: str) -> None:
        if key in self._store.data:
            self._store.data.pop(key, None)
            self._store.key_lease.pop(key, None)
            self._store.notify(KvEvent("delete", key))

    async def get_prefix(self, prefix: str) -> dict[str, dict]:
        return {k: v for k, v in self._store.data.items() if k.startswith(prefix)}

    async def watch_prefix(self, prefix: str, include_existing: bool = True) -> Watch:
        def _remove(w: Watch) -> None:
            self._store.watches = [
                t for t in self._store.watches if t[1] is not w
            ]

        watch = Watch(on_cancel=_remove)
        loop = asyncio.get_running_loop()
        if include_existing:
            for key, value in sorted(self._store.data.items()):
                if key.startswith(prefix):
                    watch._emit(KvEvent("put", key, value))
        self._store.watches.append((prefix, watch, loop))
        return watch


class LeaseExpired(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# File backend (ref: lib/runtime/src/storage/kv/file.rs)
# ---------------------------------------------------------------------------


def _key_to_path(root: str, key: str) -> str:
    # Keys contain '/' — map to a flat file name so prefix scans are one listdir.
    return os.path.join(root, "kv", key.replace("/", "\x01") + ".json")


def _path_to_key(root: str, path: str) -> str:
    name = os.path.basename(path)
    return name[: -len(".json")].replace("\x01", "/")


class FileDiscovery(Discovery):
    """Directory-backed discovery. Leases are heartbeat files whose mtime the
    owner refreshes; a key is live iff its lease file is fresh. Every handle
    runs a reaper so dead owners' keys get deleted even if the owner crashed.
    """

    def __init__(self, root: str, poll_interval: float = 0.25) -> None:
        self._root = root
        self._poll = poll_interval
        self._tasks: list[asyncio.Task] = []
        self._watches: list[tuple[str, Watch]] = []
        self._closed = False
        os.makedirs(os.path.join(root, "kv"), exist_ok=True)
        os.makedirs(os.path.join(root, "leases"), exist_ok=True)

    def _lease_path(self, lease_id: str) -> str:
        return os.path.join(self._root, "leases", lease_id + ".lease")

    async def start(self) -> None:
        self._tasks.append(asyncio.create_task(self._reap_loop()))

    async def close(self) -> None:
        self._closed = True
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._tasks.clear()

    def _lease_alive(self, lease_id: str) -> bool:
        path = self._lease_path(lease_id)
        try:
            with open(path) as f:
                meta = json.load(f)
            return os.path.getmtime(path) + meta["ttl"] > time.time()
        except (OSError, ValueError, KeyError):
            return False

    async def _reap_loop(self) -> None:
        while True:
            await asyncio.sleep(self._poll)
            try:
                # Directory scans + per-file reads go to a worker thread: on
                # NFS/GCS-fuse each stat is a network round-trip and must not
                # stall the event loop serving requests in this process.
                # Snapshot the watch list ON THE LOOP before hopping to
                # the worker thread: _dispatch_watch_diffs rebinds
                # self._watches loop-side, and the thread iterating the
                # live attribute raced that rebind.
                scans = await asyncio.to_thread(self._reap_and_scan,
                                                list(self._watches))
                self._dispatch_watch_diffs(scans)
            except OSError as exc:  # transient fs races are fine
                if exc.errno not in (errno.ENOENT,):
                    log.warning("file discovery reap error: %s", exc)

    def _reap_and_scan(
        self, watches: list[tuple[str, "Watch"]]
    ) -> list[tuple[Watch, dict[str, dict]]]:
        """Thread-side: reap stale leases, then scan each live watch's
        prefix. `watches` is a loop-side snapshot of self._watches."""
        self._reap_once()
        out: list[tuple[Watch, dict[str, dict]]] = []
        for prefix, watch in watches:
            if not watch._cancelled:
                out.append((watch, self._scan(prefix)))
        return out

    def _dispatch_watch_diffs(
        self, scans: list[tuple[Watch, dict[str, dict]]]
    ) -> None:
        """Loop-side: diff snapshots against each watch and emit events."""
        self._watches = [(p, w) for p, w in self._watches if not w._cancelled]
        live = {w for _p, w in self._watches}
        for watch, current in scans:
            if watch not in live:
                continue
            snapshot = getattr(watch, "_snapshot", {})
            for key, value in current.items():
                if key not in snapshot or snapshot[key] != value:
                    watch._emit(KvEvent("put", key, value))
            for key in snapshot:
                if key not in current:
                    watch._emit(KvEvent("delete", key))
            watch._snapshot = current

    def _reap_once(self) -> None:
        kv_dir = os.path.join(self._root, "kv")
        for name in os.listdir(kv_dir):
            path = os.path.join(kv_dir, name)
            try:
                with open(path) as f:
                    entry = json.load(f)
            except (OSError, ValueError):
                continue
            lease_id = entry.get("lease")
            if lease_id and not self._lease_alive(lease_id):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        # Reap long-dead lease files too (keep them one TTL past expiry so
        # the owner's next keep_alive can still observe LeaseExpired).
        lease_dir = os.path.join(self._root, "leases")
        now = time.time()
        for name in os.listdir(lease_dir):
            path = os.path.join(lease_dir, name)
            try:
                with open(path) as f:
                    ttl = json.load(f)["ttl"]
                if os.path.getmtime(path) + 2 * ttl < now:
                    os.unlink(path)
            except (OSError, ValueError, KeyError):
                continue

    # watch implementation: each poll, diff the directory against a snapshot
    def _scan(self, prefix: str) -> dict[str, dict]:
        kv_dir = os.path.join(self._root, "kv")
        out: dict[str, dict] = {}
        try:
            names = os.listdir(kv_dir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            key = _path_to_key(self._root, name)
            if not key.startswith(prefix):
                continue
            try:
                with open(os.path.join(kv_dir, name)) as f:
                    entry = json.load(f)
            except (OSError, ValueError):
                continue
            out[key] = entry["value"]
        return out

    async def create_lease(self, ttl: float) -> Lease:
        lease = Lease(lease_id=uuid.uuid4().hex, ttl=ttl)
        with open(self._lease_path(lease.lease_id), "w") as f:
            json.dump({"ttl": ttl, "pid": os.getpid()}, f)
        return lease

    async def keep_alive(self, lease: Lease) -> None:
        path = self._lease_path(lease.lease_id)
        # A stale lease must NOT be resurrected: its keys were already reaped
        # cluster-wide, so the owner has to learn it expired (matching etcd,
        # where keep-alive of an expired lease errors).
        if not self._lease_alive(lease.lease_id):
            try:
                os.unlink(path)
            except OSError:
                pass
            raise LeaseExpired(lease.lease_id)
        os.utime(path)

    async def revoke_lease(self, lease: Lease) -> None:
        try:
            os.unlink(self._lease_path(lease.lease_id))
        except OSError:
            pass
        # Eagerly drop this lease's keys so watchers see deletes promptly.
        kv_dir = os.path.join(self._root, "kv")
        for name in os.listdir(kv_dir):
            path = os.path.join(kv_dir, name)
            try:
                with open(path) as f:
                    entry = json.load(f)
                if entry.get("lease") == lease.lease_id:
                    os.unlink(path)
            except (OSError, ValueError):
                continue

    async def put(self, key: str, value: dict, lease: Optional[Lease] = None) -> None:
        if lease is not None and not self._lease_alive(lease.lease_id):
            raise LeaseExpired(lease.lease_id)
        path = _key_to_path(self._root, key)
        tmp = path + f".tmp.{os.getpid()}.{uuid.uuid4().hex[:6]}"
        with open(tmp, "w") as f:
            json.dump(
                {"value": value, "lease": lease.lease_id if lease else None}, f
            )
        os.replace(tmp, path)

    async def delete(self, key: str) -> None:
        try:
            os.unlink(_key_to_path(self._root, key))
        except OSError:
            pass

    async def get_prefix(self, prefix: str) -> dict[str, dict]:
        def _scan_sync() -> dict[str, dict]:
            self._reap_once()
            return self._scan(prefix)

        return await asyncio.to_thread(_scan_sync)

    async def watch_prefix(self, prefix: str, include_existing: bool = True) -> Watch:
        watch = Watch()
        current = self._scan(prefix)
        if include_existing:
            for key in sorted(current):
                watch._emit(KvEvent("put", key, current[key]))
            watch._snapshot = current
        else:
            watch._snapshot = current
        self._watches.append((prefix, watch))
        return watch


def make_discovery(backend: str, *, path: str = "", cluster: str = "") -> Discovery:
    if backend == "mem":
        # For mem, `path` doubles as the cluster key so tests can isolate
        # logical clusters within one process.
        return MemDiscovery(cluster=cluster or path or "default")
    if backend == "file":
        return FileDiscovery(path or "/tmp/dynamo_tpu_discovery")
    if backend in ("etcd", "kube"):
        raise NotImplementedError(
            f"{backend} discovery is not ported yet (mem | file)")
    raise ValueError(
        f"unknown discovery backend: {backend!r} "
        "(expected mem|file|etcd|kube)")
