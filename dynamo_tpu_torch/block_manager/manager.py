"""KvBlockManager: the multi-tier KV cache facade (G1 -> G2 -> G3 -> G4).

Port of `dynamo_tpu/block_manager/manager.py`. Tiers on one card:

  G1 device memory - the engine's paged pool (engine.pages.PagePool keeps
                     the bookkeeping; the runner owns the tensors)
  G2 host RAM      - HostArena TierPool, page-locked on the card
  G3 local disk    - DiskArena TierPool
  G4 object store  - ObjectStore (opaque blobs: a directory or an S3/GCS-
                     shaped HTTP endpoint)

Data flows, as in the reference:
  offload  G1 -> G2 on registration (TinyLFU-gated, asynchronous through
           OffloadManager), G2 -> G3 on host eviction, G3 -> G4 on disk
           eviction (or G2 -> G4 without a disk tier)
  onboard  G2/G3/G4 -> G1 at admission, replacing prefill compute for the
           matched prompt blocks; G3/G4 hits are promoted into G2 on read.

Also the session tier's pin leases (`pin_blocks`, `sweep_pins`, clamped to
DYNT_PIN_TTL_SECS), `prefetch` on its own thread, and the park store of
preempted sequences (`park_sequence` / `claim_parked` / `drop_parked`).
Blocks are CPU torch tensors of the layout's dtype.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..config import env
from .layout import BlockLayoutSpec
from .offload import OffloadManager
from .pool import TierPool
from .storage import DiskArena, HostArena, ObjectStore, TransientStorageError

log = logging.getLogger("dynamo_tpu_torch.kvbm.manager")


@dataclasses.dataclass
class KvbmConfig:
    """Sizing knobs (counts are universal blocks, i.e. G1 pages)."""

    host_blocks: int = 0  # 0 disables the G2 tier (and everything below)
    disk_blocks: int = 0  # 0 disables G3
    disk_path: Optional[str] = None
    object_store_root: Optional[str] = None  # G4 (unbounded blob store)
    offload_batch: int = 8
    admission: bool = True  # TinyLFU gate on G2/G3 inserts

    @property
    def enabled(self) -> bool:
        return self.host_blocks > 0


@dataclasses.dataclass
class KvbmStats:
    offloaded: int = 0  # blocks landed in G2
    onboarded_blocks: int = 0
    onboard_hits_host: int = 0
    onboard_hits_disk: int = 0
    onboard_hits_object: int = 0


class KvBlockManager:
    def __init__(
        self,
        config: KvbmConfig,
        layout: BlockLayoutSpec,
        *,
        on_stored: Optional[Callable[[str, list[int]], None]] = None,
        on_removed: Optional[Callable[[str, list[int]], None]] = None,
        pin_memory: Optional[bool] = None,
    ) -> None:
        """on_stored/on_removed: per-tier event hooks `(tier, hashes)` —
        the analog of KVBM Register/Remove events on the event plane.
        pin_memory page-locks the G2 slab and the onboard bundles (default:
        when a card is present); the worker sets it from its device."""
        if pin_memory is None:
            pin_memory = torch.cuda.is_available()
        self.pin_memory = bool(pin_memory)
        self.config = config
        self.layout = layout
        self.stats = KvbmStats()
        # Tier pools are touched by two threads — the scheduler thread
        # (match/read/promote at admission) and the offload worker thread
        # (insert + eviction cascade). One RLock serializes them; cascade
        # callbacks re-enter it on the same thread. Arena reads are copied
        # out under the lock before the slot can be recycled.
        self._lock = threading.RLock()
        ev_s = on_stored or (lambda tier, hs: None)
        ev_r = on_removed or (lambda tier, hs: None)

        self.object_store: Optional[ObjectStore] = None
        if config.object_store_root:
            self.object_store = ObjectStore(layout, config.object_store_root)

        self.disk: Optional[TierPool] = None
        if config.disk_blocks > 0:
            if not config.disk_path:
                raise ValueError("disk_blocks > 0 requires disk_path")
            self.disk = TierPool(
                "g3", DiskArena(layout, config.disk_blocks, config.disk_path),
                admission=config.admission,
                on_evict=self._on_disk_evict,
                on_stored=lambda hs: ev_s("g3", hs),
                on_removed=lambda hs: ev_r("g3", hs),
            )

        self.host = TierPool(
            "g2", HostArena(layout, config.host_blocks,
                            pin_memory=self.pin_memory),
            admission=config.admission,
            on_evict=self._on_host_evict,
            on_stored=lambda hs: ev_s("g2", hs),
            on_removed=lambda hs: ev_r("g2", hs),
        )
        self.offload: Optional[OffloadManager] = None
        # Session-tier pin leases (docs/prompt-caching.md): hash ->
        # lease expiry (monotonic). A leased block is held against tier
        # eviction (TierPool pin refcount) wherever it currently lives;
        # _pins_applied records which pool holds the refcount so expiry
        # releases exactly once. Leases ALWAYS die at TTL.
        self._pin_leases: dict[int, float] = {}
        self._pins_applied: dict[int, str] = {}
        self._prefetch_q: Optional[object] = None
        self._prefetch_thread = None
        # Preempt-to-KVBM park store (docs/multi-tenancy.md): request_id
        # -> host KV bundle of a preempted sequence's computed pages.
        # NOT hash-keyed cache — parked state must survive until claimed
        # (a resume that finds its bundle evicted would silently corrupt
        # the stream), so it lives outside the tier pools' eviction.
        # Exactly-once discipline: park puts, claim takes (returns None
        # on a second claim), drop cleans up cancel/expiry paths.
        self._parked_seqs: dict[str, torch.Tensor] = {}

    # -- wiring ------------------------------------------------------------

    def attach_engine(
        self,
        *,
        lookup_pages: Callable[[list[int]], list[Optional[int]]],
        gather: Callable[[np.ndarray], object],
        run_in_step,
        step_pressure=None,
        to_host=None,
    ) -> None:
        """Connect the G1 side (scheduler/runner) and start the offload
        worker. `lookup_pages` resolves block hashes to live G1 pages on
        the scheduler thread; `step_pressure` (optional) reports the
        engine's recent step wall time so the offload bandwidth budget
        backs off under serving load (docs/kvbm.md overlap discipline);
        `to_host` (the runner's `bundle_to_host`) copies a device bundle to
        the host on the offload thread."""
        self.offload = OffloadManager(
            lookup_pages=lookup_pages, gather=gather, run_in_step=run_in_step,
            sink=self._offload_sink, batch_size=self.config.offload_batch,
            skip=self._already_tiered, step_pressure=step_pressure,
            to_host=to_host,
        )

    def notify_stored(self, hashes: list[int], parent: Optional[int]) -> None:
        """G1 on_stored hook → queue D2H offload."""
        if self.offload is not None:
            self.offload.notify_stored(hashes, parent)

    # -- offload path ------------------------------------------------------

    def _already_tiered(self, h: int) -> bool:
        with self._lock:
            if self.host.contains(h):
                return True
            if self.disk is not None and self.disk.contains(h):
                return True
            return False

    def _offload_sink(self, h: int, block: torch.Tensor,
                      parent: Optional[int]) -> None:
        with self._lock:
            if self.host.insert(h, block, parent):
                self.stats.offloaded += 1
            if h in self._pin_leases:
                # A pin-ahead lease (pinned while the block still lived
                # only in G1) attaches the moment the block lands in a
                # tier we can protect.
                self._apply_pin(h)

    def _on_host_evict(self, h: int, data: torch.Tensor) -> None:
        if self.disk is not None:
            self.disk.insert(h, data)
        elif self.object_store is not None:
            self._g4_put(h, data)

    def _on_disk_evict(self, h: int, data: torch.Tensor) -> None:
        if self.object_store is not None:
            self._g4_put(h, data)

    def _g4_put(self, h: int, data: torch.Tensor) -> None:
        """Eviction cascades can run on the SCHEDULER thread (a G4
        onboard hit promotes into G2, whose eviction lands here), often
        under the manager lock — so the put is fail_fast (one attempt,
        no retry sleeps that would stall the engine loop) and a failure
        drops the evicted cache block instead of crashing."""
        try:
            self.object_store.put(h, data, fail_fast=True)
        except TransientStorageError:
            log.warning("G4 put failed; evicted block %x dropped", h)

    # -- onboard path (scheduler thread, admission time) -------------------

    def match_prefix(self, hashes: list[int]) -> int:
        """Longest contiguous prefix available in G2/G3/G4."""
        with self._lock:
            n = 0
            for h in hashes:
                if self.host.contains(h):
                    n += 1
                elif self.disk is not None and self.disk.contains(h):
                    n += 1
                elif (self.object_store is not None
                      and self.object_store.contains(h)):
                    n += 1
                else:
                    break
            return n

    def read_blocks(self, hashes: list[int]) -> Optional[torch.Tensor]:
        """Read a run of blocks as a bundle [n, *block_shape] (a CPU
        tensor, page-locked with pin_memory, so its upload is one DMA copy
        off the step stream); G3/G4 hits are promoted into G2 (standard
        tiering promotion). Returns None if any block is missing (caller
        falls back to compute)."""
        out = torch.empty((len(hashes),) + self.layout.block_shape,
                          dtype=self.layout.torch_dtype,
                          pin_memory=self.pin_memory)
        with self._lock:
            for i, h in enumerate(hashes):
                data = self.host.get(h)
                if data is not None:
                    self.stats.onboard_hits_host += 1
                elif self.disk is not None and (
                        data := self.disk.get(h)) is not None:
                    self.stats.onboard_hits_disk += 1
                    self.host.insert(h, data)
                elif self.object_store is not None and (
                        data := self.object_store.get(h)) is not None:
                    self.stats.onboard_hits_object += 1
                    self.host.insert(h, data)
                else:
                    return None
                # Copy out under the lock: arena reads are views, and the
                # offload thread may recycle the slot after we release.
                out[i].copy_(data)
            # Still under _lock: the offload thread bumps stats.offloaded
            # through _offload_sink concurrently and `+=` on the shared
            # stats object is a read-modify-write.
            self.stats.onboarded_blocks += len(hashes)
        return out

    # -- preempt park store (docs/multi-tenancy.md) ------------------------

    def park_sequence(self, request_id: str, bundle: torch.Tensor) -> bool:
        """Store a preempted sequence's gathered KV pages until resume.
        Idempotent on the same request id (a re-park refreshes the
        bundle). Returns True when parked."""
        with self._lock:
            self._parked_seqs[request_id] = bundle
        return True

    def claim_parked(self, request_id: str) -> Optional[torch.Tensor]:
        """Take a parked bundle EXACTLY ONCE: the first claim returns
        it and removes it, a second claim (double-resume bug) returns
        None so the caller degrades to migrate instead of scattering a
        stale buffer."""
        with self._lock:
            return self._parked_seqs.pop(request_id, None)

    def drop_parked(self, request_id: str) -> bool:
        """Discard a parked bundle (cancelled client / expired
        deadline). Idempotent; returns whether a bundle was present."""
        with self._lock:
            return self._parked_seqs.pop(request_id, None) is not None

    def parked_count(self) -> int:
        with self._lock:
            return len(self._parked_seqs)

    # -- session pin leases (docs/prompt-caching.md) ----------------------

    def _apply_pin(self, h: int) -> None:
        """Attach the tier-level eviction hold for a leased hash (at
        most one hold per hash; caller holds the lock)."""
        if h in self._pins_applied:
            return
        if self.host.contains(h):
            self.host.pin(h)
            self._pins_applied[h] = "g2"
        elif self.disk is not None and self.disk.contains(h):
            self.disk.pin(h)
            self._pins_applied[h] = "g3"

    def _release_pin(self, h: int) -> None:
        tier = self._pins_applied.pop(h, None)
        if tier == "g2":
            self.host.unpin(h)
        elif tier == "g3" and self.disk is not None:
            self.disk.unpin(h)

    def pin_blocks(self, hashes: list[int], ttl: float,
                   now: Optional[float] = None) -> int:
        """Lease `hashes` against tier eviction until now+ttl (clamped
        to DYNT_PIN_TTL_SECS). Re-pinning refreshes the expiry. Blocks
        not yet tiered get a pin-ahead lease that attaches when the
        offload path lands them. Returns the number of leases taken."""
        import time as _time

        now = _time.monotonic() if now is None else now
        ttl = min(float(ttl), env("DYNT_PIN_TTL_SECS")) if ttl \
            else env("DYNT_PIN_TTL_SECS")
        with self._lock:
            self.sweep_pins(now)
            for h in hashes:
                expiry = now + ttl
                prev = self._pin_leases.get(h)
                self._pin_leases[h] = max(prev or 0.0, expiry)
                self._apply_pin(h)
            return len(hashes)

    def sweep_pins(self, now: Optional[float] = None) -> int:
        """Release every lease past its TTL (a pin can never outlive
        it). Called from the pin path and the worker's load loop."""
        import time as _time

        now = _time.monotonic() if now is None else now
        with self._lock:
            dead = [h for h, exp in self._pin_leases.items() if exp <= now]
            for h in dead:
                self._pin_leases.pop(h, None)
                self._release_pin(h)
            return len(dead)

    def pinned_blocks(self) -> int:
        with self._lock:
            return len(self._pin_leases)

    def prefetch(self, hashes: list[int]) -> None:
        """Promote G3/G4 residents of `hashes` into G2 off the request
        path, so a cached turn's admission-time onload (scheduler
        `_onboard_from_kvbm` -> G1 scatter inside the step/gap
        discipline) hits host RAM instead of disk or the network.
        Host-side work only — runs on a dedicated daemon thread."""
        if self.disk is None and self.object_store is None:
            return
        import queue as _queue
        import threading

        if self._prefetch_q is None:
            self._prefetch_q = _queue.Queue(maxsize=256)
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_loop, name="kvbm-prefetch",
                daemon=True)
            self._prefetch_thread.start()
        try:
            self._prefetch_q.put_nowait(list(hashes))
        except _queue.Full:
            pass  # best-effort: admission falls back to G3/G4 reads

    def _prefetch_loop(self) -> None:
        while True:
            hashes = self._prefetch_q.get()
            if hashes is None:
                return
            # Anchored prefixes are contiguous chains with co-resident
            # blocks: once one block misses G4, the rest of the chain
            # is almost surely absent too (most commonly the whole
            # prefix still lives only in G1). Stop probing the network
            # after the first miss — bounds futile G4 GETs to one per
            # prefetch instead of one per block.
            probe_g4 = True
            for h in hashes:
                try:
                    if self._promote_one(h, probe_g4=probe_g4) == "miss":
                        probe_g4 = False
                except Exception:  # noqa: BLE001 — prefetch is
                    # best-effort; a failed promotion degrades to the
                    # admission-time read path
                    log.exception("prefetch promote failed for %x", h)

    def _promote_one(self, h: int, probe_g4: bool = True) -> str:
        """Promote one block into G2 if it lives below; returns
        "resident" (already in G2), "promoted", or "miss". The G3 read
        happens under the lock (TierPool/arena structures are not
        thread-safe and the memmap read is page-cache fast); only the
        G4 network fetch runs outside it."""
        with self._lock:
            if self.host.contains(h):
                return "resident"
            data = self.disk.get(h) if self.disk is not None else None
        if data is None:
            if not probe_g4 or self.object_store is None:
                return "miss"
            # G4 fetch outside the lock: a network read must not stall
            # the scheduler thread's admission-time lookups.
            data = self.object_store.get(h)
        if data is None:
            return "miss"
        with self._lock:
            if self.host.insert(h, data) and h in self._pin_leases:
                # The hold follows the block up-tier.
                self._release_pin(h)
                self._apply_pin(h)
        return "promoted"

    # -- introspection / lifecycle ----------------------------------------

    def usage(self) -> dict:
        with self._lock:
            info = {
                "g2_blocks": len(self.host),
                "g2_usage": self.host.usage(),
                "offloaded": self.stats.offloaded,
                "onboarded": self.stats.onboarded_blocks,
            }
            if self.offload is not None:
                info["offload_queue"] = self.offload.queue_depth()
                info["offload_dropped"] = self.offload.dropped_count()
            if self.disk is not None:
                info["g3_blocks"] = len(self.disk)
                info["g3_usage"] = self.disk.usage()
            return info

    def flush(self, timeout: float = 30.0) -> bool:
        return self.offload.flush(timeout) if self.offload else True

    def close(self) -> None:
        if self.offload is not None:
            self.offload.close()
        if self._prefetch_q is not None:
            self._prefetch_q.put(None)  # type: ignore[union-attr]
            self._prefetch_thread.join(timeout=5.0)
            self._prefetch_q = None
        if self.disk is not None:
            self.disk.arena.close()
