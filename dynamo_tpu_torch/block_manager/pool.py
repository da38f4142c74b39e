"""Tier block pool: free list, dedup registry, LRU + TinyLFU.

Port of `dynamo_tpu/block_manager/pool.py`, the logical layer of one tier
(G2 host / G3 disk); the G1 device tier is `engine.pages.PagePool`. Blocks
are CPU torch tensors (bf16 too), read from and written to the tier's arena
(`storage.HostArena` / `storage.DiskArena`).

Eviction: the LRU victim among unpinned registered blocks, gated by a
TinyLFU admission filter (`kv_router/tinylfu.py`, the reference's filter
verbatim): a cold candidate does not displace a hot victim. Evicted blocks
flow to `on_evict(hash, data)` so the owning manager can cascade them down
a tier before the slot is reused.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional

import torch

from .state import BlockHandle
from ..kv_router.tinylfu import TinyLfu


@dataclasses.dataclass
class TierStats:
    inserted: int = 0
    duplicates: int = 0
    rejected: int = 0  # TinyLFU admission refusals
    evicted: int = 0
    hits: int = 0
    misses: int = 0


class TierPool:
    def __init__(
        self,
        name: str,
        arena,  # HostArena | DiskArena
        *,
        admission: bool = True,
        on_evict: Optional[Callable[[int, torch.Tensor], None]] = None,
        on_stored: Optional[Callable[[list[int]], None]] = None,
        on_removed: Optional[Callable[[list[int]], None]] = None,
    ) -> None:
        self.name = name
        self.arena = arena
        self.capacity = arena.capacity
        self._blocks = [BlockHandle(i) for i in range(arena.capacity)]
        self._free: list[int] = list(range(arena.capacity - 1, -1, -1))
        self._registry: dict[int, int] = {}  # sequence_hash -> slot idx
        self._lru: OrderedDict[int, None] = OrderedDict()  # hash, LRU first
        self._pins: dict[int, int] = {}  # hash -> active readers
        self._lfu = TinyLfu(arena.capacity) if admission else None
        self.on_evict = on_evict or (lambda h, d: None)
        self.on_stored = on_stored or (lambda hs: None)
        self.on_removed = on_removed or (lambda hs: None)
        self.stats = TierStats()

    def __len__(self) -> int:
        return len(self._registry)

    def contains(self, h: int) -> bool:
        return h in self._registry

    def match_prefix(self, hashes: list[int]) -> int:
        n = 0
        for h in hashes:
            if h in self._registry:
                n += 1
            else:
                break
        return n

    def usage(self) -> float:
        return len(self._registry) / max(1, self.capacity)

    # -- read path ---------------------------------------------------------

    def get(self, h: int) -> Optional[torch.Tensor]:
        idx = self._registry.get(h)
        if idx is None:
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        self._lru.move_to_end(h)
        if self._lfu is not None:
            self._lfu.touch(h)
        return self.arena.read(idx)

    def pin(self, h: int) -> bool:
        """Hold a block against eviction while a transfer reads it."""
        if h not in self._registry:
            return False
        self._pins[h] = self._pins.get(h, 0) + 1
        return True

    def unpin(self, h: int) -> None:
        n = self._pins.get(h, 0) - 1
        if n <= 0:
            self._pins.pop(h, None)
        else:
            self._pins[h] = n

    # -- write path --------------------------------------------------------

    def _evict_one(self, candidate: int) -> Optional[int]:
        """Free one slot via LRU+TinyLFU; returns slot idx or None if the
        candidate loses admission / everything is pinned."""
        victim = next((h for h in self._lru if not self._pins.get(h)), None)
        if victim is None:
            return None
        if self._lfu is not None and not self._lfu.admit(candidate, victim):
            self.stats.rejected += 1
            return None
        idx = self._registry.pop(victim)
        self._lru.pop(victim, None)
        block = self._blocks[idx]
        # Hand the cascade a COPY: the callback may trigger further
        # evictions/writes that recycle arena slots the view aliases.
        self.on_evict(victim, self.arena.read(idx).clone())
        block.reset()  # Registered -> Reset (RAII drop in the reference)
        self.stats.evicted += 1
        self.on_removed([victim])
        return idx

    def insert(self, h: int, data: torch.Tensor,
               parent: Optional[int] = None) -> bool:
        """Register block `h`. Returns False if rejected (admission) or a
        duplicate. Runs the full lifecycle: Reset→Partial→Complete→
        Registered (ref kvbm-design.md §Example Block Lifecycle)."""
        if self._lfu is not None:
            self._lfu.touch(h)
        if h in self._registry:
            self.stats.duplicates += 1
            self._lru.move_to_end(h)
            return False
        if self._free:
            idx = self._free.pop()
        else:
            idx = self._evict_one(h)
            if idx is None:
                return False
        block = self._blocks[idx]
        block.init_sequence()  # Reset -> Partial
        self.arena.write(idx, data)
        block.commit(h, parent)  # Partial -> Complete
        block.register()  # Complete -> Registered
        self._registry[h] = idx
        self._lru[h] = None
        self.stats.inserted += 1
        self.on_stored([h])
        return True

    def remove(self, h: int) -> bool:
        idx = self._registry.pop(h, None)
        if idx is None:
            return False
        self._lru.pop(h, None)
        self._pins.pop(h, None)
        self._blocks[idx].reset()
        self._free.append(idx)
        self.on_removed([h])
        return True

    def clear(self) -> int:
        hashes = list(self._registry)
        for h in hashes:
            self.remove(h)
        return len(hashes)
