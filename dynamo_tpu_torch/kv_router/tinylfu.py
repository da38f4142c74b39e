"""TinyLFU admission filter.

Verbatim copy of `dynamo_tpu/block_manager/tinylfu.py` (framework-free):
the port's radix tree uses it for frequency-gated insertion at its node
cap (DYNT_INDEXER_ADMISSION).

The reference's KVBM v2 uses TinyLFU to decide which blocks earn a slot in
a lower tier (ref: lib/kvbm-logical/src/tinylfu.rs). The structure is the
standard one (Einziger et al., "TinyLFU: A Highly Efficient Cache Admission
Policy"): a 4-row count-min sketch of 4-bit counters approximates access
frequency over a sliding sample window (halved every `sample_size`
touches), fronted by a doorkeeper set that absorbs one-hit-wonders. On a
full pool, a candidate is admitted only if its estimated frequency beats
the eviction victim's — keeping scan traffic (one-shot long prompts) from
flushing hot shared prefixes out of host/disk tiers.
"""

from __future__ import annotations

import threading

import numpy as np

_SEED_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB,
             0x2545F4914F6CDD1D)


class TinyLfu:
    def __init__(self, capacity: int, sample_factor: int = 8) -> None:
        # Sketch width: next pow2 >= capacity, floor 256 — a too-narrow
        # sketch aliases cold keys onto hot counters and breaks admission.
        width = 256
        while width < capacity:
            width <<= 1
        self._mask = width - 1
        self._counters = np.zeros((4, width), np.uint8)  # values capped at 15
        self._doorkeeper: set[int] = set()
        self._sample_size = max(16, capacity * sample_factor)
        self._touches = 0
        # One instance serves several execution domains (the kv_router
        # indexer is touched from the event-apply loop and lookups; tier
        # pools touch from scheduler and prefetch threads), and a touch
        # is a multi-step read-modify-write over sketch + doorkeeper +
        # sample counter. The sketch lock is uncontended in the common
        # case and keeps a concurrent _reset_sample from tearing it.
        self._sketch_lock = threading.Lock()

    def _rows(self, h: int) -> list[int]:
        h &= (1 << 64) - 1
        idxs = []
        for mix in _SEED_MIX:
            h2 = (h * mix) & ((1 << 64) - 1)
            idxs.append((h2 >> 32) & self._mask)
        return idxs

    def touch(self, h: int) -> None:
        """Record one access."""
        with self._sketch_lock:
            self._touches += 1
            if h not in self._doorkeeper:
                self._doorkeeper.add(h)
            else:
                for row, idx in enumerate(self._rows(h)):
                    if self._counters[row, idx] < 15:
                        self._counters[row, idx] += 1
            if self._touches >= self._sample_size:
                self._reset_sample()

    def _reset_sample(self) -> None:
        # Halve counters + clear doorkeeper: ages out stale popularity.
        # Caller holds self._sketch_lock.
        self._counters >>= 1
        self._doorkeeper.clear()
        self._touches = 0

    def estimate(self, h: int) -> int:
        with self._sketch_lock:
            est = min(int(self._counters[row, idx])
                      for row, idx in enumerate(self._rows(h)))
            if h in self._doorkeeper:
                est += 1
            return est

    def admit(self, candidate: int, victim: int) -> bool:
        """Should `candidate` displace `victim`? (>= so fresh blocks with
        equal evidence still rotate in)."""
        return self.estimate(candidate) >= self.estimate(victim)
