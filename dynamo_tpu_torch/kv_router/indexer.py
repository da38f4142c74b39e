"""Radix-tree KV indexer: which worker has which cached prefix.

Port of `dynamo_tpu/kv_router/indexer.py`: the Python `RadixTree`,
`sweep_tree` and `make_radix_tree`, the same code. The reference's
`NativeRadixTree` is a CPU accelerator over its C++ extension
(`csrc/native.cpp`), not a TPU kernel; it is not ported, so
`make_radix_tree` here always returns the Python tree.

Re-design of the reference indexer (ref: lib/kv-router/src/indexer/
radix_tree.rs — `find_matches` :156, `apply_event` :323). Because block
hashes are *sequence* hashes (chained, see dynamo_tpu.tokens), a node's hash
uniquely identifies its whole prefix, so the tree is keyed directly by
sequence hash with a flat lookup table for O(1) event application.

Event ordering: per-(worker, dp_rank) monotonic event ids; a gap means we
missed events and the caller must resync from the worker's local indexer
(ref: router-design.md "How gap detection works", worker_query.rs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..config import env
from .tinylfu import TinyLfu
from .protocols import OverlapScores, RouterEvent, WorkerWithDpRank


@dataclasses.dataclass
class _Node:
    hash: int
    parent: Optional["_Node"]
    children: dict[int, "_Node"] = dataclasses.field(default_factory=dict)
    workers: set[WorkerWithDpRank] = dataclasses.field(default_factory=set)


class RadixTree:
    def __init__(self, ttl_secs: float = 0.0, max_tree_size: int = 0,
                 prune_target_ratio: float = 0.8,
                 admission: bool = False) -> None:
        self._root = _Node(hash=0, parent=None)
        self._nodes: dict[int, _Node] = {}
        self._worker_blocks: dict[WorkerWithDpRank, int] = {}
        self._last_event_id: dict[WorkerWithDpRank, int] = {}
        self.gap_count = 0
        # TTL/size pruning (ref: indexer/pruning.rs PruneManager): lazy
        # min-heap over an authoritative (hash, worker) -> expiry map.
        self._ttl = ttl_secs
        self._max_tree_size = max_tree_size
        self._prune_target_ratio = prune_target_ratio
        self._timers: dict[tuple[int, WorkerWithDpRank], float] = {}
        self._expirations: list[tuple[float, int, int, int]] = []  # heap
        # TinyLFU admission at the node cap (block_manager/tinylfu.py
        # lifted into the router, DYNT_INDEXER_ADMISSION): queries count
        # as accesses, and a NEW chain at a full tree is inserted only
        # if its frequency estimate beats the oldest entry's — a flood
        # of one-shot session prefixes cannot flush hot shared prefixes
        # out of the index. Requires max_tree_size.
        self._lfu = (TinyLfu(max_tree_size)
                     if admission and max_tree_size else None)
        self.admission_rejected = 0

    # -- TTL / size pruning -------------------------------------------------

    @property
    def prune_tracking(self) -> bool:
        """True when TTL/size pruning is configured (sweep loops skip the
        1 Hz maintain() calls entirely otherwise)."""
        return self._tracking

    @property
    def _tracking(self) -> bool:
        # TTL and size budgets are independent; size-only configs still
        # need the timer heap for oldest-first prune order.
        return bool(self._ttl or self._max_tree_size)

    def _timer_insert(self, worker: WorkerWithDpRank,
                      hashes: Sequence[int]) -> None:
        if not self._tracking:
            return
        import heapq
        import time as _time

        expiry = _time.monotonic() + self._ttl
        for h in hashes:
            self._timers[(h, worker)] = expiry
            heapq.heappush(self._expirations,
                           (expiry, h, worker.worker_id, worker.dp_rank))
        if (len(self._expirations) > 4 * max(len(self._timers), 256)):
            self._expirations = [
                (exp, h, w.worker_id, w.dp_rank)
                for (h, w), exp in self._timers.items()
            ]
            heapq.heapify(self._expirations)

    def maintain(self, now: float = None) -> list[tuple[int, int, int]]:
        """TTL-expire + size-prune; returns evicted (worker_id, dp, hash)
        tuples (ref: pruning.rs pop_expired + prune)."""
        if not self._tracking:
            return []
        import heapq
        import time as _time

        if now is None:
            now = _time.monotonic()
        evicted: list[tuple[int, int, int]] = []

        def _pop_valid() -> tuple[int, WorkerWithDpRank] | None:
            exp, h, wid, dp = heapq.heappop(self._expirations)
            worker = WorkerWithDpRank(wid, dp)
            if self._timers.get((h, worker)) == exp:
                del self._timers[(h, worker)]
                return h, worker
            return None

        # TTL expiry, APPLIED before the size check — pruning against the
        # pre-expiry count would evict live blocks a sweep that just freed
        # enough room.
        if self._ttl:
            while self._expirations and self._expirations[0][0] <= now:
                hit = _pop_valid()
                if hit is not None:
                    h, worker = hit
                    evicted.append((worker.worker_id, worker.dp_rank, h))
                    self._apply_removed(worker, [h])
        if self._max_tree_size and len(self._nodes) > self._max_tree_size:
            # Evict per-(worker, hash) entries but track the NODE count: a
            # hash replicated across workers only drops its node when the
            # last holder goes, so loop until the tree actually reaches
            # target (or the heap is exhausted).
            target = int(self._max_tree_size * self._prune_target_ratio)
            while len(self._nodes) > target and self._expirations:
                hit = _pop_valid()
                if hit is not None:
                    h, worker = hit
                    evicted.append((worker.worker_id, worker.dp_rank, h))
                    self._apply_removed(worker, [h])
        return evicted

    # -- queries -----------------------------------------------------------

    def find_matches(
        self, block_hashes: Sequence[int], early_exit: bool = False
    ) -> OverlapScores:
        """Per-worker count of leading request blocks already cached there.
        A worker scores i+1 only if it holds blocks 0..i contiguously."""
        scores: dict[WorkerWithDpRank, int] = {}
        node = self._root
        for depth, block_hash in enumerate(block_hashes):
            if self._lfu is not None:
                # Query traffic is the admission filter's frequency
                # evidence: every looked-up block counts as an access,
                # hit or miss (a missed-but-requested prefix earns its
                # slot next time a worker stores it).
                self._lfu.touch(block_hash)
            node = node.children.get(block_hash)
            if node is None:
                break
            for worker in node.workers:
                if scores.get(worker, 0) == depth:
                    scores[worker] = depth + 1
            if early_exit and not node.workers:
                break
        return OverlapScores(
            scores=scores,
            tree_sizes={w: self._worker_blocks.get(w, 0) for w in self._worker_blocks},
        )

    def worker_block_counts(self) -> dict[WorkerWithDpRank, int]:
        return dict(self._worker_blocks)

    def total_nodes(self) -> int:
        return len(self._nodes)

    # -- event application -------------------------------------------------

    def apply_event(self, event: RouterEvent) -> str:
        """Returns 'ok' or 'gap' (event applied either way; on 'gap' the
        caller should schedule a resync with the worker)."""
        worker = WorkerWithDpRank(event.worker_id, event.dp_rank)
        status = "ok"
        last = self._last_event_id.get(worker)
        if last is not None and event.event_id <= last:
            # Duplicate / already-reflected delivery (at-least-once event
            # plane, or an event that raced a resync dump): skip — applying
            # it could resurrect removed blocks.
            return "stale"
        if last is not None and event.event_id != last + 1:
            self.gap_count += 1
            status = "gap"
        self._last_event_id[worker] = event.event_id

        if event.cleared:
            self.remove_worker(worker)
            self._last_event_id[worker] = event.event_id
            return status
        if event.stored is not None:
            self._apply_stored(worker, event.stored.parent_hash,
                               event.stored.block_hashes)
        if event.removed is not None:
            self._apply_removed(worker, event.removed.block_hashes)
        return status

    def _peek_oldest(self) -> Optional[int]:
        """Hash of the oldest live (hash, worker) timer entry — the
        admission victim candidate. Pops stale heap entries in passing;
        the valid head stays."""
        import heapq

        while self._expirations:
            exp, h, wid, dp = self._expirations[0]
            if self._timers.get((h, WorkerWithDpRank(wid, dp))) == exp:
                return h
            heapq.heappop(self._expirations)
        return None

    def _admit(self, block_hash: int) -> bool:
        """Frequency-gated insertion at the node cap. EVERY evicted
        victim must individually lose to the candidate — freeing a slot
        can require evicting several oldest (hash, worker) entries
        (interior nodes only prune once their leaf cascades), and
        checking only the first would let one cold insertion wipe a
        whole hot chain. Returns False when the candidate loses or no
        slot could be freed (caller stops the chain — deeper blocks are
        colder than the rejected one)."""
        if self._lfu is None or len(self._nodes) < self._max_tree_size:
            return True
        self._lfu.touch(block_hash)
        import heapq

        while len(self._nodes) >= self._max_tree_size:
            victim = self._peek_oldest()
            if victim is None:
                return False  # nothing evictable: refuse, hold the cap
            if not self._lfu.admit(block_hash, victim):
                self.admission_rejected += 1
                return False
            exp, h, wid, dp = heapq.heappop(self._expirations)
            w = WorkerWithDpRank(wid, dp)
            if self._timers.get((h, w)) == exp:
                del self._timers[(h, w)]
                self._apply_removed(w, [h])
        return True

    def _apply_stored(
        self, worker: WorkerWithDpRank, parent_hash: Optional[int],
        block_hashes: Sequence[int],
    ) -> None:
        if parent_hash is None:
            parent = self._root
        else:
            parent = self._nodes.get(parent_hash)
            if parent is None:
                # Parent unknown (we joined mid-stream): root the chain at its
                # own first block — sequence hashes keep lookups correct.
                parent = self._root
        stored: list[int] = []
        for block_hash in block_hashes:
            node = self._nodes.get(block_hash)
            if node is None:
                if not self._admit(block_hash):
                    # Chain truncated at the first rejected block: a
                    # child inserted under a missing parent could never
                    # be matched (find_matches walks contiguously).
                    break
                if parent is not self._root \
                        and self._nodes.get(parent.hash) is not parent:
                    # _admit's eviction cascade pruned our own parent:
                    # inserting under the dead node would orphan the
                    # chain (in _nodes, unreachable from the root,
                    # unmatchable forever). Truncate instead.
                    break
                node = _Node(hash=block_hash, parent=parent)
                self._nodes[block_hash] = node
                parent.children[block_hash] = node
            if worker not in node.workers:
                node.workers.add(worker)
                self._worker_blocks[worker] = self._worker_blocks.get(worker, 0) + 1
            parent = node
            stored.append(block_hash)
        self._timer_insert(worker, stored)

    def _apply_removed(
        self, worker: WorkerWithDpRank, block_hashes: Sequence[int]
    ) -> None:
        for block_hash in block_hashes:
            node = self._nodes.get(block_hash)
            if node is None:
                continue
            if worker in node.workers:
                node.workers.discard(worker)
                self._worker_blocks[worker] = max(
                    0, self._worker_blocks.get(worker, 1) - 1
                )
            self._timers.pop((block_hash, worker), None)
            self._maybe_prune(node)

    def _maybe_prune(self, node: _Node) -> None:
        while node is not self._root and not node.workers and not node.children:
            parent = node.parent
            if parent is None:
                break
            parent.children.pop(node.hash, None)
            self._nodes.pop(node.hash, None)
            node = parent

    def remove_worker(self, worker: WorkerWithDpRank) -> None:
        """Drop every block attributed to `worker` (worker left / cleared).
        (ref: radix_tree.rs remove_worker on instance delete)"""
        to_prune: list[_Node] = []
        for node in self._nodes.values():
            if worker in node.workers:
                node.workers.discard(worker)
                to_prune.append(node)
        # Prune leaf-up: sort deepest-ish by pruning repeatedly.
        for node in to_prune:
            self._maybe_prune(node)
        self._worker_blocks.pop(worker, None)
        self._last_event_id.pop(worker, None)
        if self._tracking:
            for key in [k for k in self._timers if k[1] == worker]:
                del self._timers[key]

    def remove_worker_id(self, worker_id: int) -> None:
        for worker in [w for w in set(self._worker_blocks) | set(self._last_event_id)
                       if w.worker_id == worker_id]:
            self.remove_worker(worker)

    # -- snapshot / resync -------------------------------------------------

    def dump_worker(self, worker: WorkerWithDpRank) -> list[tuple[Optional[int], int]]:
        """(parent_hash, block_hash) pairs for every block the worker holds —
        the payload a worker's local indexer returns on resync."""
        out = []
        for node in self._nodes.values():
            if worker in node.workers:
                parent = node.parent
                parent_hash = None if parent is self._root or parent is None else parent.hash
                out.append((parent_hash, node.hash))
        return out

    def load_worker(
        self, worker: WorkerWithDpRank, pairs: Sequence[tuple[Optional[int], int]],
        last_event_id: Optional[int] = None,
    ) -> None:
        """Replace a worker's state from a resync dump."""
        self.remove_worker(worker)
        # Insert parents before children: iterate until fixpoint.
        pending = list(pairs)
        while pending:
            progressed = False
            rest = []
            for parent_hash, block_hash in pending:
                if parent_hash is None or parent_hash in self._nodes:
                    self._apply_stored(worker, parent_hash, [block_hash])
                    progressed = True
                else:
                    rest.append((parent_hash, block_hash))
            if not progressed:
                # Orphans (parent evicted between dump and load): root them.
                for parent_hash, block_hash in rest:
                    self._apply_stored(worker, None, [block_hash])
                break
            pending = rest
        if last_event_id is not None:
            self._last_event_id[worker] = last_event_id


def sweep_tree(tree, name: str, log) -> None:
    """One TTL/size maintenance sweep that logs and swallows a failure (the
    frontend manager's periodic loop calls it)."""
    maintain = getattr(tree, "maintain", None)
    if maintain is None or not getattr(tree, "prune_tracking", True):
        return
    try:
        evicted = maintain()
        if evicted:
            log.info("pruned %d expired/over-budget indexed blocks (%s)",
                     len(evicted), name)
    except Exception:  # noqa: BLE001 — the sweep loop must survive
        log.exception("indexer maintain failed (%s)", name)


def make_radix_tree(ttl_secs: float = None, max_tree_size: int = None,
                    admission: bool = None) -> RadixTree:
    """The Python tree, always (the reference's native core is not ported).
    TTL/size pruning defaults come from DYNT_INDEXER_TTL_SECS /
    DYNT_INDEXER_MAX_TREE_SIZE (0 = disabled, matching the reference's
    opt-in PruneConfig). DYNT_INDEXER_ADMISSION adds TinyLFU
    frequency-gated insertion at the node cap."""
    if ttl_secs is None:
        ttl_secs = env("DYNT_INDEXER_TTL_SECS")
    if max_tree_size is None:
        max_tree_size = env("DYNT_INDEXER_MAX_TREE_SIZE")
    if admission is None:
        admission = env("DYNT_INDEXER_ADMISSION")
    return RadixTree(ttl_secs=ttl_secs, max_tree_size=max_tree_size,
                     admission=bool(admission and max_tree_size))
