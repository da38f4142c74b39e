"""KV-aware worker selection.

Port of `dynamo_tpu/kv_router/scheduler.py`, the same cost, sampling and
tie-break. `affinity_worker` is kept; nothing in this package passes it
yet (the session tier is not ported).

Cost model (ref: lib/kv-router/src/scheduling/selector.rs:149-155):

    logit = overlap_weight * potential_prefill_blocks + decode_blocks

where potential_prefill_blocks counts blocks the candidate would still have
to prefill (lower when it has cached prefix) and decode_blocks is its active
load. Lowest logit wins; temperature > 0 softmax-samples over normalized
negated logits (ref: selector.rs:27-60 softmax_sample); zero-temp ties break
toward the smaller radix tree (less cache pressure).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional, Sequence

from .indexer import make_radix_tree
from .protocols import OverlapScores, WorkerWithDpRank
from .sequences import ActiveSequences


@dataclasses.dataclass
class KvRouterConfig:
    overlap_weight: float = 1.0
    temperature: float = 0.0
    block_size: int = 16
    # Session-affinity logit bonus (block units): a live session's
    # resident worker wins the selection unless it is this many blocks
    # more loaded than the best alternative (DYNT_SESSION_AFFINITY_WEIGHT;
    # 0 disables steering — docs/prompt-caching.md).
    session_affinity_weight: float = 4.0


@dataclasses.dataclass
class SelectionResult:
    worker: WorkerWithDpRank
    logit: float
    overlap_blocks: int


def softmax_sample(
    logits: dict[WorkerWithDpRank, float],
    temperature: float,
    tie_breaker: Optional[dict[WorkerWithDpRank, int]] = None,
    sample: Optional[float] = None,
) -> tuple[WorkerWithDpRank, float]:
    assert logits, "empty logits"
    if temperature == 0.0:
        min_logit = min(logits.values())
        candidates = [w for w, v in logits.items() if v == min_logit]
        if len(candidates) > 1 and tie_breaker:
            smallest = min(tie_breaker.get(w, 0) for w in candidates)
            candidates = [
                w for w in candidates if tie_breaker.get(w, 0) == smallest
            ]
        return random.choice(candidates), min_logit

    workers = list(logits)
    values = [logits[w] for w in workers]
    lo, hi = min(values), max(values)
    if lo == hi:
        probs = [1.0 / len(values)] * len(values)
    else:
        scaled = [-(v / (hi - lo)) / temperature for v in values]
        peak = max(scaled)
        exps = [math.exp(v - peak) for v in scaled]
        total = sum(exps)
        probs = [e / total for e in exps]
    draw = random.random() if sample is None else sample
    acc = 0.0
    for worker, p in zip(workers, probs):
        acc += p
        if draw <= acc:
            return worker, logits[worker]
    return workers[-1], logits[workers[-1]]


class KvScheduler:
    def __init__(self, config: Optional[KvRouterConfig] = None) -> None:
        self.config = config or KvRouterConfig()
        self.indexer = make_radix_tree()
        self.sequences = ActiveSequences(self.config.block_size)

    def select_worker(
        self,
        candidates: Sequence[WorkerWithDpRank],
        block_hashes: Sequence[int],
        isl_tokens: int,
        overlaps: Optional[OverlapScores] = None,
        overlap_weight: Optional[float] = None,
        temperature: Optional[float] = None,
        affinity_worker: Optional[int] = None,
    ) -> SelectionResult:
        if not candidates:
            raise ValueError("no candidate workers")
        if overlaps is None:
            overlaps = self.indexer.find_matches(block_hashes)
        block_size = self.config.block_size
        weight = self.config.overlap_weight if overlap_weight is None else overlap_weight
        temp = self.config.temperature if temperature is None else temperature

        logits: dict[WorkerWithDpRank, float] = {}
        for worker in candidates:
            overlap = overlaps.scores.get(worker, 0)
            prefill_tokens = self.sequences.prefill_tokens(worker)
            if prefill_tokens is None:
                prefill_tokens = max(0, isl_tokens - overlap * block_size)
            else:
                prefill_tokens = prefill_tokens + max(
                    0, isl_tokens - overlap * block_size
                )
            potential_prefill_block = prefill_tokens / block_size
            decode_block = self.sequences.decode_blocks(worker)
            if decode_block is None:
                decode_block = math.floor(potential_prefill_block)
            logits[worker] = weight * potential_prefill_block + float(decode_block)
            if affinity_worker is not None \
                    and worker.worker_id == affinity_worker:
                # Cache-residency steering (session tier): the session's
                # resident worker holds the pinned prefix in its KVBM
                # tiers even when the radix index no longer scores G1
                # overlap (evicted to G2/G3) — bias toward it by the
                # configured block bonus, bounded so a hot worker still
                # loses to a sufficiently idle one.
                logits[worker] -= self.config.session_affinity_weight

        worker, logit = softmax_sample(
            logits, temp, tie_breaker=overlaps.tree_sizes
        )
        return SelectionResult(
            worker=worker,
            logit=logit,
            overlap_blocks=overlaps.scores.get(worker, 0),
        )

    # -- request lifecycle (ref: section 3.3 AddRequest/MarkPrefill/Free) --

    def add_request(
        self, request_id: str, result: SelectionResult, isl_tokens: int
    ) -> None:
        self.sequences.add_request(
            request_id, result.worker, isl_tokens, result.overlap_blocks
        )

    def mark_prefill_completed(self, request_id: str) -> None:
        self.sequences.mark_prefill_completed(request_id)

    def free(self, request_id: str) -> None:
        self.sequences.free(request_id)

    def remove_worker_id(self, worker_id: int) -> None:
        self.indexer.remove_worker_id(worker_id)
        self.sequences.remove_worker_id(worker_id)
