"""Draftless speculative-decoding proposers (prompt-lookup / n-gram).

Port of `dynamo_tpu/engine/spec.py`, on this package's
`tokens.TokenBlockSequence`. Decode emits one token per step because each
step's input is the previous step's output. Speculation breaks the chain
without a draft model (Leviathan et al., 2023 for the verification math;
Saxena, 2023, "prompt lookup decoding", for the draftless proposer): guess
k likely continuation tokens from the request's OWN token history, score
all k+1 positions in ONE forward pass (the weights stream once instead of
k+1 times), and commit the longest prefix that matches what the sampler
would have chosen step by step anyway (`sampler.spec_verify`).

Two proposal sources, both host-side:

* `NGramProposer`: per-sequence suffix lookup. The longest n-gram ending
  the history that occurred earlier continues the way it did last time.
  Incremental index (n-gram -> latest continuation position), O(NGRAM_MAX)
  per appended token.
* `BlockLookahead`: cross-request. Finished sequences register their
  chained block hashes (the identity `tokens.compute_block_hashes` gives
  the prefix cache) against the tokens that followed each block, so a
  request whose history matches an earlier block chain proposes the
  continuation another request generated. Bounded LRU; hash chaining makes
  a hit proof of full prefix identity.

The scheduler (engine/scheduler.py) owns the policy: per-slot acceptance
EMA with probing, the batch-pressure cutoff and the DYNT_SPEC_* knobs
(config.py).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

from ..tokens import TokenBlockSequence

# Suffix n-gram lengths tried by the proposer, longest first. A longer
# match is stronger evidence for the continuation; 1-grams still help on
# highly repetitive output (code, JSON keys, tables).
NGRAM_MAX = 3
NGRAM_MIN = 1

# Per-slot acceptance EMA smoothing and the probe cadence for slots the EMA
# has disabled (without probes a slot could never re-qualify after its text
# turns repetitive again).
EMA_ALPHA = 0.3
PROBE_EVERY = 16


class NGramProposer:
    """Prompt lookup over one sequence's token history.

    The index maps each (n, last-n-tokens) suffix to the position where its
    most recent *continuation* starts. The current suffix itself is never
    indexed (its continuation does not exist yet), so a lookup hit is always
    a genuinely earlier occurrence.
    """

    def __init__(self, tokens: Sequence[int]) -> None:
        self._tokens: list[int] = []
        self._index: dict[tuple, int] = {}
        self.extend(tokens)

    def __len__(self) -> int:
        return len(self._tokens)

    @property
    def tokens(self) -> list[int]:
        return self._tokens

    def extend(self, tokens: Sequence[int]) -> None:
        for tok in tokens:
            t = self._tokens
            p = len(t)
            # Appending position p gives every n-gram ENDING at p-1 a
            # continuation starting at p.
            for n in range(NGRAM_MIN, NGRAM_MAX + 1):
                if p < n:
                    break
                self._index[(n, tuple(t[p - n:]))] = p
            t.append(int(tok))

    def propose(self, k: int) -> list[int]:
        """Up to k continuation tokens, or [] when no suffix recurs.

        Lookups CHAIN through the proposal: when the matched continuation
        runs off the end of the history (the common case for looping text,
        whose freshest match is near the end), the suffix including the
        tokens proposed so far is looked up again, so a repeating pattern
        yields full-k drafts instead of one token per step."""
        if k <= 0:
            return []
        t = self._tokens
        out: list[int] = []
        while len(out) < k:
            start = None
            total = len(t) + len(out)
            for n in range(NGRAM_MAX, NGRAM_MIN - 1, -1):
                if total < n:
                    continue
                if len(out) >= n:
                    sfx = out[-n:]
                else:
                    sfx = t[len(t) - (n - len(out)):] + out
                start = self._index.get((n, tuple(sfx)))
                if start is not None:
                    break
            if start is None or start >= len(t):
                break
            grab = t[start:start + (k - len(out))]
            if not grab:
                break
            out.extend(grab)
        return out


class BlockLookahead:
    """Cross-request continuation store keyed by chained block hashes.

    `record()` takes a finished sequence's full-block hash chain (the
    prefix-cache identity) plus its tokens and remembers, per block hash,
    the tokens that followed that block. `propose()` walks a live sequence's
    chain: the last FULL block's hash identifies the entire prefix, so a
    hit predicts the continuation another request actually produced.
    """

    def __init__(self, block_size: int, capacity: int = 8192) -> None:
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self.capacity = capacity
        self._next: OrderedDict[int, list[int]] = OrderedDict()

    def __len__(self) -> int:
        return len(self._next)

    def record(self, hashes: Sequence[int], tokens: Sequence[int]) -> None:
        ps = self.block_size
        for i, h in enumerate(hashes):
            # Two blocks of continuation: a live sequence looks up from
            # anywhere inside its partial tail block (offset 0..ps-1), so
            # one block would leave < k tokens near the boundary.
            cont = [int(x) for x in tokens[(i + 1) * ps:(i + 3) * ps]]
            if not cont:
                break
            self._next[int(h)] = cont
            self._next.move_to_end(int(h))
        while len(self._next) > self.capacity:
            self._next.popitem(last=False)

    def propose(self, hashes: Sequence[int], history_len: int,
                k: int) -> list[int]:
        """Continuation for a history whose full blocks hash to `hashes` and
        whose total length is `history_len` (>= len(hashes) * block tokens;
        the remainder is the partial tail block)."""
        if k <= 0 or not hashes:
            return []
        cont = self._next.get(int(hashes[-1]))
        if cont is None:
            return []
        self._next.move_to_end(int(hashes[-1]))
        offset = history_len - len(hashes) * self.block_size
        if offset < 0 or offset >= len(cont):
            return []
        return cont[offset:offset + k]


@dataclasses.dataclass
class SlotSpec:
    """Per-sequence speculation state owned by the scheduler."""

    proposer: NGramProposer
    stop_ids: frozenset[int]
    # Incremental chained block hasher over prompt + generated (the
    # identity the prefix cache keys on): the BlockLookahead key chain.
    hasher: TokenBlockSequence
    ema: float = 1.0  # optimistic start: every slot gets to try
    proposed: int = 0
    accepted: int = 0
    probe: int = 0
    # Length of the draft actually mined for the in-flight step (the rest
    # of the k-wide draft row is padding).
    pending: int = 0

    def extend(self, tokens: Sequence[int]) -> None:
        """Commit tokens: advance the n-gram index and the hash chain."""
        self.proposer.extend(tokens)
        self.hasher.extend(tokens)

    def observe(self, proposed: int, accepted: int) -> None:
        self.proposed += proposed
        self.accepted += accepted
        if proposed > 0:
            self.ema = ((1.0 - EMA_ALPHA) * self.ema
                        + EMA_ALPHA * (accepted / proposed))

    def wants_probe(self) -> bool:
        """EMA-disabled slots still probe occasionally: acceptance is a
        property of the text being generated, which changes."""
        self.probe += 1
        return self.probe % PROBE_EVERY == 0


def propose_for(slot: SlotSpec, lookahead: Optional[BlockLookahead],
                k: int, remaining: int) -> list[int]:
    """Mine up to k draft tokens for one slot.

    Caps at `remaining - 1` tokens (the verify step always emits one extra
    target token, so longer drafts are wasted), truncates at the first
    stop/EOS token (nothing can follow it), and falls back from the local
    n-gram index to the cross-request block lookahead.
    """
    k = min(k, remaining - 1)
    if k <= 0:
        return []
    draft = slot.proposer.propose(k)
    if not draft and lookahead is not None:
        draft = lookahead.propose(slot.hasher.block_hashes,
                                  len(slot.proposer), k)
    out: list[int] = []
    for tok in draft:
        out.append(int(tok))
        if tok in slot.stop_ids:
            break
    return out
