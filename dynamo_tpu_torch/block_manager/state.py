"""KV block lifecycle state machine.

Verbatim copy of `dynamo_tpu/block_manager/state.py` (framework-free), kept
here so the PyTorch port never imports the JAX package:

    Reset --init_sequence--> Partial --commit--> Complete --register-->
    Registered --drop/evict--> Reset

Reset blocks live in a tier's free list; Partial blocks are being filled by
a transfer; Complete blocks hold a full page of KV but are not yet visible
for dedup or lookup; Registered blocks are in the tier's dedup registry
keyed by sequence hash. Invalid transitions raise `BlockStateError`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class BlockState(enum.Enum):
    RESET = "reset"
    PARTIAL = "partial"
    COMPLETE = "complete"
    REGISTERED = "registered"


class BlockStateError(RuntimeError):
    pass


_TRANSITIONS = {
    (BlockState.RESET, BlockState.PARTIAL),
    (BlockState.PARTIAL, BlockState.COMPLETE),
    (BlockState.COMPLETE, BlockState.REGISTERED),
    (BlockState.REGISTERED, BlockState.RESET),  # drop / eviction
    (BlockState.PARTIAL, BlockState.RESET),  # aborted transfer
    (BlockState.COMPLETE, BlockState.RESET),  # invalidated
}


@dataclasses.dataclass
class BlockHandle:
    """A physical slot in one tier's arena plus its lifecycle state.

    `idx` is the arena slot; `sequence_hash` is set at commit and is the
    dedup/lookup key once registered; `parent_hash` chains blocks into
    prefix sequences (same chained-hash identity the router indexes).
    """

    idx: int
    state: BlockState = BlockState.RESET
    sequence_hash: Optional[int] = None
    parent_hash: Optional[int] = None

    def _to(self, new: BlockState) -> None:
        if (self.state, new) not in _TRANSITIONS:
            raise BlockStateError(
                f"invalid block transition {self.state.value} -> {new.value}"
            )
        self.state = new

    def init_sequence(self) -> None:
        self._to(BlockState.PARTIAL)

    def commit(self, sequence_hash: int, parent_hash: Optional[int]) -> None:
        self._to(BlockState.COMPLETE)
        self.sequence_hash = sequence_hash
        self.parent_hash = parent_hash

    def register(self) -> None:
        if self.sequence_hash is None:
            raise BlockStateError("register() before commit()")
        self._to(BlockState.REGISTERED)

    def reset(self) -> None:
        self._to(BlockState.RESET)
        self.sequence_hash = None
        self.parent_hash = None
