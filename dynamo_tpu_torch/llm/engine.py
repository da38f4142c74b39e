"""Token-level engine pipeline operators.

Port of `TokenEngine` and `RouterEngine` in `dynamo_tpu/llm/engine.py`:
every hop implements `generate(request) -> async stream` (ref:
lib/runtime/src/engine.rs:201-213), speaking PreprocessedRequest /
EngineOutput. Not ported yet: the KV router engine, migration, the prefill
router, multimodal encoding and session pins.
"""

from __future__ import annotations

import contextlib
from typing import AsyncIterator

from ..runtime.push_router import PushRouter
from .protocols import EngineOutput, PreprocessedRequest


class TokenEngine:
    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[EngineOutput]:
        raise NotImplementedError
        yield  # pragma: no cover


class RouterEngine(TokenEngine):
    """Dispatch to workers through a PushRouter (round_robin / random)."""

    def __init__(self, router: PushRouter) -> None:
        self.router = router

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[EngineOutput]:
        async with contextlib.aclosing(
                self.router.generate(request.to_wire())) as stream:
            async for item in stream:
                yield EngineOutput.from_wire(item)
