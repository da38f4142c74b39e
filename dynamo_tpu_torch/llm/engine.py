"""Token-level engine pipeline operators.

Port of `TokenEngine`, `RouterEngine` and `KvRouterEngine` in
`dynamo_tpu/llm/engine.py`: every hop implements `generate(request) -> async
stream` (ref: lib/runtime/src/engine.rs:201-213), speaking
PreprocessedRequest / EngineOutput. Not ported yet: migration, the prefill
router, multimodal encoding, the session tier, the LoRA instance filter and
the otel spans.
"""

from __future__ import annotations

import contextlib
from typing import AsyncIterator, Optional

from ..config import env
from ..kv_router import KvScheduler, WorkerWithDpRank
from ..kv_router.queue import QueuedRequest, SchedulerQueue
from ..runtime.push_router import NoInstancesAvailable, PushRouter
from ..tokens import compute_block_hashes
from .protocols import EngineOutput, PreprocessedRequest


class TokenEngine:
    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[EngineOutput]:
        raise NotImplementedError
        yield  # pragma: no cover


class RouterEngine(TokenEngine):
    """Dispatch to workers through a PushRouter (round_robin / random /
    p2c)."""

    def __init__(self, router: PushRouter) -> None:
        self.router = router

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[EngineOutput]:
        async with contextlib.aclosing(
                self.router.generate(request.to_wire())) as stream:
            async for item in stream:
                yield EngineOutput.from_wire(item)


def _priority_of(request: PreprocessedRequest) -> float:
    """Optional per-request priority bump for the admission queue (the
    reference's priority_jump, carried as an annotation)."""
    try:
        return float((request.annotations or {}).get("priority", 0.0))
    except (TypeError, ValueError):
        return 0.0


class KvRouterEngine(TokenEngine):
    """KV-aware dispatch: block-hash the prompt, score candidates by cached
    overlap + load, route direct, and track the request lifecycle
    (ref: lib/llm/src/kv_router.rs KvRouter + push_router.rs KvPushRouter).
    When the admission queue is enabled (DYNT_ROUTER_QUEUE_THRESHOLD >= 0),
    saturation parks requests in fcfs/lcfs/wspt order instead of routing
    immediately (ref: lib/kv-router/src/scheduling/queue.rs)."""

    def __init__(self, router: PushRouter, scheduler: KvScheduler,
                 queue: Optional[SchedulerQueue] = None) -> None:
        self.router = router
        self.scheduler = scheduler
        if queue is None:
            threshold = env("DYNT_ROUTER_QUEUE_THRESHOLD")
            budget = env("DYNT_MAX_BATCHED_TOKENS")
            queue = SchedulerQueue(
                scheduler,
                threshold_frac=threshold if threshold >= 0 else None,
                policy=env("DYNT_ROUTER_QUEUE_POLICY"),
                max_batched_tokens=(
                    (lambda w: budget) if budget > 0 else None),
            )
        self.queue = queue

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[EngineOutput]:
        await self.router.client.start()
        avail = self.router.available()
        if not avail:
            raise NoInstancesAvailable(self.router.client.endpoint.subject)
        block_hashes = compute_block_hashes(
            request.token_ids, self.scheduler.config.block_size,
            lora_id=request.kv_salt())
        request_id = request.request_id
        # schedule() books the request into the slot tracker (add_request)
        # as part of the decision, so a drained backlog can't dogpile.
        result = await self.queue.schedule(QueuedRequest(
            candidates=[WorkerWithDpRank(iid) for iid in avail],
            block_hashes=block_hashes,
            isl_tokens=len(request.token_ids),
            priority_jump=_priority_of(request),
            request_id=request_id,
            priority_class=request.priority,
        ))
        first = True
        try:
            async with contextlib.aclosing(self.router.generate(
                    request.to_wire(),
                    instance_id=result.worker.worker_id)) as stream:
                async for item in stream:
                    if first:
                        self.scheduler.mark_prefill_completed(request_id)
                        self.queue.update()
                        first = False
                    yield EngineOutput.from_wire(item)
        finally:
            self.scheduler.free(request_id)
            self.queue.update()
