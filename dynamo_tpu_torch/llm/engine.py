"""Token-level engine pipeline operators.

Port of `TokenEngine`, `RouterEngine`, `KvRouterEngine`,
`CooperativeMigration` and `Migration` in `dynamo_tpu/llm/engine.py`: every
hop implements `generate(request) -> async stream` (ref: lib/runtime/src/
engine.rs:201-213), speaking PreprocessedRequest / EngineOutput. The
frontend's pipeline is

    Preprocessor -> Migration -> PrefillRouterEngine
        -> [KvRouterEngine | RouterEngine] -> worker

(`PrefillRouterEngine`, the disaggregated prefill leg, is in
`llm/prefill_router.py`), and the request's end-to-end deadline travels
down it to the request plane. Each replay and handoff goes on the request's
flight-recorder timeline as a `migration` event. Not ported yet: multimodal encoding, the
session tier, the LoRA instance filter, the gateway's instance pin and the
otel spans.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging
from typing import AsyncIterator, Optional

from ..config import env
from ..kv_router import KvScheduler, WorkerWithDpRank
from ..kv_router.queue import QueuedRequest, SchedulerQueue
from ..runtime.flight_recorder import get_recorder
from ..runtime.metrics import DEADLINE_EXCEEDED
from ..runtime.push_router import NoInstancesAvailable, PushRouter
from ..runtime.request_plane import ConnectionLost
from ..runtime.resilience import RetryPolicy
from ..tokens import compute_block_hashes
from .protocols import EngineOutput, PreprocessedRequest

log = logging.getLogger("dynamo_tpu_torch.llm.engine")


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
        async with contextlib.aclosing(self.router.generate(
                request.to_wire(), deadline=request.deadline)) as stream:
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
            deadline=request.deadline,
            priority_class=request.priority,
            tenant=request.tenant,
        ))
        first = True
        try:
            async with contextlib.aclosing(self.router.generate(
                    request.to_wire(), instance_id=result.worker.worker_id,
                    deadline=request.deadline)) as stream:
                async for item in stream:
                    if first:
                        self.scheduler.mark_prefill_completed(request_id)
                        self.queue.update()
                        first = False
                    yield EngineOutput.from_wire(item)
        finally:
            self.scheduler.free(request_id)
            self.queue.update()


class CooperativeMigration(ConnectionLost):
    """In-band `finish_reason="migrate"` from a worker: a planned hand-off
    (QoS preemption, graceful drain), not a failure. Bounded apart from
    failure migrations (DYNT_PREEMPT_MIGRATION_LIMIT against
    migration_limit) and replayed without backoff.

    A drain handoff frame also carries `kv_transfer_params` with the pull
    route and resume state: the replay dispatches with them as
    `disaggregated_params`, so the destination pulls the computed KV
    instead of re-prefilling. Clean handoff hops do not consume the
    cooperative bound; a failed hop comes back as a plain migrate, which
    does."""

    def __init__(self, reason: str,
                 kv_transfer_params: Optional[dict] = None) -> None:
        super().__init__(reason)
        self.kv_transfer_params = kv_transfer_params


class Migration(TokenEngine):
    """Retry a broken stream on another worker, keeping the tokens already
    generated (ref: lib/llm/src/migration.rs:36): the replay's prompt is
    the original prompt plus those tokens (`prior_output_tokens` set), its
    `max_tokens` what is left, and usage reports the original prompt
    length. Bounded by `migration_limit` and by the request's end-to-end
    deadline, which is checked before each replay and bounds the jittered
    backoff between replays. Worker-initiated cooperative migrations carry
    their own bound (`cooperative_limit`) and skip the backoff."""

    def __init__(self, inner: TokenEngine, migration_limit: int = 3,
                 retry_policy: Optional[RetryPolicy] = None,
                 cooperative_limit: Optional[int] = None) -> None:
        self.inner = inner
        self.migration_limit = migration_limit
        self.cooperative_limit = (env("DYNT_PREEMPT_MIGRATION_LIMIT")
                                  if cooperative_limit is None
                                  else cooperative_limit)
        self.policy = retry_policy or RetryPolicy.from_env()

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[EngineOutput]:
        generated: list[int] = []
        attempts = 0
        coop_attempts = 0
        handoff_hops = 0
        prev_delay: Optional[float] = None
        current = request
        while True:
            try:
                async with contextlib.aclosing(
                        self.inner.generate(current)) as stream:
                    async for output in stream:
                        if output.finish_reason == "migrate":
                            # In-band request to move: replayed like a
                            # broken stream, on the cooperative bound; never
                            # reaches the client.
                            raise CooperativeMigration(
                                output.error or "worker requested migration",
                                kv_transfer_params=output.kv_transfer_params)
                        if (current.prior_output_tokens
                                and output.prompt_tokens is not None):
                            # The replayed prompt embeds tokens already
                            # billed as completion: report the original
                            # prompt length.
                            output.prompt_tokens = max(
                                0, output.prompt_tokens
                                - len(current.prior_output_tokens))
                        generated.extend(output.token_ids)
                        yield output
                return
            except (ConnectionLost, NoInstancesAvailable,
                    asyncio.TimeoutError) as exc:
                cooperative = isinstance(exc, CooperativeMigration)
                handoff = (exc.kv_transfer_params
                           if cooperative
                           and exc.kv_transfer_params is not None
                           and exc.kv_transfer_params.get("handoff")
                           is not None else None)
                if handoff is not None:
                    # A clean drain handoff is driven by a real departure
                    # and does not consume the cooperative bound; the cap
                    # only guards a livelock.
                    handoff_hops += 1
                    if handoff_hops > 64:
                        log.warning("handoff hop cap reached for %s: %r",
                                    request.request_id, exc)
                        yield EngineOutput(
                            finish_reason="error",
                            error=f"migration limit exceeded: {exc}")
                        return
                elif cooperative:
                    coop_attempts += 1
                else:
                    attempts += 1
                if handoff is None and (
                        coop_attempts > self.cooperative_limit
                        if cooperative else
                        attempts > self.migration_limit):
                    log.warning("%smigration limit reached for %s: %r",
                                "cooperative " if cooperative else "",
                                request.request_id, exc)
                    yield EngineOutput(
                        finish_reason="error",
                        error=f"migration limit exceeded: {exc}")
                    return
                if (request.deadline is not None
                        and request.deadline.expired()):
                    # No budget left to replay into.
                    DEADLINE_EXCEEDED.labels(component="migration").inc()
                    log.warning("deadline exceeded migrating %s: %r",
                                request.request_id, exc)
                    yield EngineOutput(
                        finish_reason="error",
                        error=f"deadline exceeded during migration: {exc}")
                    return
                if handoff is not None:
                    # Re-dispatch the same request with the pull route as
                    # disaggregated_params: the destination pulls the
                    # source's pages and resumes, nothing re-prefilled.
                    get_recorder().event(
                        request.request_id, "migration", attempt=handoff_hops,
                        cooperative=True, handoff=True,
                        tokens_preserved=len(generated))
                    log.info("drain handoff for %s (hop %d, %d tokens "
                             "preserved, no re-prefill)", request.request_id,
                             handoff_hops, len(generated))
                    current = dataclasses.replace(
                        current, disaggregated_params=exc.kv_transfer_params)
                    await asyncio.sleep(0)  # a planned move: no backoff
                    continue
                remaining = request.sampling.max_tokens - len(generated)
                if remaining <= 0:
                    yield EngineOutput(finish_reason="length")
                    return
                log.info("migrating %s (%sattempt %d, %d tokens preserved)",
                         request.request_id,
                         "cooperative " if cooperative else "",
                         coop_attempts if cooperative else attempts,
                         len(generated))
                # the replay marker on the timeline: the worker leg is
                # replaced, its tokens preserved
                get_recorder().event(request.request_id, "migration",
                                     attempt=(coop_attempts if cooperative
                                              else attempts),
                                     cooperative=cooperative,
                                     tokens_preserved=len(generated),
                                     cause=str(exc))
                sampling = type(request.sampling)(**{
                    **request.sampling.to_wire(), "max_tokens": remaining})
                # replace keeps every other field (guided processors,
                # deadline, priority, tenant); a stale handoff pull route
                # does not survive onto the replay.
                current = dataclasses.replace(
                    request,
                    token_ids=list(request.token_ids) + generated,
                    sampling=sampling,
                    prior_output_tokens=list(generated),
                    disaggregated_params=None)
                if cooperative:
                    # Nothing is failing: replay at once (yield once so the
                    # loop stays fair).
                    await asyncio.sleep(0)
                    continue
                delay = self.policy.next_delay(prev_delay)
                prev_delay = delay
                if request.deadline is not None:
                    delay = request.deadline.bound(delay)
                await asyncio.sleep(delay)
