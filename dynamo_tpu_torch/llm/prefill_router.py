"""PrefillRouterEngine: disaggregated prefill/decode serving.

Port of `dynamo_tpu/llm/prefill_router.py` (ref:
lib/llm/src/kv_router/prefill_router/mod.rs:43):

  * while a model has no live prefill worker, requests pass straight
    through to the decode engine (the aggregated fallback);
  * otherwise the request is cloned with max_tokens 1 and the `prefill_only`
    annotation and sent to a prefill worker; the `kv_transfer_params` it
    answers ride the decode request as `disaggregated_params`, and the
    decode worker pulls the pages before admitting it
    (`llm/kv_transfer.py`).

With a streamed handoff the prefill worker answers after its FIRST chunk;
the decode leg is dispatched at once, and the rest of the prefill leg is
consumed in the background (closing it would cancel the prefill mid-prompt).

The ModelWatcher keeps a `PrefillPool` per model as prefill cards come and
go; this engine looks the pool up on every request. The reference's otel
spans around the prefill leg are not ported.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging
from typing import AsyncIterator, Callable, Optional

from ..runtime.admission import (
    QueueWaitEstimator,
    check_admission,
    check_tenant_admission,
    get_tenant_ledger,
)
from ..runtime.push_router import PushRouter
from ..runtime.resilience import DeadlineExceeded
from .engine import TokenEngine
from .protocols import EngineOutput, PreprocessedRequest

log = logging.getLogger("dynamo_tpu_torch.prefill_router")


def _prefill_estimator() -> QueueWaitEstimator:
    return QueueWaitEstimator(pool="prefill")


@dataclasses.dataclass
class PrefillPool:
    """A model's prefill workers (one endpoint subject, its live
    instances)."""

    router: PushRouter
    instances: set[int] = dataclasses.field(default_factory=set)
    # Deadline-aware admission for the prefill tier: depth from the pool
    # workers' waiting_requests (fed by the ModelWatcher), drain rate from
    # the prefill legs completed here; kept apart from the decode pool's.
    wait_estimator: QueueWaitEstimator = dataclasses.field(
        default_factory=_prefill_estimator)

    def active(self) -> bool:
        return bool(self.instances)


class PrefillRouterEngine(TokenEngine):
    def __init__(self, inner: TokenEngine,
                 pool_lookup: Callable[[], Optional[PrefillPool]]) -> None:
        self.inner = inner
        self.pool_lookup = pool_lookup
        # background drains of streaming prefill legs still running
        self._drains: set = set()

    def _drain_prefill_leg(self, stream, request_id: str) -> None:
        """Consume the rest of a streaming prefill leg in the background.
        An error here needs no handling: the decode side's pull fails and
        it recomputes, the fallback of every failed transfer."""

        async def drain() -> None:
            try:
                async for item in stream:
                    out = EngineOutput.from_wire(item)
                    if out.error:
                        log.warning("streaming prefill leg error for %s: %s",
                                    request_id, out.error)
                        return
                    if out.finish_reason is not None:
                        return
            except Exception as exc:  # noqa: BLE001 — the decode side
                # recomputes through its failed pull
                log.warning("streaming prefill leg failed for %s (%r)",
                            request_id, exc)
            finally:
                await stream.aclose()

        task = asyncio.create_task(drain())
        self._drains.add(task)
        task.add_done_callback(self._drains.discard)

    async def _run_prefill(self, pool: PrefillPool,
                           request: PreprocessedRequest) -> Optional[dict]:
        """Send the prompt to a prefill worker; returns its
        kv_transfer_params, or None (the caller serves aggregated)."""
        prefill_request = dataclasses.replace(
            request,
            sampling=dataclasses.replace(request.sampling, max_tokens=1),
            annotations={**request.annotations, "prefill_only": True})
        # The gateway's pin of the prefill leg (x-prefill-instance-id).
        target = None
        raw = request.annotations.get("prefill_instance")
        if raw:
            try:
                target = int(str(raw), 16)
            except ValueError:
                log.warning("bad prefill_instance annotation %r", raw)
        # The leg draws on the request's remaining budget.
        stream = pool.router.generate(prefill_request.to_wire(),
                                      instance_id=target,
                                      deadline=request.deadline)
        handed_off = False
        try:
            async for item in stream:
                out = EngineOutput.from_wire(item)
                if out.error:
                    log.warning("prefill worker error for %s: %s",
                                request.request_id, out.error)
                    return None
                if out.kv_transfer_params is None:
                    continue
                # A completed leg is one unit drained from the prefill
                # queue: the pool estimator's drain-rate signal.
                pool.wait_estimator.observe_drained(1)
                params = out.kv_transfer_params
                if params.get("streaming") and "first_token" not in params:
                    # Streamed handoff: the params came after the first
                    # chunk. Dispatch the decode leg now and keep consuming
                    # the prefill leg in the background.
                    handed_off = True
                    self._drain_prefill_leg(stream, request.request_id)
                return params
        except DeadlineExceeded:
            # no budget left: the decode leg could not finish either
            raise
        except Exception as exc:  # noqa: BLE001 — any prefill-leg failure
            # (NoInstancesAvailable included) degrades to aggregated serving
            log.warning("prefill leg failed for %s (%r); aggregated "
                        "fallback", request.request_id, exc)
            return None
        finally:
            if not handed_off:
                await stream.aclose()
        return None

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[EngineOutput]:
        pool = self.pool_lookup()
        if ((request.disaggregated_params or {}).get("handoff") is not None
                or request.annotations.get("embed")):
            # A drain handoff's replay already carries its pull route and
            # resume state (a prefill leg would recompute the KV it
            # preserves); an embedding has no KV to hand off.
            pool = None
        if pool is None or not pool.active():
            async with contextlib.aclosing(
                    self.inner.generate(request)) as stream:
                async for out in stream:
                    yield out
            return
        # Admission for the prefill tier, before the leg is dispatched: an
        # over-share tenant is refused first when the pool is backlogged,
        # then a deadline that cannot survive the prefill queue. tokens=0:
        # the entry edge already counted this request's cost.
        check_tenant_admission(
            get_tenant_ledger(), request.tenant, 0,
            contended=pool.wait_estimator.depth() > 0)
        check_admission(pool.wait_estimator, request.deadline,
                        tenant=request.tenant)
        params = await self._run_prefill(pool, request)
        if params is not None:
            request = dataclasses.replace(request,
                                          disaggregated_params=params)
        async with contextlib.aclosing(self.inner.generate(request)) as stream:
            async for out in stream:
                yield out
