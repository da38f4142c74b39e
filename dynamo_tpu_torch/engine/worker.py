"""TorchWorker: the engine a worker serves from, and the worker entry point.

Port of `TpuWorker` in `dynamo_tpu/engine/worker.py`. `generate` keeps the
reference's contract: a `PreprocessedRequest` wire dict in, a stream of
`EngineOutput` wire dicts out, the last one carrying `finish_reason`.
`serve()` registers the `generate`, `clear_kv_blocks`, `kv_blocks`,
`kv_pull` and `drain` endpoints on a DistributedRuntime's request plane
(and the drain on its status server's POST /drain), publishes the worker's
ModelDeploymentCard into discovery, as `TpuWorker.serve` does, so the
frontends of both packages route to it, and publishes the worker's KV events
(stored / removed / cleared, every 50 ms) and load metrics (every 0.5 s) on
the event plane, so either package's kv-mode router scores it. `main` is
`python -m dynamo_tpu_torch.worker`.

`TorchWorker(model_path=dir)` serves an HF checkpoint directory, as
`TpuWorker(model_path=...)` does: the architecture from its config.json,
the weights from its safetensors shards (`models/checkpoint.py`, loaded on
the device leaf by leaf; a load error is fatal, never random weights), and
the card advertises an `hf` tokenizer when the directory holds a
`tokenizer.json`.

`generate` is served with the reference's canary payload (a one-token
greedy request annotated `canary`), and `main` starts a HealthCheckManager
(DYNT_CANARY_WAIT_SECS) that probes it when idle and deregisters a worker
whose canaries keep failing. A deadline watchdog's cancel closes the
`generate` stream, which cancels the sequence: its pages return to the pool
within one scheduler iteration. A replayed request (`prior_output_tokens`
set by the frontend's Migration) is served as the reference serves it: as
a longer prompt.

Disaggregated serving (`mode`): a `prefill` worker publishes a `[PREFILL]`
card (under the `prefill` component from the CLI) and serves every request
prefill-only: it parks the prompt's pages in its `PendingTransferTable`
(`llm/kv_transfer.py`) and answers with `kv_transfer_params`, after the
first chunk when DYNT_DISAGG_PIPELINE streams the handoff (pages parked
chunk by chunk, the first token in the pull stream's last frame), else
after the whole prompt. A request carrying `disaggregated_params` pulls the
pages from the owner's `kv_pull` endpoint (`_pull_remote_kv`: frames
assembled on the host, the upload staged on a side stream off the step
thread) and is admitted without a prefill pass; a failed pull recomputes
the prefill. Every worker serves `kv_pull` and `drain` in every mode: the
drain ladder (`engine/drain.py`; SIGTERM, the `drain` verb, or the status
server's POST /drain) parks each live decode sequence's prompt and
generated pages and hands it to a peer with its resume state, and a failed
handoff pull bounces with a plain migrate (the replay rung).

LoadMetrics' `device_ms_in_step` and `host_ms_in_step` stay 0: the
reference fills them from its steptrace, which is not ported. Not ported
yet: the weights endpoint, LoRA and the co-meshed in-process handoff. The
card names the worker's tool and reasoning parsers (`--tool-call-parser`,
`--reasoning-parser`), and the scheduler's logits processors get the card's
tokenizer, as in the reference.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import logging
import os
import threading
import time
import uuid
from typing import AsyncIterator, Optional, Union

from ..config import env
from ..device import DeviceLike, resolve_device
from ..kv_router.local_indexer import LocalKvIndexer
from ..kv_router.protocols import (
    KV_EVENT_TOPIC,
    KV_SNAPSHOT_TOPIC,
    LOAD_TOPIC,
    KvCacheRemoved,
    KvCacheStored,
    LoadMetrics,
    RouterEvent,
)
from ..llm.kv_transfer import (
    BlockAssembler,
    KvLayoutDescriptor,
    PendingTransfer,
    PendingTransferTable,
    StreamingTransfer,
    encode_block_chunks,
)
from ..llm.model_card import (
    CHAT,
    COMPLETIONS,
    PREFILL,
    ModelDeploymentCard,
    publish_card,
    unpublish_card,
)
from ..llm.protocols import (
    EngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from ..llm.tokenizer import load_tokenizer
from ..models import ModelConfig, Transformer, get_config
from ..models.checkpoint import config_from_checkpoint, load_params
from ..models.transformer import AttentionFn
from ..runtime.component import new_instance_id
from ..runtime.metrics import DISAGG_STREAMED_PAGES
from ..runtime.push_router import PushRouter
from .model_runner import ModelRunner, RunnerConfig
from .drain import SERVING, DrainCoordinator, set_drain_state
from .scheduler import InferenceScheduler

log = logging.getLogger("dynamo_tpu_torch.worker")


class KvEventBuffer:
    """Thread-safe KV event buffer: the scheduler thread records stored /
    removed page hashes; an async drain task batches them onto the event
    plane (the reference batches publishes the same way,
    kv_router/publisher). Event ids are consecutive per worker, and the
    local indexer records each event under the same lock."""

    def __init__(self, worker_id: int, dp_rank: int = 0) -> None:
        self.worker_id = worker_id
        self.dp_rank = dp_rank
        self._lock = threading.Lock()
        self._pending: list[RouterEvent] = []
        self._event_id = 0
        # Queryable record of this worker's blocks — the router's resync/
        # bootstrap source (kv_router/local_indexer.py).
        self.local_index = LocalKvIndexer(worker_id, dp_rank)

    def on_stored(self, hashes: list[int], parent: Optional[int]) -> None:
        with self._lock:
            self._pending.append(RouterEvent(
                worker_id=self.worker_id, event_id=self._event_id,
                dp_rank=self.dp_rank,
                stored=KvCacheStored(block_hashes=list(hashes),
                                     parent_hash=parent),
            ))
            self.local_index.on_stored(self._event_id, list(hashes), parent)
            self._event_id += 1

    def on_removed(self, hashes: list[int]) -> None:
        with self._lock:
            self._pending.append(RouterEvent(
                worker_id=self.worker_id, event_id=self._event_id,
                dp_rank=self.dp_rank,
                removed=KvCacheRemoved(block_hashes=list(hashes)),
            ))
            self.local_index.on_removed(self._event_id, list(hashes))
            self._event_id += 1

    def on_cleared(self) -> None:
        """Whole-cache invalidation (clear_kv_blocks)."""
        with self._lock:
            self._pending.append(RouterEvent(
                worker_id=self.worker_id, event_id=self._event_id,
                dp_rank=self.dp_rank, cleared=True,
            ))
            self.local_index.on_cleared(self._event_id)
            self._event_id += 1

    def drain(self) -> list[RouterEvent]:
        with self._lock:
            out, self._pending = self._pending, []
            return out


class TorchWorker:
    def __init__(
        self,
        model: Union[str, ModelConfig] = "llama3-8b",
        runner_config: Optional[RunnerConfig] = None,
        *,
        device: DeviceLike = "cuda",
        seed: int = 0,
        params: Optional[Transformer] = None,
        attention_fn: Optional[AttentionFn] = None,
        namespace: str = "dynamo",
        component: str = "backend",
        tool_parser: Optional[str] = None,
        reasoning_parser: Optional[str] = None,
        model_path: Optional[str] = None,
        served_name: Optional[str] = None,
        dtype: str = "bfloat16",
        mode: str = "aggregated",
    ) -> None:
        """`model` is a preset name or a ModelConfig. Without `params` the
        weights are random, drawn from `seed` on `device`. `model_path`, an
        HF checkpoint directory, overrides both: the config comes from its
        config.json (named after the directory) and the weights, cast to
        `dtype` (bfloat16, as the reference), from its shards; the
        runner's weight_dtype then quantizes them in place. The card is
        named `served_name` when given. `attention_fn`
        goes to the runner, as `TpuWorker(attention_fn=...)` does: the
        unified forward then serves decode and prefill with it (for example
        `ops.paged_attention.paged_attention`, the T = 1 kernel), and
        speculation is off. `namespace` and `component` place the worker's
        endpoints and card for `serve`; `tool_parser` and `reasoning_parser`
        go on the card, for the frontends' output parsers. `mode` is
        "aggregated", "prefill" (a `[PREFILL]` card; every request is served
        prefill-only) or "decode" (served as aggregated: it decodes what a
        prefill pool prefilled, and prefills itself when no pool answers)."""
        if mode not in ("aggregated", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r} (expected aggregated, "
                             "prefill or decode)")
        self.mode = mode
        self.device = resolve_device(device)
        tokenizer = {"kind": "byte"}
        if model_path:
            if params is not None:
                raise ValueError("give model_path or params, not both")
            self.model_config = config_from_checkpoint(model_path,
                                                       dtype=dtype)
            params = load_params(model_path, self.model_config,
                                 device=self.device)
            if os.path.exists(os.path.join(model_path, "tokenizer.json")):
                tokenizer = {"kind": "hf", "path": model_path}
        else:
            self.model_config = (get_config(model) if isinstance(model, str)
                                 else model)
        self.runner_config = runner_config or RunnerConfig(
            page_size=env("DYNT_KV_BLOCK_SIZE"))
        self.runner = ModelRunner(self.model_config, self.runner_config,
                                  device=self.device, params=params,
                                  seed=seed, attention_fn=attention_fn)
        self.runtime = None
        self.instance_id = new_instance_id()
        self.events = KvEventBuffer(self.instance_id)
        self.scheduler = InferenceScheduler(
            self.runner, on_stored=self.events.on_stored,
            on_removed=self.events.on_removed)
        # Parked KV transfers served by kv_pull (a prefill leg's prompt
        # pages, or a drain handoff's), expired on the event-drain tick
        self.transfers = PendingTransferTable()
        # Streamed handoffs (DYNT_DISAGG_PIPELINE): live streaming transfers
        # by request id, appended per prefill chunk on the scheduler thread
        self.disagg_pipeline = max(0, int(env("DYNT_DISAGG_PIPELINE") or 0))
        self._stream_transfers: dict[str, StreamingTransfer] = {}
        self._pull_clients: dict[str, PushRouter] = {}
        # The drain ladder (engine/drain.py); LoadMetrics carries the flag
        self.draining = False
        self._drain_coordinator: Optional[DrainCoordinator] = None
        self._publisher = None
        # The latest pulls' sizes and times (kv_pull's puller side)
        self.pulls: collections.deque = collections.deque(maxlen=256)
        self.card = ModelDeploymentCard(
            name=served_name or self.model_config.name,
            model_types=[PREFILL] if mode == "prefill" else [CHAT, COMPLETIONS],
            namespace=namespace,
            component=component,
            endpoint="generate",
            context_length=min(self.model_config.max_context,
                               self.runner_config.max_context),
            kv_block_size=self.runner_config.page_size,
            total_kv_blocks=self.runner_config.num_pages,
            tokenizer=tokenizer,
            tool_parser=tool_parser,
            reasoning_parser=reasoning_parser,
        )
        # Routers bootstrap / gap-resync from our local indexer (the
        # frontend's manager gates its resync calls on this flag).
        self.card.runtime_config["kv_blocks_endpoint"] = True
        # Logits-processor factories that declare a `tokenizer` parameter
        # (guided decoding) get this model's tokenizer.
        self.scheduler.logits_tokenizer = load_tokenizer(self.card.tokenizer)
        self._served: list = []
        self._tasks: list[asyncio.Task] = []

    def start(self) -> None:
        """Warm the runner up (builds the kernels on the card) and start the
        scheduler thread."""
        self.runner.warmup()
        self.scheduler.start()

    def close(self) -> None:
        """Stop the scheduler thread (`shutdown` first when serving)."""
        self.scheduler.stop()

    async def serve(self, runtime) -> None:
        """Register `generate`, `clear_kv_blocks`, `kv_blocks`, `kv_pull`
        and `drain` on `runtime`'s request plane (a DistributedRuntime),
        publish the card, and start publishing KV events and load metrics
        on its event plane."""
        self.runtime = runtime
        component = (self.runtime.namespace(self.card.namespace)
                     .component(self.card.component))
        canary = PreprocessedRequest(
            request_id="_canary", token_ids=[0],
            sampling=SamplingOptions(max_tokens=1, temperature=0.0),
            stop=StopConditions(), annotations={"canary": True}).to_wire()
        # kv_pull and drain are served in every mode: a drain parks live
        # decode sequences' pages, and the handoff's destination pulls them
        for name, handler, payload in (
                ("generate", self.generate, canary),
                ("clear_kv_blocks", self._clear_kv, None),
                ("kv_blocks", self._kv_blocks, None),
                ("kv_pull", self._kv_pull, None),
                ("drain", self._drain_endpoint, None)):
            self._served.append(await component.endpoint(name).serve_endpoint(
                handler, instance_id=self.instance_id,
                health_check_payload=payload))
        if getattr(self.runtime, "status_server", None) is not None:
            self.runtime.status_server.register_drain(self.drain)
        set_drain_state(self.instance_id, SERVING)
        await publish_card(self.runtime, self.card, self.instance_id)
        publisher = self.runtime.event_publisher(self.card.namespace)
        self._publisher = publisher
        if hasattr(publisher, "set_snapshot_fn"):
            # Durable journal plane: rotations seed the new generation
            # with this worker's full index instead of the old history.
            publisher.set_snapshot_fn(
                lambda: [(KV_SNAPSHOT_TOPIC,
                          self.events.local_index.dump())])
        self._tasks.append(asyncio.create_task(self._event_drain(publisher)))
        log.info("torch worker serving %s (instance=%x, device=%s, mode=%s)",
                 self.card.name, self.instance_id, self.device, self.mode)

    async def shutdown(self) -> None:
        """Unpublish the card, deregister and drain the endpoints, stop the
        event drain, then stop the scheduler."""
        if self._served:
            await unpublish_card(self.runtime, self.card, self.instance_id)
            for served in self._served:
                await served.shutdown()
            self._served = []
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        for router in self._pull_clients.values():
            await router.client.close()
        self._pull_clients = {}
        self.close()

    async def _clear_kv(self, body, ctx) -> AsyncIterator[dict]:
        cleared = self.scheduler.pool.clear()
        self.events.on_cleared()
        yield {"cleared_blocks": len(cleared)}

    async def _kv_blocks(self, body, ctx=None) -> AsyncIterator[dict]:
        yield self.events.local_index.dump()

    def _load_metrics(self) -> LoadMetrics:
        pool = self.scheduler.pool
        stats = self.scheduler.stats
        active, waiting = self.scheduler.queue_depth()
        return LoadMetrics(
            worker_id=self.instance_id,
            active_blocks=pool.num_pages - 1 - pool.free_count(),
            total_blocks=pool.num_pages,
            active_requests=active,
            waiting_requests=waiting,
            kv_usage=pool.usage(),
            step_wall_ms=stats.last_step_wall_ms,
            prefill_tokens_in_step=stats.prefill_tokens_last_step,
            decode_tokens_in_step=stats.decode_tokens_last_step,
            draining=self.draining,
        )

    async def _event_drain(self, publisher, interval: float = 0.05) -> None:
        """KV events every tick, load metrics every 10th (~0.5 s), stale
        transfers expired every 40th (~2 s)."""
        ticks = 0
        while True:
            await asyncio.sleep(interval)
            for event in self.events.drain():
                try:
                    await publisher.publish(KV_EVENT_TOPIC, event.to_wire())
                except Exception:  # noqa: BLE001
                    log.exception("kv event publish failed")
            ticks += 1
            if ticks % 40 == 0:
                try:
                    self.transfers.expire_stale()
                except Exception:  # noqa: BLE001 — the drain task survives
                    log.exception("transfer expiry failed")
            if ticks % 10 == 0:
                try:
                    await publisher.publish(LOAD_TOPIC,
                                            self._load_metrics().to_wire())
                except Exception:  # noqa: BLE001
                    log.exception("load metrics publish failed")

    # -- disaggregation: the owner's side (prefill legs, drain handoffs) ---

    def _transfer_params(self, transfer_id: str, layout: KvLayoutDescriptor,
                         prompt_len: int, streaming: bool = False) -> dict:
        params = {
            "transfer_id": transfer_id,
            "namespace": self.card.namespace,
            "component": self.card.component,
            "instance_id": self.instance_id,
            "layout": layout.to_wire(),
            "prompt_len": prompt_len,
        }
        if streaming:
            # no first_token yet: the pull stream's last frame carries it
            params["streaming"] = True
        return params

    def _layout(self) -> KvLayoutDescriptor:
        return KvLayoutDescriptor.from_wire(self.runner.kv_layout())

    def _register_transfer(self, seq, first_token: int,
                           page_ids: list[int]) -> dict:
        """Scheduler thread, when a prefill-only sequence finishes its
        prompt pass: park its pages with the transfer table and describe the
        pull route. A streamed sequence finishes its StreamingTransfer
        instead of opening a new one."""
        layout = self._layout()
        stream = self._stream_transfers.pop(seq.request.request_id, None)
        if stream is not None:
            stream.finish(first_token, page_ids)
            return {**self._transfer_params(stream.transfer_id, layout,
                                            seq.prompt_len, streaming=True),
                    "first_token": first_token}
        transfer_id = uuid.uuid4().hex
        self.transfers.add(PendingTransfer(
            transfer_id=transfer_id, page_ids=page_ids,
            release=lambda: self.scheduler.release_transfer_pages(seq),
            layout=layout, prompt_len=seq.prompt_len))
        return self._transfer_params(transfer_id, layout, seq.prompt_len)

    def _stream_transfer_chunk(self, seq, new_page_ids):
        """Scheduler thread, after each NON-final prefill chunk of a
        prefill-only sequence: park the newly completed pages with a
        StreamingTransfer, so the decode worker pulls chunk i while chunk
        i+1 computes. The first call registers the transfer and returns the
        params the scheduler emits mid-stream; `new_page_ids=None` is the
        abort signal (cancel or error before the prompt finished)."""
        rid = seq.request.request_id
        if new_page_ids is None:
            stream = self._stream_transfers.pop(rid, None)
            if stream is not None:
                stream.fail()
            return None
        DISAGG_STREAMED_PAGES.labels(
            worker=f"{self.instance_id:x}").inc(len(new_page_ids))
        stream = self._stream_transfers.get(rid)
        if stream is not None:
            stream.append_pages(new_page_ids)
            return None
        layout = self._layout()
        stream = StreamingTransfer(
            transfer_id=uuid.uuid4().hex,
            page_ids=[int(p) for p in new_page_ids],
            release=lambda: self.scheduler.release_transfer_pages(seq),
            layout=layout, prompt_len=seq.prompt_len, table=self.transfers)
        self._stream_transfers[rid] = stream
        self.transfers.add(stream)
        return self._transfer_params(stream.transfer_id, layout,
                                     seq.prompt_len, streaming=True)

    async def _gather_to_host(self, page_ids: list[int], run) -> object:
        """The pages' bundle on the host: the device gather on the scheduler
        thread through `run` (run_in_step or run_in_gap), the copy off it."""
        q = run(lambda: self.runner.gather_pages_device(page_ids))
        # bounded: a scheduler shutting down still runs queued callbacks,
        # but the handler never hangs on a wedged one
        bundle, exc = await asyncio.to_thread(q.get, True, 60.0)
        if exc is not None:
            raise exc
        return await asyncio.to_thread(self.runner.bundle_to_host, bundle)

    async def _kv_pull(self, body: dict, ctx=None) -> AsyncIterator[dict]:
        """A peer pulls parked pages here: the claim removes the entry (the
        TTL can no longer release pages a gather reads), the pages are
        gathered and streamed as chunked binary frames, and the claimer
        releases them once, however the stream ends."""
        transfer_id = (body or {}).get("transfer_id", "")
        transfer = self.transfers.claim(transfer_id)
        if transfer is None:
            yield {"error": f"unknown transfer {transfer_id}"}
            return
        try:
            if transfer.streaming:
                async for frame in self._stream_kv_pull(transfer, ctx):
                    yield frame
                return
            try:
                blocks = await self._gather_to_host(
                    transfer.page_ids, self.scheduler.run_in_step)
            except Exception as exc:  # noqa: BLE001 — an error frame; the
                # puller recomputes
                yield {"error": f"gather failed: {exc!r}"}
                return
            for frame in encode_block_chunks(blocks, transfer.layout):
                yield frame
        finally:
            transfer.release()

    async def _stream_kv_pull(self, transfer: StreamingTransfer,
                              ctx) -> AsyncIterator[dict]:
        """Serve a streaming transfer: gather and send each chunk's pages as
        the scheduler parks them, then a last frame with the first sampled
        token. The gathers ride the scheduler's dispatch/drain gap
        (run_in_gap)."""
        layout = transfer.layout
        total = transfer.total_pages
        deadline = getattr(ctx, "deadline", None)
        budget = deadline.remaining() if deadline is not None else None
        if budget is not None and budget <= 0:
            yield {"error": "request deadline expired before streaming kv "
                            "pull"}
            return
        # A deadline bounds the whole pull; without one, a 120 s stall
        # window re-armed on every chunk of progress.
        overall = time.monotonic() + max(1.0, budget if budget is not None
                                         else 120.0)
        sent = 0
        while True:
            ids, done, failed = await asyncio.to_thread(
                transfer.wait_ready, sent, 1.0)
            if failed:
                yield {"error": f"transfer {transfer.transfer_id} aborted "
                                "(prefill cancelled)"}
                return
            new = ids[sent:]
            if not new and not done:
                if time.monotonic() > overall:
                    yield {"error": "streaming transfer timed out awaiting "
                                    "prefill chunks"}
                    return
                continue
            if new:
                if budget is None:
                    overall = time.monotonic() + 120.0
                try:
                    blocks = await self._gather_to_host(
                        new, self.scheduler.run_in_gap)
                except Exception as exc:  # noqa: BLE001 — an error frame
                    yield {"error": f"gather failed: {exc!r}"}
                    return
                for frame in encode_block_chunks(blocks, layout, base=sent,
                                                 total_pages=total):
                    yield frame
                sent += len(new)
            if done and sent >= len(ids):
                yield {"done": True, "first_token": transfer.first_token,
                       "total_pages": total}
                return

    # -- disaggregation: the puller's side ---------------------------------

    async def _pull_remote_kv(self, params: dict, request_id: str = "",
                              deadline=None):
        """Pull parked pages from their owner. Returns (bundle, first_token)
        with the bundle staged on this runner's device, or (None, None)
        when the pull or its assembly fails (the caller recomputes, or, for
        a drain handoff, replays). A streamed handoff's first token comes in
        the pull stream's last frame. `deadline` is the request's remaining
        end-to-end budget."""
        if params.get("mock") or "layout" not in params:
            return None, None  # a mocker handoff carries no data
        remote = KvLayoutDescriptor.from_wire(params["layout"])
        local = self._layout()
        if not remote.compatible(local):
            log.warning("kv layout mismatch (remote=%s local=%s); "
                        "recomputing", remote, local)
            return None, None
        subject = f"{params['namespace']}/{params['component']}/kv_pull"
        router = self._pull_clients.get(subject)
        if router is None:
            endpoint = (self.runtime.namespace(params["namespace"])
                        .component(params["component"]).endpoint("kv_pull"))
            router = PushRouter(endpoint.client(), mode="round_robin")
            await router.client.start()
            self._pull_clients[subject] = router
        assembler = BlockAssembler()
        pulled_bytes = 0
        first_token = None
        start = time.monotonic()
        t_first = None  # the first page frame's arrival
        try:
            async with contextlib.aclosing(router.generate(
                    {"transfer_id": params["transfer_id"]},
                    instance_id=params["instance_id"],
                    deadline=deadline)) as stream:
                async for frame in stream:
                    if frame.get("error"):
                        log.warning("kv pull failed: %s", frame["error"])
                        return None, None
                    if frame.get("done"):
                        first_token = frame.get("first_token")
                        continue
                    t_first = t_first or time.monotonic()
                    pulled_bytes += len(frame.get("data") or b"")
                    assembler.add(frame)
            if not assembler.complete:
                log.warning("kv pull incomplete; recomputing")
                return None, None
            t_frames = time.monotonic()
            blocks, _ = assembler.assemble()
        except Exception:  # noqa: BLE001 — a transport or assembly failure
            log.exception("kv pull failed; recomputing")
            return None, None
        pull_s = time.monotonic() - start
        # Stage the upload here, off the step thread: admission's scatter
        # then only does the indexed write.
        t0 = time.monotonic()
        staged = await asyncio.to_thread(self._stage, blocks)
        # pull_ms: the request to the assembled bundle; of it, wait_ms until
        # the first page frame (a streamed pull waits on the prefill there)
        # and assemble_ms the host assembly
        self.pulls.append({
            "request_id": request_id, "transfer_id": params["transfer_id"],
            "bytes": pulled_bytes, "pages": int(blocks.shape[0]),
            "pull_ms": pull_s * 1e3,
            "wait_ms": ((t_first or t_frames) - start) * 1e3,
            "assemble_ms": (t0 - t_frames) * 1e3,
            "stage_ms": (time.monotonic() - t0) * 1e3})
        if first_token is None:
            first_token = params.get("first_token")
        return staged, first_token

    def _stage(self, blocks):
        """Upload a pulled bundle and wait for it (a worker thread)."""
        staged = self.runner.stage_bundle(blocks)
        if staged.ready is not None:
            staged.ready.synchronize()
        return staged

    # -- graceful drain (engine/drain.py) -----------------------------------

    async def announce_draining(self) -> None:
        """Flip this worker to draining where routers look: its card
        (runtime_config) and an immediate LoadMetrics publish (the next
        ~0.5 s tick would leave a window where routers still pick it)."""
        self.draining = True
        self.card.runtime_config["draining"] = True
        if self.runtime is None:
            return
        try:
            await publish_card(self.runtime, self.card, self.instance_id)
        except Exception:  # noqa: BLE001 — LoadMetrics still flips
            # routers; lease expiry is the backstop
            log.exception("draining card republish failed")
        if self._publisher is not None:
            try:
                await self._publisher.publish(
                    LOAD_TOPIC, self._load_metrics().to_wire())
            except Exception:  # noqa: BLE001
                log.exception("draining load publish failed")

    def register_drain_handoff(self, seq, page_ids: list[int],
                               computed_tokens: int) -> dict:
        """Scheduler thread, from `drain_sweep`: park a live decode
        sequence's computed pages with the transfer table (kv_pull serves
        them while this worker drains) and describe the pull route and the
        resume state the destination needs."""
        layout = self._layout()
        transfer_id = uuid.uuid4().hex
        self.transfers.add(PendingTransfer(
            transfer_id=transfer_id, page_ids=[int(p) for p in page_ids],
            release=lambda: self.scheduler.release_transfer_pages(seq),
            layout=layout, prompt_len=computed_tokens))
        params = self._transfer_params(transfer_id, layout, computed_tokens)
        params["handoff"] = {
            "seed": int(seq.seed),
            "generated": [int(t) for t in seq.generated],
            "prompt_len": int(seq.prompt_len),
        }
        return params

    async def drain(self, reason: str = "signal",
                    deadline_secs: Optional[float] = None) -> dict:
        """Run (or join) the departure ladder (engine/drain.py); idempotent.
        `deadline_secs` overrides DYNT_DRAIN_DEADLINE_SECS for the call that
        starts the ladder."""
        if self._drain_coordinator is None:
            self._drain_coordinator = DrainCoordinator(
                self, deadline_secs=deadline_secs)
        return await self._drain_coordinator.drain(reason)

    async def _drain_endpoint(self, body: dict, ctx=None
                              ) -> AsyncIterator[dict]:
        """The drain verb on the request plane: run the ladder and stream
        its report. body.shutdown=true also resolves the process's shutdown
        event, so its main deregisters after the drain."""
        report = await self.drain(reason=(body or {}).get("reason",
                                                          "control"))
        try:
            yield report
        finally:
            # in a finally: a caller that closes the stream once the report
            # lands raises GeneratorExit at the yield, and the drained
            # process must still go
            if (body or {}).get("shutdown"):
                from ..runtime.signals import request_shutdown

                request_shutdown("drain control verb")

    async def generate(self, body: dict, ctx=None) -> AsyncIterator[dict]:
        request = PreprocessedRequest.from_wire(body)
        loop = asyncio.get_running_loop()
        out_queue: asyncio.Queue = asyncio.Queue()

        def emit(output: EngineOutput) -> None:
            loop.call_soon_threadsafe(out_queue.put_nowait, output)

        submit_kwargs: dict = {}
        if (self.mode == "prefill"
                or request.annotations.get("prefill_only")):
            submit_kwargs.update(prefill_only=True,
                                 on_prefill_done=self._register_transfer)
            if self.disagg_pipeline > 0:
                submit_kwargs["on_prefill_chunk"] = self._stream_transfer_chunk
        elif request.disaggregated_params:
            handoff = request.disaggregated_params.get("handoff")
            blocks, first_token = await self._pull_remote_kv(
                request.disaggregated_params, request.request_id,
                deadline=getattr(ctx, "deadline", None))
            if handoff is not None:
                if blocks is None:
                    # A drain handoff cannot fall through to a plain submit
                    # (that re-emits the whole stream over tokens the client
                    # has): bounce with a plain migrate, the replay rung.
                    log.warning("drain handoff pull failed for %s; bouncing "
                                "to replay", request.request_id)
                    yield EngineOutput(
                        finish_reason="migrate",
                        error="drain handoff pull failed; replay").to_wire()
                    return
                submit_kwargs.update(onboard_blocks=blocks,
                                     resume_state=handoff)
            elif blocks is not None and first_token is not None:
                submit_kwargs.update(onboard_blocks=blocks,
                                     onboard_first_token=first_token)
            # else: a plain submit recomputes the prefill
        handle = self.scheduler.submit(request, emit, **submit_kwargs)
        try:
            while True:
                output: EngineOutput = await out_queue.get()
                yield output.to_wire()
                if output.finish_reason is not None:
                    return
        finally:
            handle.cancel()


def build_arg_parser() -> argparse.ArgumentParser:
    """The subset of the reference worker's CLI that this package serves
    (--model-ref stays refused: the model registry is not ported), plus
    --prewarm and --device."""
    parser = argparse.ArgumentParser("dynamo_tpu_torch.worker",
                                     allow_abbrev=False)
    parser.add_argument("--model", default="tiny-test",
                        help="model preset (models/config.py PRESETS)")
    parser.add_argument("--model-path", default=None,
                        help="HF checkpoint directory (config.json + "
                             "*.safetensors [+ tokenizer.json]); overrides "
                             "--model — the architecture comes from the "
                             "checkpoint's config.json")
    parser.add_argument("--served-model-name", default=None)
    parser.add_argument("--namespace", default="dynamo")
    parser.add_argument("--component", default="backend",
                        help="the endpoints' component (a prefill worker's "
                             "default is prefill)")
    parser.add_argument("--mode", default="aggregated",
                        choices=["aggregated", "prefill", "decode"],
                        help="aggregated, or one side of disaggregated "
                             "serving: prefill (a [PREFILL] card; answers "
                             "kv_transfer_params) or decode")
    parser.add_argument("--page-size", type=int,
                        default=env("DYNT_KV_BLOCK_SIZE"))
    parser.add_argument("--num-pages", type=int, default=2048)
    parser.add_argument("--max-batch", type=int, default=16)
    parser.add_argument("--max-pages-per-seq", type=int, default=128)
    parser.add_argument("--weight-dtype", default="model",
                        choices=["model", "int8", "int4"],
                        help="weight storage: model dtype (bf16), W8A16 or "
                             "W4A16")
    parser.add_argument("--kv-dtype", default="model",
                        choices=["model", "int8"],
                        help="KV pool storage: model dtype or int8")
    parser.add_argument("--tool-call-parser", default=None,
                        choices=["hermes", "qwen", "mistral", "llama3_json",
                                 "pythonic", "xml", "dsml", "harmony"])
    parser.add_argument("--reasoning-parser", default=None,
                        choices=["think", "deepseek-r1", "granite",
                                 "harmony", "gpt-oss"])
    parser.add_argument("--prewarm", action="store_true",
                        help="capture the whole steady-state key space "
                             "(ModelRunner.prewarm) before publishing the "
                             "card")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


async def main(argv: Optional[list[str]] = None) -> None:
    from ..runtime import DistributedRuntime, HealthCheckManager, RuntimeConfig
    from ..runtime.signals import wait_for_shutdown_signal

    args = build_arg_parser().parse_args(argv)
    component = args.component
    if args.mode == "prefill" and component == "backend":
        component = "prefill"
    if args.kv_dtype == "int8" and args.mode != "aggregated":
        # As the reference: a drain handoff moves packed int8 bundles, but
        # the disaggregated pools stay model-dtype.
        raise SystemExit("--kv-dtype int8 supports aggregated serving; "
                         "disaggregated prefill/decode pools still require "
                         "kv-dtype=model")
    device = resolve_device(args.device)  # no card: raise before building
    runtime = await DistributedRuntime(RuntimeConfig.from_env()).start()
    worker: Optional[TorchWorker] = None
    health: Optional[HealthCheckManager] = None
    try:
        # in a thread: loading a checkpoint takes seconds
        worker = await asyncio.to_thread(
            TorchWorker, args.model,
            RunnerConfig(page_size=args.page_size, num_pages=args.num_pages,
                         max_batch=args.max_batch,
                         max_pages_per_seq=args.max_pages_per_seq,
                         weight_dtype=args.weight_dtype,
                         kv_dtype=args.kv_dtype),
            model_path=args.model_path, served_name=args.served_model_name,
            device=device, namespace=args.namespace,
            component=component, tool_parser=args.tool_call_parser,
            reasoning_parser=args.reasoning_parser, mode=args.mode)
        await asyncio.to_thread(worker.runner.prewarm if args.prewarm
                                else worker.runner.warmup)
        worker.scheduler.start()
        await worker.serve(runtime)
        health = HealthCheckManager(
            runtime, canary_wait_time=env("DYNT_CANARY_WAIT_SECS"))
        health.start()
        await wait_for_shutdown_signal()
        # The departure ladder before teardown: live streams hand their KV
        # to peers (or replay) instead of dying with the endpoints.
        try:
            await worker.drain("shutdown-signal")
        except Exception:  # noqa: BLE001 — teardown proceeds regardless
            log.exception("graceful drain failed")
    finally:
        if health is not None:
            await health.close()
        if worker is not None:
            await worker.shutdown()
        await runtime.shutdown()
