"""TorchWorker: the engine a worker serves from, and the worker entry point.

Port of `TpuWorker` in `dynamo_tpu/engine/worker.py`. `generate` keeps the
reference's contract: a `PreprocessedRequest` wire dict in, a stream of
`EngineOutput` wire dicts out, the last one carrying `finish_reason`.
`serve()` registers the `generate`, `clear_kv_blocks` and `kv_blocks`
endpoints on a DistributedRuntime's request plane, publishes the worker's
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

LoadMetrics' `device_ms_in_step` and `host_ms_in_step` stay 0: the
reference fills them from its steptrace, which is not ported. Not ported
yet: the weights, kv_pull and drain endpoints, LoRA and disaggregated modes.
The card names the worker's tool and reasoning parsers (`--tool-call-parser`,
`--reasoning-parser`), and the scheduler's logits processors get the card's
tokenizer, as in the reference.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import threading
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
from ..llm.model_card import (
    CHAT,
    COMPLETIONS,
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
from .model_runner import ModelRunner, RunnerConfig
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
        go on the card, for the frontends' output parsers."""
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
        self.card = ModelDeploymentCard(
            name=served_name or self.model_config.name,
            model_types=[CHAT, COMPLETIONS],
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
        """Register `generate`, `clear_kv_blocks` and `kv_blocks` on
        `runtime`'s request plane (a DistributedRuntime), publish the card,
        and start publishing KV events and load metrics on its event
        plane."""
        self.runtime = runtime
        component = (self.runtime.namespace(self.card.namespace)
                     .component(self.card.component))
        canary = PreprocessedRequest(
            request_id="_canary", token_ids=[0],
            sampling=SamplingOptions(max_tokens=1, temperature=0.0),
            stop=StopConditions(), annotations={"canary": True}).to_wire()
        for name, handler, payload in (
                ("generate", self.generate, canary),
                ("clear_kv_blocks", self._clear_kv, None),
                ("kv_blocks", self._kv_blocks, None)):
            self._served.append(await component.endpoint(name).serve_endpoint(
                handler, instance_id=self.instance_id,
                health_check_payload=payload))
        await publish_card(self.runtime, self.card, self.instance_id)
        publisher = self.runtime.event_publisher(self.card.namespace)
        if hasattr(publisher, "set_snapshot_fn"):
            # Durable journal plane: rotations seed the new generation
            # with this worker's full index instead of the old history.
            publisher.set_snapshot_fn(
                lambda: [(KV_SNAPSHOT_TOPIC,
                          self.events.local_index.dump())])
        self._tasks.append(asyncio.create_task(self._event_drain(publisher)))
        log.info("torch worker serving %s (instance=%x, device=%s)",
                 self.card.name, self.instance_id, self.device)

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
        )

    async def _event_drain(self, publisher, interval: float = 0.05) -> None:
        """KV events every tick, load metrics every 10th (~0.5 s)."""
        ticks = 0
        while True:
            await asyncio.sleep(interval)
            for event in self.events.drain():
                try:
                    await publisher.publish(KV_EVENT_TOPIC, event.to_wire())
                except Exception:  # noqa: BLE001
                    log.exception("kv event publish failed")
            ticks += 1
            if ticks % 10 == 0:
                try:
                    await publisher.publish(LOAD_TOPIC,
                                            self._load_metrics().to_wire())
                except Exception:  # noqa: BLE001
                    log.exception("load metrics publish failed")

    async def generate(self, body: dict, ctx=None) -> AsyncIterator[dict]:
        request = PreprocessedRequest.from_wire(body)
        loop = asyncio.get_running_loop()
        out_queue: asyncio.Queue = asyncio.Queue()

        def emit(output: EngineOutput) -> None:
            loop.call_soon_threadsafe(out_queue.put_nowait, output)

        handle = self.scheduler.submit(request, emit)
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
    parser.add_argument("--component", default="backend")
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
            component=args.component, tool_parser=args.tool_call_parser,
            reasoning_parser=args.reasoning_parser)
        await asyncio.to_thread(worker.runner.prewarm if args.prewarm
                                else worker.runner.warmup)
        worker.scheduler.start()
        await worker.serve(runtime)
        health = HealthCheckManager(
            runtime, canary_wait_time=env("DYNT_CANARY_WAIT_SECS"))
        health.start()
        await wait_for_shutdown_signal()
    finally:
        if health is not None:
            await health.close()
        if worker is not None:
            await worker.shutdown()
        await runtime.shutdown()
