"""TorchWorker: the engine a worker serves from, and the worker entry point.

Port of `TpuWorker` in `dynamo_tpu/engine/worker.py`. `generate` keeps the
reference's contract: a `PreprocessedRequest` wire dict in, a stream of
`EngineOutput` wire dicts out, the last one carrying `finish_reason`.
`serve()` registers the `generate` and `clear_kv_blocks` endpoints on a
DistributedRuntime's request plane and publishes the worker's
ModelDeploymentCard into discovery, as `TpuWorker.serve` does, so the
frontends of both packages route to it. `main` is
`python -m dynamo_tpu_torch.worker`.

Not ported yet: the kv_blocks, weights, kv_pull and drain endpoints, KV
events and load metrics, LoRA and disaggregated modes.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import AsyncIterator, Optional, Union

from ..config import env
from ..device import DeviceLike, resolve_device
from ..llm.model_card import (
    CHAT,
    COMPLETIONS,
    ModelDeploymentCard,
    publish_card,
    unpublish_card,
)
from ..llm.protocols import EngineOutput, PreprocessedRequest
from ..models import ModelConfig, Transformer, get_config
from ..models.transformer import AttentionFn
from ..runtime.component import new_instance_id
from .model_runner import ModelRunner, RunnerConfig
from .scheduler import InferenceScheduler

log = logging.getLogger("dynamo_tpu_torch.worker")


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
    ) -> None:
        """`model` is a preset name or a ModelConfig. Without `params` the
        weights are random, drawn from `seed` on `device`. `attention_fn`
        goes to the runner, as `TpuWorker(attention_fn=...)` does: the
        unified forward then serves decode and prefill with it (for example
        `ops.paged_attention.paged_attention`, the T = 1 kernel), and
        speculation is off. `namespace` and `component` place the worker's
        endpoints and card for `serve`."""
        self.device = resolve_device(device)
        self.model_config = (get_config(model) if isinstance(model, str)
                             else model)
        self.runner_config = runner_config or RunnerConfig(
            page_size=env("DYNT_KV_BLOCK_SIZE"))
        self.runner = ModelRunner(self.model_config, self.runner_config,
                                  device=self.device, params=params,
                                  seed=seed, attention_fn=attention_fn)
        self.scheduler = InferenceScheduler(self.runner)
        self.runtime = None
        self.instance_id = new_instance_id()
        self.card = ModelDeploymentCard(
            name=self.model_config.name,
            model_types=[CHAT, COMPLETIONS],
            namespace=namespace,
            component=component,
            endpoint="generate",
            context_length=min(self.model_config.max_context,
                               self.runner_config.max_context),
            kv_block_size=self.runner_config.page_size,
            total_kv_blocks=self.runner_config.num_pages,
        )
        self._served: list = []

    def start(self) -> None:
        """Warm the runner up (builds the kernels on the card) and start the
        scheduler thread."""
        self.runner.warmup()
        self.scheduler.start()

    def close(self) -> None:
        """Stop the scheduler thread (`shutdown` first when serving)."""
        self.scheduler.stop()

    async def serve(self, runtime) -> None:
        """Register `generate` and `clear_kv_blocks` on `runtime`'s request
        plane (a DistributedRuntime) and publish the card."""
        self.runtime = runtime
        component = (self.runtime.namespace(self.card.namespace)
                     .component(self.card.component))
        for name, handler in (("generate", self.generate),
                              ("clear_kv_blocks", self._clear_kv)):
            self._served.append(await component.endpoint(name).serve_endpoint(
                handler, instance_id=self.instance_id))
        await publish_card(self.runtime, self.card, self.instance_id)
        log.info("torch worker serving %s (instance=%x, device=%s)",
                 self.card.name, self.instance_id, self.device)

    async def shutdown(self) -> None:
        """Unpublish the card, deregister and drain the endpoints, then stop
        the scheduler."""
        if self._served:
            await unpublish_card(self.runtime, self.card, self.instance_id)
            for served in self._served:
                await served.shutdown()
            self._served = []
        self.close()

    async def _clear_kv(self, body, ctx) -> AsyncIterator[dict]:
        cleared = self.scheduler.pool.clear()
        yield {"cleared_blocks": len(cleared)}

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
    """The subset of the reference worker's CLI that this package serves,
    plus --prewarm and --device."""
    parser = argparse.ArgumentParser("dynamo_tpu_torch.worker",
                                     allow_abbrev=False)
    parser.add_argument("--model", default="tiny-test",
                        help="model preset (models/config.py PRESETS)")
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
    parser.add_argument("--prewarm", action="store_true",
                        help="capture the whole steady-state key space "
                             "(ModelRunner.prewarm) before publishing the "
                             "card")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


async def main(argv: Optional[list[str]] = None) -> None:
    from ..runtime import DistributedRuntime, RuntimeConfig
    from ..runtime.signals import wait_for_shutdown_signal

    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before building
    runtime = await DistributedRuntime(RuntimeConfig.from_env()).start()
    worker: Optional[TorchWorker] = None
    try:
        worker = TorchWorker(
            args.model,
            RunnerConfig(page_size=args.page_size, num_pages=args.num_pages,
                         max_batch=args.max_batch,
                         max_pages_per_seq=args.max_pages_per_seq,
                         weight_dtype=args.weight_dtype,
                         kv_dtype=args.kv_dtype),
            device=device, namespace=args.namespace,
            component=args.component)
        await asyncio.to_thread(worker.runner.prewarm if args.prewarm
                                else worker.runner.warmup)
        worker.scheduler.start()
        await worker.serve(runtime)
        await wait_for_shutdown_signal()
    finally:
        if worker is not None:
            await worker.shutdown()
        await runtime.shutdown()
