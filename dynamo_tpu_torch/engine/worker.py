"""TorchWorker: the engine a worker serves from.

Port of the `TpuWorker.generate` contract of `dynamo_tpu/engine/worker.py`:
a `PreprocessedRequest` wire dict in, a stream of `EngineOutput` wire dicts
out, the last one carrying `finish_reason`. Discovery, the request plane,
the HTTP frontend and metrics are not part of this slice.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Optional, Union

from ..config import env
from ..device import DeviceLike, resolve_device
from ..llm.protocols import EngineOutput, PreprocessedRequest
from ..models import ModelConfig, Transformer, get_config
from ..models.transformer import AttentionFn
from .model_runner import ModelRunner, RunnerConfig
from .scheduler import InferenceScheduler


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
    ) -> None:
        """`model` is a preset name or a ModelConfig. Without `params` the
        weights are random, drawn from `seed` on `device`. `attention_fn`
        goes to the runner, as `TpuWorker(attention_fn=...)` does: the
        unified forward then serves decode and prefill with it (for example
        `ops.paged_attention.paged_attention`, the T = 1 kernel), and
        speculation is off."""
        self.device = resolve_device(device)
        self.model_config = (get_config(model) if isinstance(model, str)
                             else model)
        self.runner_config = runner_config or RunnerConfig(
            page_size=env("DYNT_KV_BLOCK_SIZE"))
        self.runner = ModelRunner(self.model_config, self.runner_config,
                                  device=self.device, params=params,
                                  seed=seed, attention_fn=attention_fn)
        self.scheduler = InferenceScheduler(self.runner)

    def start(self) -> None:
        """Warm the runner up (builds the kernels on the card) and start the
        scheduler thread."""
        self.runner.warmup()
        self.scheduler.start()

    def close(self) -> None:
        self.scheduler.stop()

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
