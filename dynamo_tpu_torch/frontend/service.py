"""Frontend: HTTP server + model discovery + router in one process.

Port of `dynamo_tpu/frontend/service.py`, the equivalent of
`python -m dynamo.frontend` (ref: components/src/dynamo/frontend/main.py):
starts the OpenAI HTTP service and a ModelWatcher that builds a pipeline per
model card as workers of either package register, and (in kv mode) feeds
each model's radix index from the event plane. Arguments supported: --host,
--port, --router-mode {round_robin,random,p2c,kv},
--kv-overlap-score-weight, --router-temperature and --busy-threshold; the
reference's other flags are refused.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

from ..config import env
from ..kv_router import KvRouterConfig
from ..llm.http_service import HttpService
from ..llm.manager import ModelManager, ModelWatcher
from ..runtime import DistributedRuntime, RuntimeConfig
from ..runtime.signals import wait_for_shutdown_signal

log = logging.getLogger("dynamo_tpu_torch.frontend")


class Frontend:
    def __init__(self, runtime: DistributedRuntime, host: str = "0.0.0.0",
                 port: int = 8000, router_mode: str = "round_robin",
                 kv_overlap_weight: Optional[float] = None,
                 kv_temperature: Optional[float] = None,
                 busy_threshold: Optional[float] = None) -> None:
        self.runtime = runtime
        self.manager = ModelManager()
        kv_config = KvRouterConfig(
            overlap_weight=(env("DYNT_ROUTER_OVERLAP_WEIGHT")
                            if kv_overlap_weight is None
                            else kv_overlap_weight),
            temperature=(env("DYNT_ROUTER_TEMPERATURE")
                         if kv_temperature is None else kv_temperature))
        self.watcher = ModelWatcher(runtime, self.manager,
                                    router_mode=router_mode,
                                    kv_config=kv_config)
        self.http = HttpService(self.manager, host=host, port=port,
                                busy_threshold=busy_threshold)

    @property
    def port(self) -> int:
        return self.http.port

    async def start(self) -> None:
        await self.watcher.start()
        await self.http.start()

    async def close(self) -> None:
        await self.http.close()
        await self.watcher.close()


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("dynamo_tpu_torch.frontend",
                                     allow_abbrev=False)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--router-mode", default="round_robin",
                        choices=["round_robin", "random", "p2c", "kv"])
    parser.add_argument("--kv-overlap-score-weight", type=float, default=None)
    parser.add_argument("--router-temperature", type=float, default=None)
    parser.add_argument("--busy-threshold", type=float,
                        default=env("DYNT_BUSY_THRESHOLD"))
    return parser


async def main(argv: Optional[list[str]] = None) -> None:
    args = build_arg_parser().parse_args(argv)
    runtime = await DistributedRuntime(RuntimeConfig.from_env()).start()
    frontend = Frontend(runtime, host=args.host, port=args.port,
                        router_mode=args.router_mode,
                        kv_overlap_weight=args.kv_overlap_score_weight,
                        kv_temperature=args.router_temperature,
                        busy_threshold=args.busy_threshold)
    try:
        await frontend.start()
        log.info("frontend ready on port %d (router=%s)", frontend.port,
                 args.router_mode)
        await wait_for_shutdown_signal()
    finally:
        await frontend.close()
        await runtime.shutdown()
