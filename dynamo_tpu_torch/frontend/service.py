"""Frontend: HTTP server + model discovery + router in one process.

Port of `dynamo_tpu/frontend/service.py`, the equivalent of
`python -m dynamo.frontend` (ref: components/src/dynamo/frontend/main.py):
starts the OpenAI HTTP service and a ModelWatcher that builds a pipeline per
model card as workers of either package register. Arguments supported:
--host, --port and --router-mode {round_robin,random}; the reference's other
flags are refused.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

from ..llm.http_service import HttpService
from ..llm.manager import ModelManager, ModelWatcher
from ..runtime import DistributedRuntime, RuntimeConfig
from ..runtime.signals import wait_for_shutdown_signal

log = logging.getLogger("dynamo_tpu_torch.frontend")


class Frontend:
    def __init__(self, runtime: DistributedRuntime, host: str = "0.0.0.0",
                 port: int = 8000, router_mode: str = "round_robin") -> None:
        self.runtime = runtime
        self.manager = ModelManager()
        self.watcher = ModelWatcher(runtime, self.manager,
                                    router_mode=router_mode)
        self.http = HttpService(self.manager, host=host, port=port)

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
                        choices=["round_robin", "random"])
    return parser


async def main(argv: Optional[list[str]] = None) -> None:
    args = build_arg_parser().parse_args(argv)
    runtime = await DistributedRuntime(RuntimeConfig.from_env()).start()
    frontend = Frontend(runtime, host=args.host, port=args.port,
                        router_mode=args.router_mode)
    try:
        await frontend.start()
        log.info("frontend ready on port %d (router=%s)", frontend.port,
                 args.router_mode)
        await wait_for_shutdown_signal()
    finally:
        await frontend.close()
        await runtime.shutdown()
