"""System status server: /health, /live and /metrics.

Port of `SystemStatusServer` in `dynamo_tpu/runtime/status.py` (ref:
lib/runtime/src/system_status_server.rs:131-178), on this package's HTTP
server (runtime/http.py). Every runtime process exposes liveness, endpoint
health and its Prometheus metrics here. /health answers 503 when any served
endpoint is unhealthy: shutting down, or failing its canaries
(runtime/health_check.py). A worker registers its graceful drain
(`register_drain`); `POST /drain` runs it and answers its report, and is
mounted only while DYNT_DRAIN_HTTP is on (the verb is unauthenticated and
terminal). Not ported yet: /debug/*, /fleet and OpenMetrics negotiation.
"""

from __future__ import annotations

from typing import Awaitable, Callable, Optional

from ..config import env
from . import metrics
from .http import HttpServer, Request, Response, json_response


def metrics_response(_request: Request) -> Response:
    """Shared /metrics responder (status server + frontend)."""
    return Response(metrics.render(), content_type=metrics.CONTENT_TYPE)


class SystemStatusServer:
    def __init__(self, port: int = 0, host: str = "0.0.0.0") -> None:
        self._port = port
        self._host = host
        self._server: Optional[HttpServer] = None
        self.port: Optional[int] = None
        # Health callbacks: name -> () -> bool (endpoints register themselves)
        self._health_checks: dict[str, Callable[[], bool]] = {}
        # The graceful-drain verb (engine/drain.py): an async () -> dict the
        # hosting worker registers; POST /drain without one answers 404.
        self._drain_fn: Optional[Callable[[], Awaitable[dict]]] = None

    def register_health(self, name: str, check: Callable[[], bool]) -> None:
        self._health_checks[name] = check

    def unregister_health(self, name: str) -> None:
        self._health_checks.pop(name, None)

    async def _health(self, _request: Request) -> Response:
        results = {name: bool(check())
                   for name, check in self._health_checks.items()}
        healthy = all(results.values()) if results else True
        return json_response(
            {"status": "healthy" if healthy else "unhealthy",
             "endpoints": results},
            status=200 if healthy else 503)

    async def _live(self, _request: Request) -> Response:
        return json_response({"status": "live"})

    async def _metrics(self, request: Request) -> Response:
        return metrics_response(request)

    def register_drain(self, fn: Callable[[], Awaitable[dict]]) -> None:
        """fn runs the component's graceful drain (idempotent: a second POST
        while draining awaits the first) and returns its report. One slot:
        the last registration wins."""
        self._drain_fn = fn

    async def _drain(self, _request: Request) -> Response:
        if self._drain_fn is None:
            return json_response(
                {"error": "no drainable component registered"}, status=404)
        return json_response(await self._drain_fn())

    async def start(self) -> None:
        routes = {
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._live,
            ("GET", "/metrics"): self._metrics,
        }
        if env("DYNT_DRAIN_HTTP"):
            routes[("POST", "/drain")] = self._drain
        self._server = HttpServer(routes, self._host, self._port)
        await self._server.start()
        self.port = self._server.port

    async def close(self) -> None:
        if self._server is not None:
            await self._server.close()
            self._server = None
