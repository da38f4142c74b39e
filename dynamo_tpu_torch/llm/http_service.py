"""OpenAI-compatible HTTP frontend.

Port of `HttpService` in `dynamo_tpu/llm/http_service.py` on this package's
HTTP server (runtime/http.py). Routes (ref: lib/llm/src/http/service/
openai.rs:1811-2191):
  POST /v1/chat/completions   (SSE streaming + aggregated)
  POST /v1/completions        (SSE streaming + aggregated)
  GET  /v1/models
  GET  /health, /live, /metrics
Status codes and error bodies are the reference's: 400 for a bad request,
404 for an unknown model, 503 when no instance serves it or when every
worker's published KV usage is at or above the busy threshold (ref:
busy_threshold.rs), 502 for an engine error, and for a chat template that
fails while it renders the 500 the reference's aiohttp server gives an
uncaught exception. A client disconnect cancels
the handler, and the cancellation travels down the request plane to the
worker (ref: http/service/disconnect.rs). Any other route answers 404.

Not ported yet: embeddings, messages, responses, images and videos; the
per-model busy-threshold routes, deadlines, admission and tenant quotas;
sessions; tracing, the flight recorder and audit.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from typing import Optional

from ..runtime import metrics as rt_metrics
from ..runtime.http import (
    HTTPError,
    HttpServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)
from ..runtime.push_router import NoInstancesAvailable
from ..runtime.request_plane import RemoteError
from ..runtime.status import metrics_response
from .chat_template import TemplateError
from .manager import ModelEntry, ModelManager
from .preprocessor import DeltaGenerator, RequestError
from .protocols import EngineOutput, PreprocessedRequest

log = logging.getLogger("dynamo_tpu_torch.http_service")

# What aiohttp's server answers (text/plain, status 500) when a handler
# raises, as the reference's does for a jinja2 error while rendering.
TEMPLATE_ERROR_BODY = ("500 Internal Server Error\n\n"
                       "Server got itself in trouble")


def _error_body(status: int, message: str,
                err_type: str = "invalid_request_error") -> dict:
    return {"error": {"message": message, "type": err_type, "code": status}}


def _sse(data) -> bytes:
    return f"data: {json.dumps(data)}\n\n".encode()


class _LatencyObserver:
    """Per-request TTFT / ITL histograms, shared by the streaming and
    aggregate paths."""

    def __init__(self, model: str) -> None:
        self.model = model
        self.start = time.monotonic()
        self.first_at: Optional[float] = None
        self.last_at: Optional[float] = None

    def on_output(self, output: EngineOutput) -> None:
        if not output.token_ids:
            return
        now = time.monotonic()
        if self.first_at is None:
            self.first_at = now
            rt_metrics.TTFT_SECONDS.labels(model=self.model).observe(
                now - self.start)
        elif self.last_at is not None:
            rt_metrics.ITL_SECONDS.labels(model=self.model).observe(
                (now - self.last_at) / max(1, len(output.token_ids)))
        self.last_at = now


class HttpService:
    def __init__(self, manager: ModelManager, host: str = "0.0.0.0",
                 port: int = 8000,
                 busy_threshold: Optional[float] = None) -> None:
        self.manager = manager
        self.host = host
        self.port = port
        self.busy_threshold = busy_threshold
        self._server: Optional[HttpServer] = None

    # -- helpers -----------------------------------------------------------

    def _lookup(self, model: str) -> ModelEntry:
        entry = self.manager.get(model)
        if entry is None:
            raise HTTPError(json_response(
                _error_body(404, f"model '{model}' not found",
                            "model_not_found"), status=404))
        return entry

    def _check_busy(self, entry: ModelEntry) -> None:
        """Shed load when every live worker is past the KV busy threshold
        (ref: busy_threshold.rs + KvWorkerMonitor), by the usage its
        LoadMetrics published, which flow in every router mode."""
        if self.busy_threshold is None:
            return
        usages = [entry.worker_usage[iid]
                  for iid in entry.router.client.instance_ids()
                  if iid in entry.worker_usage]
        if usages and min(usages) >= self.busy_threshold:
            rt_metrics.REQUESTS_SHED.labels(reason="busy").inc()
            raise HTTPError(json_response(
                _error_body(503, "service busy", "overloaded"), status=503,
                headers={"Retry-After": "1"}))

    # -- handlers ----------------------------------------------------------

    async def _models(self, _request: Request) -> Response:
        data = [{"id": card.name, "object": "model", "created": 0,
                 "owned_by": "dynamo_tpu"}
                for card in self.manager.list_models()]
        return json_response({"object": "list", "data": data})

    async def _health(self, _request: Request) -> Response:
        models = [c.name for c in self.manager.list_models()]
        return json_response(
            {"status": "healthy" if models else "no_models",
             "models": models})

    async def _metrics(self, request: Request) -> Response:
        return metrics_response(request)

    async def _chat(self, request: Request):
        return await self._completion_common(request, kind="chat")

    async def _completions(self, request: Request):
        return await self._completion_common(request, kind="completions")

    async def _completion_common(self, request: Request, kind: str):
        try:
            body = request.json()
        except (ValueError, UnicodeDecodeError):
            return json_response(_error_body(400, "invalid JSON body"),
                                 status=400)
        if not isinstance(body, dict):
            return json_response(
                _error_body(400, "request body must be a JSON object"),
                status=400)
        model = body.get("model", "")
        entry = self._lookup(model)
        self._check_busy(entry)
        try:
            if kind == "chat":
                preprocessed = entry.preprocessor.preprocess_chat(body)
            else:
                preprocessed = entry.preprocessor.preprocess_completions(body)
        except RequestError as exc:
            return json_response(_error_body(400, str(exc)), status=400)
        except TemplateError:
            log.exception("chat template failed for model %s", model)
            return Response(TEMPLATE_ERROR_BODY, 500)
        # Tool parsing activates only when the request declares tools (the
        # reference gates on request.tools the same way); reasoning parsing
        # follows the model card.
        card = entry.preprocessor.card
        delta_gen = DeltaGenerator(
            entry.preprocessor, preprocessed, kind=kind,
            tool_parser=card.tool_parser if body.get("tools") else None,
            reasoning_parser=card.reasoning_parser)
        rt_metrics.INPUT_TOKENS.labels(model=model).observe(
            len(preprocessed.token_ids))
        if body.get("stream", False):
            return await self._stream_response(request, entry, preprocessed,
                                               delta_gen, body)
        return await self._aggregate_response(entry, preprocessed, delta_gen)

    def _count_request(self, model: str, status: str, start: float) -> None:
        """Frontend request counter + duration (ref: http/service/metrics.rs
        request counts feeding the Planner)."""
        labels = dict(namespace="http", component="frontend", endpoint=model)
        rt_metrics.REQUESTS_TOTAL.labels(status=status, **labels).inc()
        rt_metrics.REQUEST_DURATION.labels(**labels).observe(
            max(0.0, time.monotonic() - start))

    async def _consume(self, entry: ModelEntry,
                       preprocessed: PreprocessedRequest,
                       delta_gen: DeltaGenerator) -> Optional[Response]:
        """Drive the engine stream to completion through `delta_gen`.
        Returns an error Response, or None on success."""
        obs = _LatencyObserver(preprocessed.model)
        try:
            async with contextlib.aclosing(
                    entry.engine.generate(preprocessed)) as stream:
                async for output in stream:
                    obs.on_output(output)
                    delta_gen.on_output(output)
                    if output.error:
                        return json_response(
                            _error_body(502, output.error, "engine_error"),
                            status=502)
        except NoInstancesAvailable:
            return json_response(
                _error_body(503, "no workers available", "overloaded"),
                status=503, headers={"Retry-After": "1"})
        except RemoteError as exc:
            return json_response(
                _error_body(502, str(exc), "engine_error"), status=502)
        return None

    async def _aggregate_response(self, entry: ModelEntry,
                                  preprocessed: PreprocessedRequest,
                                  delta_gen: DeltaGenerator) -> Response:
        model = preprocessed.model
        start = time.monotonic()
        status = "error"
        try:
            err = await self._consume(entry, preprocessed, delta_gen)
            if err is not None:
                return err
            rt_metrics.OUTPUT_TOKENS.labels(model=model).observe(
                delta_gen.completion_tokens)
            status = "ok"
            return json_response(delta_gen.final_response())
        finally:
            self._count_request(model, status, start)

    async def _stream_response(self, request: Request, entry: ModelEntry,
                               preprocessed: PreprocessedRequest,
                               delta_gen: DeltaGenerator,
                               body: dict) -> StreamResponse:
        model = preprocessed.model
        response = StreamResponse(status=200, headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "X-Request-Id": preprocessed.request_id,
        })
        await response.prepare(request)
        start = time.monotonic()
        obs = _LatencyObserver(model)
        include_usage = bool(
            (body.get("stream_options") or {}).get("include_usage", False))
        try:
            # aclosing: a client that goes away while a chunk is being
            # written closes the engine stream (and so cancels the request
            # on the worker) at once, not at garbage collection
            async with contextlib.aclosing(
                    entry.engine.generate(preprocessed)) as stream:
                async for output in stream:
                    obs.on_output(output)
                    for chunk in delta_gen.on_output(output):
                        await response.write(_sse(chunk))
                    if delta_gen.finish_reason is not None:
                        break
            if include_usage:
                await response.write(_sse({
                    "id": delta_gen.chunk_id,
                    "object": ("chat.completion.chunk"
                               if delta_gen.kind == "chat"
                               else "text_completion"),
                    "created": delta_gen.created, "model": model,
                    "choices": [], "usage": delta_gen.usage()}))
            await response.write(b"data: [DONE]\n\n")
        except NoInstancesAvailable:
            await response.write(
                _sse(_error_body(503, "no workers available")))
            await response.write(b"data: [DONE]\n\n")
        except RemoteError as exc:
            # An OpenAI-shaped error event, then a clean end of stream, so
            # SDK clients see a parseable failure.
            await response.write(
                _sse(_error_body(502, str(exc), "engine_error")))
            await response.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            # Client went away: the cancellation reaches the worker through
            # the request plane.
            log.info("client disconnected: %s", preprocessed.request_id)
            raise
        finally:
            rt_metrics.OUTPUT_TOKENS.labels(model=model).observe(
                delta_gen.completion_tokens)
            # finish_reason "error" is an in-band engine failure.
            status = ("ok" if delta_gen.finish_reason not in (None, "error")
                      else "error")
            self._count_request(model, status, start)
        await response.write_eof()
        return response

    async def start(self) -> None:
        self._server = HttpServer({
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
            ("GET", "/v1/models"): self._models,
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._health,
            ("GET", "/metrics"): self._metrics,
        }, self.host, self.port)
        await self._server.start()
        self.port = self._server.port
        log.info("OpenAI frontend listening on %s:%d", self.host, self.port)

    async def close(self) -> None:
        if self._server is not None:
            await self._server.close()
            self._server = None
