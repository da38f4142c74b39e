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
busy_threshold.rs), 502 for an engine error (an in-band migration-limit or
deadline error included), 504 when the deadline runs out on the way, and
for a chat template that fails while it renders the 500 the reference's
aiohttp server gives an uncaught exception. A client disconnect cancels the
handler, and the cancellation travels down the request plane to the worker
(ref: http/service/disconnect.rs). Any other route answers 404.

Every request gets an end-to-end deadline: the `x-dynt-deadline-ms` header,
else DYNT_DEADLINE_SECS. Before any work the frontend sheds with 503 and a
`Retry-After` from the model's queue-wait estimate (runtime/admission.py) a
request whose budget is already spent, one whose budget cannot survive the
estimated queue wait, and a tenant (`tenant` body field or
`x-dynt-tenant-id` header) over its weighted fair share under contention.

Every completion request opens a flight-recorder timeline
(`runtime/flight_recorder.py`) backdated to its arrival, stamps its first
token, and closes it with the outcome (ok, error, cancelled, shed,
deadline_exceeded); with DYNT_DEBUG_ENDPOINTS the frontend also serves
/debug/requests and /debug/profile, as the status server does.

A `model` names a model or a LoRA adapter a worker advertises: an adapter
resolves, once a request, to its base model's pipeline with
`lora_name` set, and `/v1/models` lists each adapter with its `parent`.

Not ported yet: embeddings, messages, responses, images and videos; the
per-model busy-threshold routes; sessions; tracing and audit.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import math
import time
from typing import Optional

from ..config import env
from ..runtime import metrics as rt_metrics
from ..runtime.admission import (
    AdmissionRefused,
    QueueWaitEstimator,
    check_admission,
    check_tenant_admission,
    get_tenant_ledger,
)
from ..runtime.flight_recorder import current_request_id, get_recorder
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
from ..runtime.resilience import Deadline, DeadlineExceeded
from ..runtime.status import (
    debug_requests_response,
    metrics_response,
    profile_response,
)
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


def _retry_after_header(secs: float) -> dict:
    """An integer Retry-After (RFC 9110), rounded up so a client never
    retries a hair early."""
    return {"Retry-After": str(max(1, math.ceil(secs)))}


class _LatencyObserver:
    """Per-request TTFT / ITL histograms, shared by the streaming and
    aggregate paths. A first token is one request drained from the model's
    queue: the rate its wait estimate divides the backlog by. With a
    request id, the first token is stamped on its timeline."""

    def __init__(self, model: str, wait_estimator: QueueWaitEstimator,
                 request_id: Optional[str] = None) -> None:
        self.model = model
        self.wait_estimator = wait_estimator
        self.request_id = request_id
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
            if self.request_id:
                get_recorder().stamp(self.request_id, "first_token")
            self.wait_estimator.observe_drained(1)
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

    def _lookup(self, model: str) -> tuple[ModelEntry, Optional[str]]:
        """A model or adapter name -> (entry, lora_name), resolved once a
        request: resolving again later could fall back to the base model
        when the adapter is unloaded meanwhile."""
        entry, lora = self.manager.resolve(model)
        if entry is None:
            raise HTTPError(json_response(
                _error_body(404, f"model '{model}' not found",
                            "model_not_found"), status=404))
        return entry, lora

    @staticmethod
    def _retry_after(entry: ModelEntry) -> dict:
        """Retry-After of a 503 shed: the estimated drain time of the
        model's queue, clamped by DYNT_RETRY_AFTER_MIN/MAX_SECS."""
        est = entry.wait_estimator
        return _retry_after_header(
            est.retry_after_s(est.estimate_wait_ms(extra=1)))

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
                headers=self._retry_after(entry)))

    def _admit_deadline(self, request: Request,
                        entry: ModelEntry) -> Optional[Deadline]:
        """The request's end-to-end Deadline: an x-dynt-deadline-ms header
        wins, else DYNT_DEADLINE_SECS (0 disables). A budget already spent
        on arrival is shed with 503 before any work."""
        deadline = Deadline.from_wire(request.headers)
        if deadline is None:
            budget = env("DYNT_DEADLINE_SECS")
            if budget and budget > 0:
                deadline = Deadline(budget)
        if deadline is not None and deadline.expired():
            rt_metrics.REQUESTS_SHED.labels(reason="deadline").inc()
            raise HTTPError(json_response(
                _error_body(503, "request deadline already spent",
                            "overloaded"),
                status=503, headers=self._retry_after(entry)))
        return deadline

    @staticmethod
    def _refused_503(exc: AdmissionRefused) -> HTTPError:
        """The one AdmissionRefused -> 503 translation (body and integer
        Retry-After) every admission edge before dispatch raises."""
        return HTTPError(json_response(
            _error_body(503, str(exc), "overloaded"), status=503,
            headers=_retry_after_header(exc.retry_after_s)))

    def _check_queue_admission(self, entry: ModelEntry,
                               deadline: Optional[Deadline],
                               tenant: str = "") -> None:
        """Refuse a request whose budget cannot survive the estimated queue
        wait of the model's pool, before preprocessing or dispatch. The
        wait is the backlog ahead of this arrival (extra=0)."""
        try:
            check_admission(entry.wait_estimator, deadline, tenant=tenant)
        except AdmissionRefused as exc:
            raise self._refused_503(exc)

    @staticmethod
    def _tenant_of(request: Request, body: dict) -> str:
        """The tenant for shed attribution before preprocessing: the body
        field wins over the header, bounded as the preprocessor bounds
        it."""
        raw = body.get("tenant") or request.headers.get(
            "x-dynt-tenant-id") or ""
        return str(raw).strip()[:64]

    @staticmethod
    def _fold_qos_headers(request: Request, body: dict) -> dict:
        """The x-dynt-priority / x-dynt-tenant-id headers fold into the body
        fields the preprocessor normalizes; body fields win."""
        priority = request.headers.get("x-dynt-priority")
        if priority and not body.get("priority"):
            body["priority"] = priority
        tenant = request.headers.get("x-dynt-tenant-id")
        if tenant and not body.get("tenant"):
            body["tenant"] = tenant
        return body

    def _check_tenant_quota(self, entry: ModelEntry,
                            preprocessed: PreprocessedRequest) -> None:
        """Weighted fair-share admission: refuse an over-share tenant under
        contention (the model's estimated queue wait is non-zero). The
        entry edge deposits admitted token costs into the shared ledger the
        router queue reads."""
        tokens = (len(preprocessed.token_ids)
                  + preprocessed.sampling.max_tokens)
        contended = entry.wait_estimator.estimate_wait_ms() > 0
        try:
            check_tenant_admission(get_tenant_ledger(), preprocessed.tenant,
                                   tokens, contended=contended, observe=True)
        except AdmissionRefused as exc:
            raise self._refused_503(exc)

    # -- handlers ----------------------------------------------------------

    async def _models(self, _request: Request) -> Response:
        data = [{"id": card.name, "object": "model", "created": 0,
                 "owned_by": "dynamo_tpu"}
                for card in self.manager.list_models()]
        data += [{"id": name, "object": "model", "created": 0,
                  "owned_by": "dynamo_tpu", "parent": base}
                 for name, base in self.manager.list_adapters()]
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
        received = time.time()
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
        entry, lora = self._lookup(model)
        self._check_busy(entry)
        deadline = self._admit_deadline(request, entry)
        self._check_queue_admission(entry, deadline,
                                    tenant=self._tenant_of(request, body))
        body = self._fold_qos_headers(request, body)
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
        # after preprocessing (the token cost is known), before dispatch
        self._check_tenant_quota(entry, preprocessed)
        preprocessed.lora_name = lora
        preprocessed.deadline = deadline
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
        rid = preprocessed.request_id
        current_request_id.set(rid)
        # backdated to the handler's entry: tokenization precedes the id
        get_recorder().start(rid, model=preprocessed.model,
                             tenant=preprocessed.tenant, received=received)
        try:
            if body.get("stream", False):
                return await self._stream_response(request, entry,
                                                   preprocessed, delta_gen,
                                                   body)
            return await self._aggregate_response(entry, preprocessed,
                                                  delta_gen)
        except (ConnectionResetError, asyncio.CancelledError):
            # a client going away is normal teardown (a no-op when the
            # response path closed the timeline already)
            get_recorder().finish(rid, "cancelled")
            raise
        except BaseException:
            get_recorder().finish(rid, "error")
            raise

    def _count_request(self, model: str, status: str, start: float,
                       request_id: str) -> None:
        """Frontend request counter + duration (ref: http/service/metrics.rs
        request counts feeding the Planner), and the timeline's close on
        every outcome (a no-op when a more specific status closed it)."""
        labels = dict(namespace="http", component="frontend", endpoint=model)
        rt_metrics.REQUESTS_TOTAL.labels(status=status, **labels).inc()
        rt_metrics.REQUEST_DURATION.labels(**labels).observe(
            max(0.0, time.monotonic() - start))
        get_recorder().finish(request_id, status)

    async def _consume(self, entry: ModelEntry,
                       preprocessed: PreprocessedRequest,
                       delta_gen: DeltaGenerator) -> Optional[Response]:
        """Drive the engine stream to completion through `delta_gen`.
        Returns an error Response, or None on success."""
        obs = _LatencyObserver(preprocessed.model, entry.wait_estimator,
                               preprocessed.request_id)
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
        except AdmissionRefused as exc:
            # A refusal from a downstream edge (the router queue), counted
            # where it was decided.
            get_recorder().finish(preprocessed.request_id, "shed")
            return json_response(
                _error_body(503, str(exc), "overloaded"), status=503,
                headers=_retry_after_header(exc.retry_after_s))
        except DeadlineExceeded as exc:
            rt_metrics.DEADLINE_EXCEEDED.labels(component="frontend").inc()
            get_recorder().finish(preprocessed.request_id,
                                  "deadline_exceeded")
            return json_response(
                _error_body(504, str(exc), "deadline_exceeded"), status=504)
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
            self._count_request(model, status, start,
                                preprocessed.request_id)

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
        obs = _LatencyObserver(model, entry.wait_estimator,
                               preprocessed.request_id)
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
        except AdmissionRefused as exc:
            # A refusal after the stream's headers went out: in-band.
            get_recorder().finish(preprocessed.request_id, "shed")
            await response.write(
                _sse(_error_body(503, str(exc), "overloaded")))
            await response.write(b"data: [DONE]\n\n")
        except DeadlineExceeded as exc:
            rt_metrics.DEADLINE_EXCEEDED.labels(component="frontend").inc()
            get_recorder().finish(preprocessed.request_id,
                                  "deadline_exceeded")
            await response.write(
                _sse(_error_body(504, str(exc), "deadline_exceeded")))
            await response.write(b"data: [DONE]\n\n")
        except RemoteError as exc:
            # An OpenAI-shaped error event, then a clean end of stream, so
            # SDK clients see a parseable failure.
            await response.write(
                _sse(_error_body(502, str(exc), "engine_error")))
            await response.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            # Client went away: the cancellation reaches the worker through
            # the request plane; the timeline closes as cancelled.
            get_recorder().finish(preprocessed.request_id, "cancelled")
            log.info("client disconnected: %s", preprocessed.request_id)
            raise
        finally:
            rt_metrics.OUTPUT_TOKENS.labels(model=model).observe(
                delta_gen.completion_tokens)
            # finish_reason "error" is an in-band engine failure.
            status = ("ok" if delta_gen.finish_reason not in (None, "error")
                      else "error")
            self._count_request(model, status, start,
                                preprocessed.request_id)
        await response.write_eof()
        return response

    async def _debug_requests(self, request: Request) -> Response:
        return debug_requests_response(request)

    async def _debug_profile(self, request: Request) -> Response:
        return await profile_response(request)

    async def start(self) -> None:
        routes = {
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
            ("GET", "/v1/models"): self._models,
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._health,
            ("GET", "/metrics"): self._metrics,
        }
        if env("DYNT_DEBUG_ENDPOINTS"):
            # they leak cross-request timelines: opt-in on the tenant port
            routes[("GET", "/debug/requests")] = self._debug_requests
            routes[("GET", "/debug/profile")] = self._debug_profile
        self._server = HttpServer(routes, self.host, self.port)
        await self._server.start()
        self.port = self._server.port
        log.info("OpenAI frontend listening on %s:%d", self.host, self.port)

    async def close(self) -> None:
        if self._server is not None:
            await self._server.close()
            self._server = None
