"""OpenAI-compatible HTTP frontend.

Port of `HttpService` in `dynamo_tpu/llm/http_service.py` on this package's
HTTP server (runtime/http.py). Routes (ref: lib/llm/src/http/service/
openai.rs:1811-2191, service_v2.rs, anthropic.rs:63), one table
(`ROUTES`) drives both their registration and /openapi.json and /docs:
  POST /v1/chat/completions   (SSE streaming + aggregated)
  POST /v1/completions        (SSE streaming + aggregated)
  POST /v1/embeddings         (float or base64 vectors of the pooled trunk)
  POST /v1/messages           (Anthropic Messages API, on the chat pipeline)
  POST /v1/responses          (OpenAI Responses API, on the chat pipeline)
  GET  /v1/models
  GET  /health, /live, /metrics
  GET  /busy_threshold, POST /busy_threshold (per-model thresholds)
  POST /clear_kv_blocks       (every worker group's prefix cache)
  GET  /openapi.json, /docs
Status codes and error bodies are the reference's: 400 for a bad request,
404 for an unknown model, 503 when no instance serves it or when every
worker's published KV usage is at or above the model's busy threshold
(ref: busy_threshold.rs), 502 for an engine error (an in-band
migration-limit or deadline error included), 504 when the deadline runs out
on the way, and for a chat template that fails while it renders the 500 the
reference's aiohttp server gives an uncaught exception. The streamed
messages and responses routes write named SSE events (`event: ...` then
`data: ...`) in the reference's order, with an `error` event where it
writes one. A client disconnect cancels the handler, and the cancellation
travels down the request plane to the worker (ref:
http/service/disconnect.rs). Any other route answers 404, a routed path
with another method 405.

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
Embeddings refuse an adapter name (400), as the reference does.

Not ported yet: images and videos (those routes answer 404); sessions;
tracing and audit.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import logging
import math
import time
import uuid
from typing import Optional

import numpy as np

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
from .protocols import (
    EngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
    new_request_id,
    now_unix,
)

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


def _sse_event(event: str, data: dict) -> bytes:
    """A named SSE event (the messages and responses streams)."""
    return f"event: {event}\ndata: {json.dumps(data)}\n\n".encode()


def _bad_request(message: str) -> Response:
    return json_response(_error_body(400, message), status=400)


def _parse_body(request: Request) -> dict:
    """The request's JSON object, or an HTTPError 400."""
    try:
        body = request.json()
    except (ValueError, UnicodeDecodeError):
        raise HTTPError(_bad_request("invalid JSON body")) from None
    if not isinstance(body, dict):
        raise HTTPError(_bad_request("request body must be a JSON object"))
    return body


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
                 busy_threshold: Optional[float] = None,
                 runtime=None) -> None:
        """`runtime` (a DistributedRuntime) serves /clear_kv_blocks'
        fan-out."""
        self.manager = manager
        self.host = host
        self.port = port
        self.busy_threshold = busy_threshold
        # Per-model overrides set with POST /busy_threshold (ref:
        # busy_threshold.rs); `busy_threshold` is the default.
        self.busy_thresholds: dict[str, float] = {}
        self.runtime = runtime
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
        LoadMetrics published, which flow in every router mode. The
        model's own threshold (POST /busy_threshold) wins over the
        default."""
        threshold = self.busy_thresholds.get(entry.card.name,
                                             self.busy_threshold)
        if threshold is None:
            return
        usages = [entry.worker_usage[iid]
                  for iid in entry.router.client.instance_ids()
                  if iid in entry.worker_usage]
        if usages and min(usages) >= threshold:
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

    def _admit(self, request: Request, body: dict
               ) -> tuple[ModelEntry, Optional[str], Optional[Deadline]]:
        """The admission edges every completion-shaped route runs before
        preprocessing: the model (or adapter) lookup, the busy threshold,
        the deadline and the queue-wait estimate."""
        entry, lora = self._lookup(body.get("model", ""))
        self._check_busy(entry)
        deadline = self._admit_deadline(request, entry)
        self._check_queue_admission(entry, deadline,
                                    tenant=self._tenant_of(request, body))
        return entry, lora, deadline

    @staticmethod
    def _open_timeline(preprocessed: PreprocessedRequest,
                       received: float) -> None:
        """The request's flight-recorder timeline, backdated to the
        handler's entry (tokenization precedes the id)."""
        current_request_id.set(preprocessed.request_id)
        get_recorder().start(preprocessed.request_id,
                             model=preprocessed.model,
                             tenant=preprocessed.tenant, received=received)

    @staticmethod
    async def _finish_guard(request_id: str, coro):
        """Close the timeline of a request whose handler raises before its
        response path closed it (a no-op when it did): a client going away
        is cancelled, anything else an error."""
        try:
            return await coro
        except (ConnectionResetError, asyncio.CancelledError):
            get_recorder().finish(request_id, "cancelled")
            raise
        except BaseException:
            get_recorder().finish(request_id, "error")
            raise

    async def _completion_common(self, request: Request, kind: str):
        received = time.time()
        body = _parse_body(request)
        model = body.get("model", "")
        entry, lora, deadline = self._admit(request, body)
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
        self._open_timeline(preprocessed, received)
        if body.get("stream", False):
            respond = self._stream_response(request, entry, preprocessed,
                                            delta_gen, body)
        else:
            respond = self._aggregate_response(entry, preprocessed,
                                               delta_gen)
        return await self._finish_guard(preprocessed.request_id, respond)

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

    # -- embeddings --------------------------------------------------------

    @staticmethod
    def _embedding_inputs(raw, entry: ModelEntry) -> list[list[int]]:
        """OpenAI `input` (str | [str] | [int] | [[int]]) -> token lists."""
        tokenizer = entry.preprocessor.tokenizer
        if isinstance(raw, str):
            return [tokenizer.encode(raw)]
        if isinstance(raw, list) and raw:
            if all(isinstance(x, str) for x in raw):
                return [tokenizer.encode(x) for x in raw]
            if all(isinstance(x, int) for x in raw):
                return [[int(x) for x in raw]]
            if all(isinstance(x, list) for x in raw):
                return [[int(t) for t in x] for x in raw]
        raise RequestError("'input' must be a string, list of strings, or "
                           "token array(s)")

    @staticmethod
    async def _embed_one(entry: ModelEntry, model: str,
                         token_ids: list[int]) -> list[float]:
        """One input's vector: an `embed`-annotated request down the
        model's pipeline, answered by one `emb` frame."""
        pre = PreprocessedRequest(
            request_id=new_request_id(), token_ids=token_ids,
            sampling=SamplingOptions(max_tokens=1, temperature=0.0),
            stop=StopConditions(), model=model, annotations={"embed": True})
        async with contextlib.aclosing(entry.engine.generate(pre)) as stream:
            async for out in stream:
                if out.error:
                    raise RemoteError(out.error)
                if out.embedding is not None:
                    return out.embedding
                if out.finish_reason is not None:
                    break
        raise RemoteError("worker returned no embedding")

    async def _embeddings(self, request: Request) -> Response:
        body = _parse_body(request)
        model = body.get("model", "")
        entry, lora = self._lookup(model)
        if lora is not None:
            return _bad_request(
                f"model '{model}' is a LoRA adapter; adapters are not "
                "supported for embeddings")
        self._check_busy(entry)
        request_id = new_request_id()
        current_request_id.set(request_id)
        try:
            inputs = self._embedding_inputs(body.get("input"), entry)
            for toks in inputs:
                if len(toks) >= entry.card.context_length:
                    raise RequestError(
                        f"input of {len(toks)} tokens exceeds the model "
                        f"context length ({entry.card.context_length})")
        except RequestError as exc:
            return _bad_request(str(exc))
        encoding = body.get("encoding_format", "float")
        if encoding not in ("float", "base64"):
            return _bad_request("encoding_format must be float or base64")
        total = sum(len(t) for t in inputs)
        start = time.monotonic()
        status = "error"
        try:
            try:
                vectors = await asyncio.gather(*[
                    self._embed_one(entry, model, toks) for toks in inputs])
            except NoInstancesAvailable:
                return json_response(
                    _error_body(503, "no workers available", "overloaded"),
                    status=503)
            except RemoteError as exc:
                return json_response(
                    _error_body(502, str(exc), "engine_error"), status=502)
            data = []
            for i, vec in enumerate(vectors):
                payload = (base64.b64encode(np.asarray(
                    vec, "<f4").tobytes()).decode()
                    if encoding == "base64" else vec)
                data.append({"object": "embedding", "index": i,
                             "embedding": payload})
            status = "ok"
            return json_response({
                "object": "list", "data": data, "model": model,
                "usage": {"prompt_tokens": total, "total_tokens": total}})
        finally:
            self._count_request(model, status, start, request_id)

    # -- Anthropic Messages API (ref: http/service/anthropic.rs) -----------

    @staticmethod
    def _messages_to_chat(body: dict) -> dict:
        """Lower an Anthropic Messages request onto the chat pipeline."""
        if not body.get("messages"):
            raise RequestError("'messages' is required")
        if not body.get("max_tokens"):
            raise RequestError("'max_tokens' is required")
        messages = []
        system = body.get("system")
        if system:
            if isinstance(system, list):  # the content-block form
                system = "".join(b.get("text", "") for b in system
                                 if isinstance(b, dict))
            messages.append({"role": "system", "content": system})
        for msg in body["messages"]:
            content = msg.get("content")
            if isinstance(content, list):
                content = "".join(b.get("text", "") for b in content
                                  if isinstance(b, dict)
                                  and b.get("type") == "text")
            messages.append({"role": msg.get("role", "user"),
                             "content": content or ""})
        chat = {
            "model": body.get("model", ""),
            "messages": messages,
            "max_tokens": body["max_tokens"],
            "temperature": body.get("temperature", 1.0),
            "top_p": body.get("top_p", 1.0),
            "top_k": body.get("top_k", 0),
            "stop": body.get("stop_sequences"),
        }
        for key in ("priority", "tenant"):
            if body.get(key):
                chat[key] = body[key]
        return chat

    @staticmethod
    def _anthropic_stop(delta_gen: DeltaGenerator
                        ) -> tuple[str, Optional[str]]:
        """(stop_reason, stop_sequence) in Anthropic terms."""
        if delta_gen.stop_sequence_hit is not None:
            return "stop_sequence", delta_gen.stop_sequence_hit
        reason = {"length": "max_tokens"}.get(
            delta_gen.finish_reason or "stop", "end_turn")
        return reason, None

    def _lowered_chat(self, request: Request, lower, route: str):
        """The shared front of /v1/messages and /v1/responses: admission,
        the lowering onto a chat request, preprocessing and the tenant
        quota. Returns (entry, preprocessed, body, received) or an error
        Response."""
        received = time.time()
        body = _parse_body(request)
        entry, lora, deadline = self._admit(request, body)
        body = self._fold_qos_headers(request, body)
        try:
            preprocessed = entry.preprocessor.preprocess_chat(lower(body))
        except RequestError as exc:
            return _bad_request(str(exc))
        except TemplateError:
            log.exception("chat template failed for model %s (%s)",
                          body.get("model", ""), route)
            return Response(TEMPLATE_ERROR_BODY, 500)
        self._check_tenant_quota(entry, preprocessed)
        preprocessed.lora_name = lora
        preprocessed.deadline = deadline
        rt_metrics.INPUT_TOKENS.labels(model=preprocessed.model).observe(
            len(preprocessed.token_ids))
        self._open_timeline(preprocessed, received)
        return entry, preprocessed, body

    async def _messages(self, request: Request):
        front = self._lowered_chat(request, self._messages_to_chat,
                                   "messages")
        if isinstance(front, Response):
            return front
        entry, preprocessed, body = front
        delta_gen = DeltaGenerator(entry.preprocessor, preprocessed,
                                   kind="chat")
        msg_id = f"msg_{uuid.uuid4().hex[:24]}"
        if body.get("stream", False):
            respond = self._messages_stream(request, entry, preprocessed,
                                            delta_gen, msg_id)
        else:
            respond = self._messages_aggregate(entry, preprocessed,
                                               delta_gen, msg_id)
        return await self._finish_guard(preprocessed.request_id, respond)

    async def _messages_aggregate(self, entry: ModelEntry,
                                  preprocessed: PreprocessedRequest,
                                  delta_gen: DeltaGenerator,
                                  msg_id: str) -> Response:
        start = time.monotonic()
        status = "error"
        try:
            err = await self._consume(entry, preprocessed, delta_gen)
            if err is not None:
                return err
            status = "ok"
        finally:
            self._count_request(preprocessed.model, status, start,
                                preprocessed.request_id)
        stop_reason, stop_sequence = self._anthropic_stop(delta_gen)
        return json_response({
            "id": msg_id,
            "type": "message",
            "role": "assistant",
            "model": preprocessed.model,
            "content": [{"type": "text", "text": delta_gen.full_text}],
            "stop_reason": stop_reason,
            "stop_sequence": stop_sequence,
            "usage": {"input_tokens": len(preprocessed.token_ids),
                      "output_tokens": delta_gen.completion_tokens},
        })

    @staticmethod
    async def _event_stream(request: Request,
                            preprocessed: PreprocessedRequest
                            ) -> StreamResponse:
        response = StreamResponse(status=200, headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "X-Request-Id": preprocessed.request_id,
        })
        await response.prepare(request)
        return response

    async def _drive_events(self, response: StreamResponse,
                            entry: ModelEntry,
                            preprocessed: PreprocessedRequest,
                            delta_gen: DeltaGenerator, on_text, on_done,
                            on_error) -> None:
        """Stream the engine's outputs as named events: `on_text(text)`
        per content delta, `on_done()` at a clean end, `on_error(kind,
        message)` for an in-band or raised failure (kind "timeout" for a
        deadline); then count the request and end the stream."""
        start = time.monotonic()
        obs = _LatencyObserver(preprocessed.model, entry.wait_estimator,
                               preprocessed.request_id)
        errored = False
        try:
            async with contextlib.aclosing(
                    entry.engine.generate(preprocessed)) as stream:
                async for output in stream:
                    obs.on_output(output)
                    if output.error:
                        errored = True
                        await response.write(on_error("api", output.error))
                        break
                    for chunk in delta_gen.on_output(output):
                        text = chunk["choices"][0]["delta"].get("content")
                        if text:
                            await response.write(on_text(text))
                    if delta_gen.finish_reason is not None:
                        break
            if not errored:
                for event in on_done():
                    await response.write(event)
        except (NoInstancesAvailable, AdmissionRefused, RemoteError) as exc:
            errored = True
            if isinstance(exc, AdmissionRefused):
                get_recorder().finish(preprocessed.request_id, "shed")
            await response.write(on_error("api", str(exc)))
        except DeadlineExceeded as exc:
            errored = True
            rt_metrics.DEADLINE_EXCEEDED.labels(component="frontend").inc()
            get_recorder().finish(preprocessed.request_id,
                                  "deadline_exceeded")
            await response.write(on_error("timeout", str(exc)))
        except (ConnectionResetError, asyncio.CancelledError):
            get_recorder().finish(preprocessed.request_id, "cancelled")
            log.info("client disconnected: %s", preprocessed.request_id)
            raise
        finally:
            ok = delta_gen.finish_reason is not None and not errored
            self._count_request(preprocessed.model, "ok" if ok else "error",
                                start, preprocessed.request_id)
        await response.write_eof()

    async def _messages_stream(self, request: Request, entry: ModelEntry,
                               preprocessed: PreprocessedRequest,
                               delta_gen: DeltaGenerator,
                               msg_id: str) -> StreamResponse:
        response = await self._event_stream(request, preprocessed)
        await response.write(_sse_event("message_start", {
            "type": "message_start",
            "message": {"id": msg_id, "type": "message", "role": "assistant",
                        "model": preprocessed.model, "content": [],
                        "stop_reason": None, "stop_sequence": None,
                        "usage": {"input_tokens": len(preprocessed.token_ids),
                                  "output_tokens": 0}}}))
        await response.write(_sse_event("content_block_start", {
            "type": "content_block_start", "index": 0,
            "content_block": {"type": "text", "text": ""}}))

        def on_text(text: str) -> bytes:
            return _sse_event("content_block_delta", {
                "type": "content_block_delta", "index": 0,
                "delta": {"type": "text_delta", "text": text}})

        def on_done() -> list:
            stop_reason, stop_sequence = self._anthropic_stop(delta_gen)
            return [
                _sse_event("content_block_stop",
                           {"type": "content_block_stop", "index": 0}),
                _sse_event("message_delta", {
                    "type": "message_delta",
                    "delta": {"stop_reason": stop_reason,
                              "stop_sequence": stop_sequence},
                    "usage": {"output_tokens": delta_gen.completion_tokens}}),
                _sse_event("message_stop", {"type": "message_stop"})]

        def on_error(kind: str, message: str) -> bytes:
            return _sse_event("error", {"type": "error", "error": {
                "type": "timeout_error" if kind == "timeout" else "api_error",
                "message": message}})

        await self._drive_events(response, entry, preprocessed, delta_gen,
                                 on_text, on_done, on_error)
        return response

    # -- OpenAI Responses API ----------------------------------------------

    @staticmethod
    def _responses_to_chat(body: dict) -> dict:
        """Lower a Responses API request onto the chat pipeline."""
        raw = body.get("input")
        if raw is None:
            raise RequestError("'input' is required")
        messages = []
        instructions = body.get("instructions")
        if instructions:
            messages.append({"role": "system", "content": instructions})
        if isinstance(raw, str):
            messages.append({"role": "user", "content": raw})
        elif isinstance(raw, list):
            for item in raw:
                if not isinstance(item, dict):
                    raise RequestError("input items must be objects")
                content = item.get("content")
                if isinstance(content, list):
                    content = "".join(
                        b.get("text", "") for b in content
                        if isinstance(b, dict)
                        and b.get("type") in ("input_text", "output_text",
                                              "text"))
                messages.append({"role": item.get("role", "user"),
                                 "content": content or ""})
        else:
            raise RequestError("'input' must be a string or message list")
        chat = {
            "model": body.get("model", ""),
            "messages": messages,
            "max_tokens": body.get("max_output_tokens"),
            "temperature": body.get("temperature", 1.0),
            "top_p": body.get("top_p", 1.0),
        }
        for key in ("priority", "tenant"):
            if body.get(key):
                chat[key] = body[key]
        return chat

    @staticmethod
    def _responses_body(resp_id: str, model: str, delta_gen: DeltaGenerator,
                        status: str) -> dict:
        prompt = len(delta_gen.request.token_ids)
        return {
            "id": resp_id,
            "object": "response",
            "created_at": now_unix(),
            "status": status,
            "model": model,
            "output": [{
                "type": "message",
                "id": f"msg_{uuid.uuid4().hex[:24]}",
                "status": status,
                "role": "assistant",
                "content": [{"type": "output_text",
                             "text": delta_gen.full_text,
                             "annotations": []}],
            }],
            "usage": {"input_tokens": prompt,
                      "output_tokens": delta_gen.completion_tokens,
                      "total_tokens": prompt + delta_gen.completion_tokens},
        }

    async def _responses(self, request: Request):
        front = self._lowered_chat(request, self._responses_to_chat,
                                   "responses")
        if isinstance(front, Response):
            return front
        entry, preprocessed, body = front
        delta_gen = DeltaGenerator(entry.preprocessor, preprocessed,
                                   kind="chat")
        resp_id = f"resp_{uuid.uuid4().hex[:24]}"
        if body.get("stream", False):
            respond = self._responses_stream(request, entry, preprocessed,
                                             delta_gen, resp_id)
        else:
            respond = self._responses_aggregate(entry, preprocessed,
                                                delta_gen, resp_id)
        return await self._finish_guard(preprocessed.request_id, respond)

    async def _responses_aggregate(self, entry: ModelEntry,
                                   preprocessed: PreprocessedRequest,
                                   delta_gen: DeltaGenerator,
                                   resp_id: str) -> Response:
        start = time.monotonic()
        status = "error"
        try:
            err = await self._consume(entry, preprocessed, delta_gen)
            if err is not None:
                return err
            status = "ok"
        finally:
            self._count_request(preprocessed.model, status, start,
                                preprocessed.request_id)
        return json_response(self._responses_body(
            resp_id, preprocessed.model, delta_gen, "completed"))

    async def _responses_stream(self, request: Request, entry: ModelEntry,
                                preprocessed: PreprocessedRequest,
                                delta_gen: DeltaGenerator,
                                resp_id: str) -> StreamResponse:
        response = await self._event_stream(request, preprocessed)
        model = preprocessed.model
        await response.write(_sse_event("response.created", {
            "type": "response.created",
            "response": self._responses_body(resp_id, model, delta_gen,
                                             "in_progress")}))

        def on_text(text: str) -> bytes:
            return _sse_event("response.output_text.delta", {
                "type": "response.output_text.delta", "delta": text})

        def on_done() -> list:
            return [
                _sse_event("response.output_text.done", {
                    "type": "response.output_text.done",
                    "text": delta_gen.full_text}),
                _sse_event("response.completed", {
                    "type": "response.completed",
                    "response": self._responses_body(
                        resp_id, model, delta_gen, "completed")})]

        def on_error(kind: str, message: str) -> bytes:
            data = {"type": "error", "message": message}
            if kind == "timeout":
                data["code"] = "deadline_exceeded"
            return _sse_event("error", data)

        await self._drive_events(response, entry, preprocessed, delta_gen,
                                 on_text, on_done, on_error)
        return response

    # -- admin and docs routes (ref: busy_threshold.rs, clear_kv_blocks.rs,
    # service_v2.rs /openapi.json + /docs) --------------------------------

    async def _busy_threshold_list(self, _request: Request) -> Response:
        return json_response({"thresholds": [
            {"model": m, "active_decode_blocks_threshold": v}
            for m, v in sorted(self.busy_thresholds.items())]})

    async def _busy_threshold_post(self, request: Request) -> Response:
        """Get or set a model's busy threshold: a body with a threshold
        sets it, one with only the model name reads it back (the
        reference's get-or-set POST)."""
        body = _parse_body(request)
        model = body.get("model")
        if not isinstance(model, str) or not model:
            return _bad_request("'model' is required")
        entry, _ = self.manager.resolve(model)
        if entry is None:
            return json_response(
                _error_body(404, f"model '{model}' not found",
                            "model_not_found"), status=404)
        name = entry.card.name
        value = body.get("active_decode_blocks_threshold",
                         body.get("busy_threshold"))
        if value is not None:
            try:
                value = float(value)
            except (TypeError, ValueError):
                return _bad_request("active_decode_blocks_threshold must be "
                                    "a number in [0, 1]")
            if not 0.0 <= value <= 1.0:
                return _bad_request(
                    "active_decode_blocks_threshold must be in [0, 1]")
            self.busy_thresholds[name] = value
        return json_response(
            {"model": name, "active_decode_blocks_threshold":
             self.busy_thresholds.get(name, self.busy_threshold)})

    async def _clear_kv_blocks(self, _request: Request) -> Response:
        """Fan out to every worker group's clear_kv_blocks endpoint, one
        record per instance (ref: clear_kv_blocks.rs)."""
        entries = self.manager.entries()
        if not entries:
            return json_response({"message": "No active worker groups found"})
        if self.runtime is None:
            return json_response(
                {"message": "Failed to create distributed runtime"})
        cleared, failed = [], []
        seen: set[tuple[str, str]] = set()
        for entry in entries:
            card = entry.card
            key = (card.namespace, card.component)
            if key in seen:  # models of one worker group share it
                continue
            seen.add(key)
            endpoint = f"{card.namespace}/{card.component}/clear_kv_blocks"
            client = None
            try:
                client = (self.runtime.namespace(card.namespace)
                          .component(card.component)
                          .endpoint("clear_kv_blocks").client())
                await client.start()
                for iid in list(client.instance_ids()) or [None]:
                    rec = {"name": card.name, "endpoint": endpoint,
                           "instance": iid}
                    try:
                        if iid is None:
                            raise RuntimeError("no live instances")
                        async with contextlib.aclosing(
                                client.direct({}, iid)) as stream:
                            async for resp in stream:
                                rec["response"] = resp
                                break
                        rec["status"] = "cleared"
                        cleared.append(rec)
                    except Exception as exc:  # noqa: BLE001 — reported
                        rec["status"] = "failed"
                        rec["error"] = str(exc)
                        failed.append(rec)
            except Exception as exc:  # noqa: BLE001 — reported per group
                failed.append({"name": card.name, "endpoint": endpoint,
                               "status": "failed", "error": str(exc)})
            finally:
                # the per-request client's discovery watch ends here
                if client is not None:
                    try:
                        await client.close()
                    except Exception:  # noqa: BLE001 — best effort
                        log.exception("clear_kv client close failed")
        return json_response({"cleared_workers": cleared,
                              "failed_workers": failed})

    def _route_table(self) -> list[tuple[str, str, str, str]]:
        """ROUTES less the opt-in /debug/* routes when they are off: what
        is registered, and so what /openapi.json and /docs advertise."""
        debug = bool(env("DYNT_DEBUG_ENDPOINTS"))
        return [r for r in ROUTES
                if debug or not r[1].startswith("/debug/")]

    async def _openapi(self, _request: Request) -> Response:
        paths: dict[str, dict] = {}
        for method, path, summary, _ in self._route_table():
            paths.setdefault(path, {})[method] = {
                "summary": summary,
                "responses": {"200": {"description": "OK"}}}
        return json_response({
            "openapi": "3.0.3",
            "info": {"title": "dynamo_tpu frontend", "version": "1.0.0"},
            "paths": paths})

    async def _docs(self, _request: Request) -> Response:
        rows = "".join(
            f"<tr><td><code>{m.upper()}</code></td>"
            f"<td><code>{p}</code></td><td>{s}</td></tr>"
            for m, p, s, _ in self._route_table())
        page = (
            "<!doctype html><html><head><title>dynamo_tpu API</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
            "padding:4px 10px;text-align:left}</style></head><body>"
            "<h1>dynamo_tpu frontend API</h1>"
            "<p>Machine-readable spec: <a href='/openapi.json'>"
            "/openapi.json</a></p>"
            "<table><tr><th>Method</th><th>Path</th><th>Summary</th></tr>"
            f"{rows}</table></body></html>")
        return Response(page, content_type="text/html; charset=utf-8")

    async def _debug_requests(self, request: Request) -> Response:
        return debug_requests_response(request)

    async def _debug_profile(self, request: Request) -> Response:
        return await profile_response(request)

    async def start(self) -> None:
        routes = {(method.upper(), path): getattr(self, handler)
                  for method, path, _, handler in self._route_table()}
        self._server = HttpServer(routes, self.host, self.port)
        await self._server.start()
        self.port = self._server.port
        log.info("OpenAI frontend listening on %s:%d", self.host, self.port)

    async def close(self) -> None:
        if self._server is not None:
            await self._server.close()
            self._server = None


# (method, path, summary, handler): the routes the service registers and
# documents (ref: RouteDoc in service_v2.rs). /debug/* leaks cross-request
# timelines, so it is registered only under DYNT_DEBUG_ENDPOINTS; images and
# videos are not ported and are not registered.
ROUTES = (
    ("post", "/v1/chat/completions",
     "OpenAI chat completions (SSE streaming + aggregate)", "_chat"),
    ("post", "/v1/completions", "OpenAI text completions", "_completions"),
    ("post", "/v1/embeddings", "OpenAI embeddings", "_embeddings"),
    ("post", "/v1/messages", "Anthropic messages", "_messages"),
    ("post", "/v1/responses", "OpenAI responses", "_responses"),
    ("get", "/v1/models", "List served models, adapters, and pools",
     "_models"),
    ("get", "/health", "Service health + served model list", "_health"),
    ("get", "/live", "Liveness probe", "_health"),
    ("get", "/metrics",
     "Prometheus metrics (OpenMetrics + exemplars via Accept)", "_metrics"),
    ("get", "/debug/requests",
     "Flight recorder: inflight + recent request timelines",
     "_debug_requests"),
    ("get", "/debug/profile",
     "On-demand profiler capture (?duration_ms=); returns the trace "
     "artifact path", "_debug_profile"),
    ("get", "/busy_threshold", "List per-model busy thresholds",
     "_busy_threshold_list"),
    ("post", "/busy_threshold",
     "Get or set a model's busy threshold (load shedding)",
     "_busy_threshold_post"),
    ("post", "/clear_kv_blocks", "Clear every worker's KV prefix cache",
     "_clear_kv_blocks"),
    ("get", "/openapi.json", "This OpenAPI document", "_openapi"),
    ("get", "/docs", "Human-readable API index", "_docs"),
)
