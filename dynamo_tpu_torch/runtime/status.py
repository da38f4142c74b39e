"""System status server: /health, /live, /metrics, /debug/requests and
/debug/profile.

Port of `SystemStatusServer` in `dynamo_tpu/runtime/status.py` (ref:
lib/runtime/src/system_status_server.rs:131-178), on this package's HTTP
server (runtime/http.py). Every runtime process exposes liveness, endpoint
health, its Prometheus metrics and its flight-recorder timelines here.
/health answers 503 when any served endpoint is unhealthy: shutting down, or
failing its canaries (runtime/health_check.py). /debug/requests returns the
request timelines (runtime/flight_recorder.py), filtered by
?status=&tenant=&model=&slow= and paged by ?limit=&offset=. /debug/profile
runs one `torch.profiler` capture (CPU and, on a card, CUDA activities, every
thread) in THIS process for ?duration_ms= (DYNT_PROF_DEFAULT_MS, at most
DYNT_PROF_MAX_MS) and writes a Chrome trace under DYNT_PROF_DIR; the engine's
dispatch scopes name the decode, prefill and spec phases in it
(perf/steptrace.py). A worker registers its graceful drain
(`register_drain`); `POST /drain` runs it and answers its report, and is
mounted only while DYNT_DRAIN_HTTP is on (the verb is unauthenticated and
terminal). Not ported yet: /fleet, /debug/alerts and OpenMetrics
negotiation.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import threading
import time
import uuid
from typing import Awaitable, Callable, Optional

from ..config import env
from ..perf.steptrace import LAUNCH_GATE
from . import metrics
from .flight_recorder import get_recorder
from .http import HttpServer, Request, Response, json_response

# One capture at a time per process: a second profiler session would
# interleave two operators' captures.
_PROFILE_LOCK = threading.Lock()
# Every capture's start, stop and export run on ONE long-lived thread, made
# at the first capture: the profiler's backend (Kineto) registers with the
# thread that first starts it, and a fresh thread per capture would start it
# from a thread it never saw.
_PROFILER_THREAD: list = []


def _profiler_executor() -> concurrent.futures.ThreadPoolExecutor:
    if not _PROFILER_THREAD:
        _PROFILER_THREAD.append(concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dynt-profiler"))
    return _PROFILER_THREAD[0]


def metrics_response(_request: Request) -> Response:
    """Shared /metrics responder (status server + frontend)."""
    return Response(metrics.render(), content_type=metrics.CONTENT_TYPE)


def _profiler_activities() -> list:
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def _capture(path: str, seconds: float) -> dict:
    """One profiler session of `seconds`, its Chrome trace written to
    `path`. Start, stop and export run on the calling thread (the profiler
    thread); every thread's scopes are recorded (the engine's run on its
    scheduler threads). Start and stop hold the launch gate
    (perf/steptrace.py), so no step graph replays while they run. Returns
    the seconds the profiler took to start, stop and export."""
    import torch

    try:
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:  # an older torch: the starting thread only
        config = None
    prof = torch.profiler.profile(activities=_profiler_activities(),
                                  experimental_config=config)
    t0 = time.monotonic()
    with LAUNCH_GATE.exclusive():  # no step graph launches meanwhile
        prof.start()
    t1 = time.monotonic()
    try:
        time.sleep(seconds)
    finally:
        t2 = time.monotonic()
        with LAUNCH_GATE.exclusive():
            prof.stop()
    t3 = time.monotonic()
    prof.export_chrome_trace(path)
    return {"start_s": t1 - t0, "stop_s": t3 - t2,
            "export_s": time.monotonic() - t3}


async def profile_response(request: Request) -> Response:
    """Shared /debug/profile responder: a `torch.profiler` capture for
    ?duration_ms= (default DYNT_PROF_DEFAULT_MS, clamped to
    DYNT_PROF_MAX_MS), answered with the capture's directory and files. 409
    while another capture runs; 503 when the profiler cannot start."""
    try:
        duration = float(request.query.get(
            "duration_ms", env("DYNT_PROF_DEFAULT_MS")))
    except ValueError:
        return json_response({"error": "duration_ms must be a number"},
                             status=400)
    duration = max(1.0, min(duration, float(env("DYNT_PROF_MAX_MS"))))
    if not _PROFILE_LOCK.acquire(blocking=False):
        return json_response(
            {"error": "a profile capture is already running"}, status=409)
    try:
        # unique per capture: sub-second repeats must not share a directory
        trace_dir = os.path.join(
            env("DYNT_PROF_DIR"),
            time.strftime("%Y%m%d-%H%M%S") + f"-{uuid.uuid4().hex[:6]}")
        os.makedirs(trace_dir, exist_ok=True)
        try:
            # off the event loop: token streams and /health live on it
            took = await asyncio.wrap_future(_profiler_executor().submit(
                _capture, os.path.join(trace_dir, "trace.json"),
                duration / 1e3))
        except Exception as exc:  # noqa: BLE001 — the profiler refused
            return json_response({"error": f"capture failed: {exc!r}",
                                  "trace_dir": trace_dir}, status=503)
        return json_response({"trace_dir": trace_dir,
                              "duration_ms": duration,
                              "files": sorted(os.listdir(trace_dir)),
                              **took})
    finally:
        _PROFILE_LOCK.release()


def _timeline_matches(timeline: dict, status: str, tenant: str, model: str,
                      slow: str) -> bool:
    if status and timeline.get("status") != status:
        return False
    if tenant and timeline.get("tenant") != tenant:
        return False
    if model and timeline.get("model") != model:
        return False
    if slow and not timeline.get("slow"):
        return False
    return True


def debug_requests_response(request: Request) -> Response:
    """Shared /debug/requests responder: the flight recorder's inflight and
    recently completed timelines, filtered by ?status=&tenant=&model=&slow=
    and paged by ?limit=&offset= (each list in the recorder's order,
    completed newest first, after filtering). The totals before paging come
    with them."""
    query = request.query
    try:
        limit = int(query.get("limit", 0))
        offset = int(query.get("offset", 0))
    except ValueError:
        return json_response({"error": "limit/offset must be integers"},
                             status=400)
    snapshot = get_recorder().snapshot()
    out: dict = {}
    for section in ("inflight", "completed"):
        rows = [t for t in snapshot.get(section, [])
                if _timeline_matches(t, query.get("status", ""),
                                     query.get("tenant", ""),
                                     query.get("model", ""),
                                     query.get("slow", ""))]
        out[f"total_{section}"] = len(rows)
        if offset:
            rows = rows[offset:]
        if limit > 0:
            rows = rows[:limit]
        out[section] = rows
    return json_response(out)


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

    async def _debug_requests(self, request: Request) -> Response:
        return debug_requests_response(request)

    async def _debug_profile(self, request: Request) -> Response:
        return await profile_response(request)

    def register_drain(self, fn: Callable[[], Awaitable[dict]]) -> None:
        """fn runs the component's graceful drain (idempotent: a second POST
        while draining awaits the first) and returns its report. One slot:
        the last registration wins, so a main hosting several drainable
        workers (the comesh pair) registers one composed drainer."""
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
            ("GET", "/debug/requests"): self._debug_requests,
            ("GET", "/debug/profile"): self._debug_profile,
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
