"""Per-request flight recorder: a bounded ring of request timelines.

Port of `dynamo_tpu/runtime/flight_recorder.py`. When a request burns its
deadline budget, metrics say *that* it was slow; this recorder answers
*where the time went* from inside the process. Every component stamps
coarse phases on a shared timeline (received -> queued -> scheduled ->
prefill_start -> first_token -> finished) keyed by request id, and appends
structured events for the detours (retries, migrations, KV pulls with the
link they took, drain rungs):

  * `/debug/requests` (the status server, and the frontend with
    DYNT_DEBUG_ENDPOINTS) returns the inflight timelines plus the last
    DYNT_FLIGHT_RECORDER_SIZE completed ones;
  * a request that finishes in a non-ok state is dumped to the log;
  * DYNT_SLOW_TRACE_MS force-samples slow successful requests the same way.

Stamps are first-write-wins (phases are facts, not counters) and the whole
structure is thread-safe: the engine scheduler stamps from its own thread
while the asyncio side reads snapshots. Request ids default to the
`current_request_id` contextvar, so most call sites stamp with no plumbing.
Accepted stamps and the finish replay against the `flight_recorder` spec
(`runtime/conformance.py`) when DYNT_CONFORMANCE is on.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
import json
import logging
import threading
import time
from typing import Optional

from ..config import env
from . import conformance

log = logging.getLogger("dynamo_tpu_torch.flight_recorder")

# The request being served in this task (set by the frontend and the
# worker's generate); stamps and events with no request id resolve to it.
current_request_id: contextvars.ContextVar[Optional[str]] = (
    contextvars.ContextVar("dynt_request_id", default=None))

# Canonical phase order. A timeline holds any subset: a prefill-only leg
# never decodes, a shed request never queues.
PHASES = ("received", "queued", "scheduled", "prefill_start",
          "first_token", "finished")

# Inflight entries older than this are presumed leaked (a peer that stamped
# but never finished) and retired, so the inflight map stays bounded.
STALE_INFLIGHT_SECS = 3600.0


@dataclasses.dataclass
class RequestTimeline:
    """One request's observed life inside this process."""

    request_id: str
    model: str = ""
    trace_id: str = ""
    tenant: str = ""
    started: float = dataclasses.field(default_factory=time.time)
    phases: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)
    # Device-time attribution (perf/steptrace.py): accumulated
    # "<phase>_device_ms" / "<phase>_host_ms" per engine phase, so the host
    # wall-clock phases above split into host and device burn.
    device: dict = dataclasses.field(default_factory=dict)
    status: Optional[str] = None  # None while inflight
    slow: bool = False

    def elapsed_ms(self) -> float:
        end = self.phases.get("finished", time.time())
        return max(0.0, (end - self.started) * 1e3)

    def to_json(self) -> dict:
        return {
            "request_id": self.request_id,
            "model": self.model,
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "status": self.status or "inflight",
            "slow": self.slow,
            "elapsed_ms": round(self.elapsed_ms(), 3),
            "phases": {k: round(v, 6) for k, v in self.phases.items()},
            "device": {k: round(v, 3) for k, v in self.device.items()},
            "events": list(self.events),
        }


class FlightRecorder:
    """Thread-safe inflight map + completed ring (capacity from
    DYNT_FLIGHT_RECORDER_SIZE when not given)."""

    def __init__(self, capacity: Optional[int] = None,
                 slow_ms: Optional[float] = None) -> None:
        if capacity is None:
            capacity = env("DYNT_FLIGHT_RECORDER_SIZE")
        self.slow_ms = (env("DYNT_SLOW_TRACE_MS") if slow_ms is None
                        else slow_ms)
        self._inflight: dict[str, RequestTimeline] = {}
        self._completed: collections.deque = collections.deque(
            maxlen=max(1, capacity))
        self._lock = threading.Lock()

    @staticmethod
    def _resolve(request_id: Optional[str]) -> Optional[str]:
        return request_id if request_id else current_request_id.get()

    # -- producer side ------------------------------------------------------

    def start(self, request_id: str, model: str = "", trace_id: str = "",
              tenant: str = "", received: Optional[float] = None) -> None:
        """Open (or enrich) a timeline. Idempotent: the first opener sets
        `received`; later openers only fill in missing identity fields, so
        a frontend and a worker in one process can both call it.
        `received` backdates the timeline to the true arrival time."""
        with self._lock:
            tl = self._inflight.get(request_id)
            if tl is None:
                tl = RequestTimeline(request_id, model=model,
                                     trace_id=trace_id, tenant=tenant)
                if received is not None:
                    tl.started = received
                tl.phases["received"] = tl.started
                self._inflight[request_id] = tl
                self._evict_stale_locked()
                return
            if model and not tl.model:
                tl.model = model
            if trace_id and not tl.trace_id:
                tl.trace_id = trace_id
            if tenant and not tl.tenant:
                tl.tenant = tenant

    def stamp(self, request_id: Optional[str], phase: str,
              ts: Optional[float] = None) -> None:
        """Record a phase timestamp (first write wins). A no-op for unknown
        requests: canaries and bare-scheduler callers never pollute."""
        rid = self._resolve(request_id)
        if rid is None:
            return
        with self._lock:
            tl = self._inflight.get(rid)
            if tl is not None and phase not in tl.phases:
                tl.phases[phase] = time.time() if ts is None else ts
                if phase != "received":
                    # Accepted first-write stamps replay against the phase
                    # machine ("received" is its initial state, not an
                    # event), under the lock, so in acceptance order.
                    conformance.observe("flight_recorder", rid, phase)

    def device(self, request_id: Optional[str], phase: str,
               device_ms: float = 0.0, host_ms: float = 0.0) -> None:
        """Accumulate device / host burn for an engine phase ("prefill" /
        "decode") onto the timeline. A no-op for unknown requests."""
        rid = self._resolve(request_id)
        if rid is None:
            return
        with self._lock:
            tl = self._inflight.get(rid)
            if tl is None:
                return
            if device_ms:
                key = f"{phase}_device_ms"
                tl.device[key] = tl.device.get(key, 0.0) + device_ms
            if host_ms:
                key = f"{phase}_host_ms"
                tl.device[key] = tl.device.get(key, 0.0) + host_ms

    def event(self, request_id: Optional[str], name: str, **attrs) -> None:
        """Append a structured event (retry, migration, kv_pull, ...)."""
        rid = self._resolve(request_id)
        if rid is None:
            return
        with self._lock:
            tl = self._inflight.get(rid)
            if tl is not None:
                tl.events.append({"ts": round(time.time(), 6),
                                  "event": name, **attrs})

    def finish(self, request_id: Optional[str],
               status: str = "ok") -> Optional[RequestTimeline]:
        """Close a timeline and move it to the completed ring. The first
        call wins; the log dump fires for every status but ok, cancelled
        and shed, and, with DYNT_SLOW_TRACE_MS set, for slow successes."""
        rid = self._resolve(request_id)
        if rid is None:
            return None
        with self._lock:
            tl = self._inflight.pop(rid, None)
            if tl is None:
                return None
            tl.status = status
            tl.phases.setdefault("finished", time.time())
            tl.slow = bool(self.slow_ms) and tl.elapsed_ms() >= self.slow_ms
            self._completed.append(tl)
            conformance.observe("flight_recorder", rid, "finished")
        if status not in ("ok", "cancelled", "shed"):
            # Errors and deadline overruns dump; a client cancel is normal
            # teardown and a shed is deliberate degradation (dumping each
            # would storm the log exactly when the system is overloaded).
            log.warning("flight record (%s): %s", status,
                        json.dumps(tl.to_json()))
        elif tl.slow:
            log.warning("flight record (slow: %.0fms >= %.0fms): %s",
                        tl.elapsed_ms(), self.slow_ms,
                        json.dumps(tl.to_json()))
        return tl

    def _evict_stale_locked(self) -> None:
        now = time.time()
        stale = [rid for rid, tl in self._inflight.items()
                 if now - tl.started > STALE_INFLIGHT_SECS]
        for rid in stale:
            tl = self._inflight.pop(rid)
            tl.status = "stale"
            tl.phases.setdefault("finished", now)
            self._completed.append(tl)

    # -- consumer side ------------------------------------------------------

    def get(self, request_id: str) -> Optional[RequestTimeline]:
        """The inflight entry (a shallow copy taken under the lock: the
        scheduler thread keeps stamping the original), or the most recent
        completed one by that id (immutable after finish)."""
        with self._lock:
            tl = self._inflight.get(request_id)
            if tl is not None:
                return dataclasses.replace(tl, phases=dict(tl.phases),
                                           device=dict(tl.device),
                                           events=list(tl.events))
            for done in reversed(self._completed):
                if done.request_id == request_id:
                    return done
        return None

    def snapshot(self) -> dict:
        """The JSON shape served at /debug/requests: inflight first, then
        completed newest first. Serialized outside the lock, so a stamp
        from the engine thread never waits out a debug scrape."""
        with self._lock:
            inflight = [dataclasses.replace(tl, phases=dict(tl.phases),
                                            device=dict(tl.device),
                                            events=list(tl.events))
                        for tl in self._inflight.values()]
            completed = list(reversed(self._completed))
        return {
            "inflight": [tl.to_json() for tl in inflight],
            "completed": [tl.to_json() for tl in completed],
        }


_GLOBAL: Optional[FlightRecorder] = None
_GLOBAL_LOCK = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process-wide recorder (always on: a fixed-size ring whose
    hot-path cost is a dict write under an uncontended lock)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = FlightRecorder()
        return _GLOBAL


def reset_recorder() -> None:
    """Drop the process-wide recorder, so env changes take effect."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = None
