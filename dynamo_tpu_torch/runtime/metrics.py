"""Prometheus metrics with the reference's hierarchical label scheme.

Port of the part of `dynamo_tpu/runtime/metrics.py` that the frontend and
the served endpoints record, without `prometheus_client`: a small
per-process registry of Counter, Gauge and Histogram families with labels,
rendered in the Prometheus text exposition format (version 0.0.4). Names,
help strings, label sets and histogram buckets are the reference's.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Iterable, Optional

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if value != value:
        return "NaN"
    return repr(float(value))


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _label_text(names: tuple, values: tuple, extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Family:
    kind = ""

    def __init__(self, name: str, doc: str, labelnames: Iterable[str] = (),
                 registry: Optional["Registry"] = None) -> None:
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._new_child()
        (registry or REGISTRY).register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values: str, **kwargs: str):
        if kwargs:
            if values or set(kwargs) != set(self.labelnames):
                raise ValueError(f"{self.name}: labels {self.labelnames}")
            values = tuple(kwargs[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: labels {self.labelnames}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def remove(self, *values: str) -> None:
        """Drop one labelled series (KeyError when it does not exist)."""
        key = tuple(str(v) for v in values)
        with self._lock:
            del self._children[key]

    def _items(self) -> list:
        with self._lock:
            return sorted(self._children.items())

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.doc}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, child in self._items():
            lines.extend(child.samples(self.name, self.labelnames, key))
        return lines


class _Value:
    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def get(self) -> float:
        return self._value

    def samples(self, name: str, names: tuple, values: tuple) -> list[str]:
        return [f"{name}{_label_text(names, values)} {_fmt(self._value)}"]


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount


class _GaugeChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class _HistogramChild:
    def __init__(self, buckets: tuple) -> None:
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self._buckets):
                if value <= bound:
                    self._counts[i] += 1
                    break

    def samples(self, name: str, names: tuple, values: tuple) -> list[str]:
        with self._lock:
            counts, total, count = list(self._counts), self._sum, self._count
        out, running = [], 0
        for bound, n in zip(self._buckets, counts):
            running += n
            le = f'le="{_fmt(bound)}"'
            out.append(f"{name}_bucket{_label_text(names, values, le)} "
                       f"{_fmt(running)}")
        labels = _label_text(names, values)
        out.append(f"{name}_count{labels} {_fmt(count)}")
        out.append(f"{name}_sum{labels} {_fmt(total)}")
        return out


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, doc: str, labelnames: Iterable[str] = (),
                 registry: Optional["Registry"] = None,
                 buckets: tuple = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                                   1.0, 2.5, 5.0, 10.0)) -> None:
        buckets = tuple(float(b) for b in buckets)
        if buckets[-1] != math.inf:
            buckets += (math.inf,)
        self.buckets = buckets
        super().__init__(name, doc, labelnames, registry)

    def _new_child(self):
        return _HistogramChild(self.buckets)


class Registry:
    def __init__(self) -> None:
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def register(self, family: _Family) -> None:
        with self._lock:
            if family.name in self._families:
                raise ValueError(f"duplicate metric {family.name}")
            self._families[family.name] = family

    def render(self) -> bytes:
        with self._lock:
            families = list(self._families.values())
        lines: list[str] = []
        for family in families:
            lines.extend(family.render())
        return ("\n".join(lines) + "\n").encode()


# One registry per process — mirrors the reference's DRT-rooted hierarchy.
REGISTRY = Registry()

_HIER = ["namespace", "component", "endpoint"]

REQUESTS_TOTAL = Counter(
    "dynamo_requests_total", "Requests handled", _HIER + ["status"])
REQUEST_DURATION = Histogram(
    "dynamo_request_duration_seconds", "End-to-end request duration", _HIER,
    buckets=(0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0))
INFLIGHT = Gauge("dynamo_inflight_requests", "In-flight requests", _HIER)
REQUESTS_SHED = Counter(
    "dynamo_requests_shed_total",
    "Requests shed at admission with 503, by reason", ["reason"])
# Resilience (runtime/resilience.py, runtime/push_router.py)
RETRIES_TOTAL = Counter(
    "dynamo_retries_total", "Request-plane retry attempts by outcome "
    "(allowed = dispatched, denied = retry budget exhausted)",
    ["endpoint", "outcome"])
RETRY_BUDGET_BALANCE = Gauge(
    "dynamo_retry_budget_balance", "Retry-budget tokens currently available",
    ["endpoint"])
BREAKER_STATE = Gauge(
    "dynamo_circuit_breaker_state",
    "Circuit breaker state per instance (0=closed 1=open 2=half_open)",
    ["endpoint", "instance"])
BREAKER_TRANSITIONS = Counter(
    "dynamo_circuit_breaker_transitions_total",
    "Circuit breaker state transitions, by state entered",
    ["endpoint", "state"])
DEADLINE_EXCEEDED = Counter(
    "dynamo_deadline_exceeded_total",
    "Requests whose end-to-end deadline budget expired, by component",
    ["component"])
# Deadline-aware admission (runtime/admission.py)
ADMISSION_WAIT_MS = Gauge(
    "dynamo_admission_queue_wait_ms",
    "Estimated queue wait (ms) at an admission edge's last decision, "
    "per pool (inf collapses to the Retry-After cap)",
    ["pool"])
TENANT_SHED = Counter(
    "dynamo_tenant_shed_total",
    "Requests shed at an admission edge attributed to a tenant, by "
    "reason: quota (over weighted fair share under contention) or "
    "queue (deadline-aware admission). Untagged requests count under "
    "tenant=untagged only when quota-shed",
    ["tenant", "reason"])
# Priority classes (engine/scheduler.py): batch decode slots preempted under
# interactive pressure, and parked sequences resumed
PREEMPT_TOTAL = Counter(
    "dynamo_preempt_total",
    "Scheduler preemption events, by kind: park (batch decode slot "
    "offloaded to the KVBM park store under interactive pressure), "
    "migrate (cooperative preempt-and-migrate fallback: the worker "
    "emitted finish_reason=migrate), resume (parked sequence restored "
    "and decoding again)",
    ["kind"])
# Runtime protocol conformance (runtime/conformance.py): observed lifecycle
# events the protocol specs forbid. DS101 = no transition for the event in
# the current state, DS201 = an event after a terminal state.
PROTOCOL_VIOLATIONS = Counter(
    "dynamo_protocol_violations_total",
    "Observed lifecycle events forbidden by the dynastate protocol "
    "specs, by protocol and rule (DS101 unhandled-event-in-state, "
    "DS201 post-terminal-event). Nonzero means a live code path "
    "diverged from the machine-checked protocol contract",
    ["protocol", "rule"])
# Graceful drain (engine/drain.py): how a departing worker vacated its
# live streams
DRAIN_STATE = Gauge(
    "dynamo_drain_state",
    "Worker drain state (0=serving 1=draining 2=drained)", ["worker"])
DRAIN_SEQUENCES = Counter(
    "dynamo_drain_sequences_total",
    "Live sequences vacated during graceful drains, by the ladder rung "
    "that moved them: handoff (KV-state handoff, peer resumes "
    "bit-identically), replay (cooperative replay-migrate, peer "
    "re-prefills), error (deadline expired — honest in-band error)",
    ["outcome"])
DRAIN_DURATION_MS = Gauge(
    "dynamo_drain_duration_ms",
    "Wall time of this worker's last graceful drain, start to "
    "deregistration-ready", ["worker"])
# KVBM offload (block_manager/offload.py): queue pressure and the
# bandwidth budget of the D2H offload path
KVBM_OFFLOAD_DROPPED = Counter(
    "dynamo_kvbm_offload_dropped_total",
    "Blocks dropped from the KVBM offload queue (store burst past "
    "DYNT_OFFLOAD_QUEUE_CAP; oldest first — offload is best-effort)")
KVBM_OFFLOAD_QUEUE_DEPTH = Gauge(
    "dynamo_kvbm_offload_queue_depth",
    "Blocks currently queued for KVBM D2H offload")
KVBM_OFFLOAD_DEFERRED = Counter(
    "dynamo_kvbm_offload_deferred_seconds_total",
    "Seconds the offload worker spent deferring device gathers to honor "
    "the DYNT_OFFLOAD_BW_FRAC bandwidth budget")
# Fast-start arrival plane (engine/coldstart.py, weights/striped.py): the
# cold-start ladder a joining worker walks (fetch -> load -> compile ->
# register -> first_token), and the striped peer weight stream behind its
# fetch rung
COLDSTART_PHASE_SECONDS = Gauge(
    "dynamo_coldstart_phase_seconds",
    "Seconds this worker's most recent cold start spent in each arrival-"
    "ladder phase (fetch / load / compile / register / first_token)",
    ["worker", "phase"])
COLDSTART_TOTAL_SECONDS = Gauge(
    "dynamo_coldstart_total_seconds",
    "Wall seconds of this worker's most recent cold start, process "
    "start to first served token — should sit inside "
    "DYNT_COLDSTART_BUDGET_SECS",
    ["worker"])
COLDSTART_ARRIVALS = Counter(
    "dynamo_coldstart_arrivals_total",
    "Completed cold starts, by the weight source the arrival ladder "
    "resolved (peer_striped / peer / service / object_store / "
    "checkpoint / init / mock)",
    ["source"])
COLDSTART_LEAD_SECONDS = Gauge(
    "dynamo_coldstart_lead_seconds",
    "Cold-start lead time the planner used in its most recent scale-up "
    "decision (the measured arrival-ladder total it projects demand "
    "ahead by)")
WEIGHT_STREAM_CHUNKS = Counter(
    "dynamo_weight_stream_chunks_total",
    "Striped weight-stream chunks, by outcome: served (donor side), "
    "verified (puller digest ok), digest_mismatch (corrupt chunk "
    "rejected — re-fetched from another donor, never served), "
    "restriped (re-assigned after a donor died mid-stream)",
    ["outcome"])
WEIGHT_STREAM_DEFERRED = Counter(
    "dynamo_weight_stream_deferred_seconds_total",
    "Seconds weight-stream donors spent deferring param gathers to "
    "honor the DYNT_WEIGHT_STREAM_BW_FRAC bandwidth budget (the KVBM "
    "offload pacing, applied to the arrival plane)")
# Disaggregated prefill (engine/worker.py): KV pages streamed to the decode
# pool while the prefill pass was still computing
DISAGG_STREAMED_PAGES = Counter(
    "dynamo_disagg_streamed_pages_total",
    "KV pages parked for transfer before their prompt finished "
    "prefilling (chunked disagg handoff; serial handoffs count 0 here)",
    ["worker"])
# Device-time attribution (perf/steptrace.py): every scheduler step split
# into host and device burn, the per-request device-time TTFT, and the live
# roofline comparison against the analytical model (profiler/timing_model.py)
STEP_DEVICE_MS = Histogram(
    "dynamo_step_device_ms",
    "Per-step device window (dispatch submitted -> drain complete) in "
    "ms, by engine phase (decode / prefill / spec)",
    ["phase"],
    buckets=(0.05, 0.2, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
             500.0, 2000.0))
STEP_HOST_MS = Histogram(
    "dynamo_step_host_ms",
    "Per-step host residual (wall - device window) in ms, labelled by "
    "the step's dominant device phase ('host' = no device work)",
    ["phase"],
    buckets=(0.05, 0.2, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
             500.0, 2000.0))
TTFT_DEVICE_MS = Histogram(
    "dynamo_ttft_device_ms",
    "Device-stream burn (ms) of the prefill phase behind each first "
    "token \u2014 the device-time TTFT next to the host wall-clock "
    "dynamo_time_to_first_token_seconds",
    ["model"],
    buckets=(1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 200.0, 400.0,
             800.0, 1600.0, 3200.0, 6400.0, 12800.0))
MFU_GAUGE = Gauge(
    "dynamo_mfu",
    "Achieved fraction of peak matmul FLOPs over the last metrics "
    "interval (2 * params * tokens / device-time * peak), from the "
    "live step decomposition and the model geometry",
    ["worker"])
ROOFLINE_FRACTION = Gauge(
    "dynamo_roofline_fraction",
    "Ideal device time at the analytical roofline "
    "(profiler/timing_model.py) for the interval's executed steps, "
    "divided by the measured device time \u2014 1.0 means the engine runs "
    "at the hardware ceiling",
    ["worker"])
HOST_BOUND = Gauge(
    "dynamo_host_bound",
    "Host-bound verdict: 1 once the per-step host residual has "
    "exceeded the device window for 8 consecutive steps (scaling "
    "chips will not move this pool's latency), else 0",
    ["worker"])
# Frontend service metrics that feed the Planner (ref: http/service/metrics.rs
# TTFT/ITL histograms)
TTFT_SECONDS = Histogram(
    "dynamo_time_to_first_token_seconds", "Time to first token", ["model"],
    buckets=(0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4, 12.8))
ITL_SECONDS = Histogram(
    "dynamo_inter_token_latency_seconds", "Inter-token latency", ["model"],
    buckets=(0.002, 0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64))
INPUT_TOKENS = Histogram(
    "dynamo_input_sequence_tokens", "Input sequence length", ["model"],
    buckets=(32, 128, 512, 1024, 2048, 4096, 8192, 16384, 32768))
OUTPUT_TOKENS = Histogram(
    "dynamo_output_sequence_tokens", "Output sequence length", ["model"],
    buckets=(1, 16, 64, 128, 256, 512, 1024, 2048, 4096))


def render() -> bytes:
    return REGISTRY.render()


class EndpointMetrics:
    """Per-endpoint recording helper bound to hierarchy labels."""

    def __init__(self, namespace: str, component: str, endpoint: str) -> None:
        self._labels = dict(namespace=namespace, component=component,
                            endpoint=endpoint)

    def observe_request(self, start_monotonic: float, status: str) -> None:
        REQUESTS_TOTAL.labels(status=status, **self._labels).inc()
        REQUEST_DURATION.labels(**self._labels).observe(
            max(0.0, time.monotonic() - start_monotonic))


# Request-derived label values (tenant ids) are unbounded: the first
# _MAX_LABELS distinct values of a namespace keep their own series and the
# rest fold into "other" (the reference's metric_labels.bounded_label at its
# DYNT_METRIC_MAX_LABELS default).
_MAX_LABELS = 64
_admitted_labels: dict[str, set] = {}
_labels_lock = threading.Lock()


def bounded_label(namespace: str, value: str) -> str:
    if not value:
        return value
    with _labels_lock:
        seen = _admitted_labels.setdefault(namespace, set())
        if value in seen:
            return value
        if len(seen) < _MAX_LABELS:
            seen.add(value)
            return value
    return "other"
