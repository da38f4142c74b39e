"""Device-time attribution for the serving step loop.

Port of `dynamo_tpu/perf/steptrace.py`. Every latency number a host clock
gives is host wall time; this module splits each scheduler step into the
pieces the dispatch model has, with ZERO added device syncs:

  host-prep   step start -> first dispatch submit (admission, buffer fill,
              proposer mining)
  dispatch    host time spent inside runner submit calls (a CUDA-graph
              replay's launch, or an eager step's kernel launches)
  device      first dispatch submitted -> drain complete: the window the
              device (or its queue) owns the step; host overlap work
              (prefill prep, late admission, gap callbacks) runs inside it
  drain-wait  the blocking readback slice of the device window (host idle,
              waiting on results)

The invariant `host_ms + device_ms == wall_ms` holds per step by
construction (host is the residual of the measured device window), and
`prep + dispatch <= host + device` pins the measured sub-pieces.

Measurement contract: dispatch scopes stamp at submit start and end (the
`CUDAGraph.replay()` call, or the eager launches) and enter a
`torch.profiler.record_function` scope named after the phase, so an
on-demand `/debug/profile` capture attributes device work to decode,
prefill and spec (a no-op unless a profiler is active); drain scopes stamp
when the readback that already blocks completes. A phase's per-step device
window runs from ITS OWN submit end this step to its drain end: a readback
of work submitted last step (a deferred prefill token) contributes only
its blocked-wait slice, keeping every window inside the step wall.

`measure_device` times device work with the same zero-sync rule (CUDA
events around a run, one wait for its last result); `chip_smoke.py` times
the KV bridge's gather and scatter with it. `LiveRoofline` gives the live
MFU / roofline gauges from the analytical model's parameter and KV-byte
counts (`profiler/timing_model.py`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Iterator, Optional

import torch

from ..device import DeviceLike, resolve_device

PHASES = ("decode", "prefill", "spec")

# Consecutive steps host residual must exceed the device window before the
# verdict gauge flips host-bound (transients must not flap it).
HOST_BOUND_STEPS = 8


class LaunchGate:
    """Keeps CUDA-graph launches and the profiler's start and stop apart.

    On an H100 (torch 2.11, CUDA 12.8) a profiler stop that ran while a
    scheduler thread replayed a step graph left both threads waiting inside
    CUDA for good. Replays and captures enter `launch()`, shared:
    they never wait on each other, only on a start or stop in progress.
    The profiler's start and stop enter `exclusive()`: it waits for the
    launches under way, and launches wait for it, as long as it lasts."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._launching = 0
        self._held = False

    @contextlib.contextmanager
    def launch(self) -> Iterator[None]:
        with self._cond:
            while self._held:
                self._cond.wait()
            self._launching += 1
        try:
            yield
        finally:
            with self._cond:
                self._launching -= 1
                if not self._launching:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self) -> Iterator[None]:
        with self._cond:
            while self._held:
                self._cond.wait()
            self._held = True
            while self._launching:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._held = False
                self._cond.notify_all()


# The process's gate: every runner's step graphs and the /debug/profile
# capture (runtime/status.py) share it.
LAUNCH_GATE = LaunchGate()


def annotation(phase: str, step: Optional[int] = None):
    """A `torch.profiler.record_function` scope for one engine dispatch,
    named after its phase; it records nothing unless a profiler is
    active."""
    return torch.profiler.record_function(
        phase, None if step is None else f"step_num={step}")


def measure_device(fn: Callable[[], object], steps: int = 16,
                   trials: int = 3, device: DeviceLike = "cuda") -> dict:
    """The timing definition shared by kernel timing and the step
    decomposition: run `fn` `steps` times, wait for the LAST result only
    (the device queue serializes the rest), median over `trials`. On the
    card the time is CUDA events around the run; on the CPU (device="cpu")
    the host clock. Returns seconds per call."""
    dev = resolve_device(device)
    timed = []
    for _ in range(trials):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                fn()
            end.record()
            end.synchronize()
            timed.append(start.elapsed_time(end) / 1e3 / steps)
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            timed.append((time.perf_counter() - t0) / steps)
    return {"median_s": sorted(timed)[len(timed) // 2], "trials_s": timed}


@dataclasses.dataclass
class StepSample:
    """One committed step's decomposition (all milliseconds)."""

    wall_ms: float
    host_ms: float  # residual: wall - device (prep + dispatch + overlap)
    prep_ms: float  # measured: step start -> first submit
    dispatch_ms: float  # measured: host time inside submit calls
    device_ms: float  # measured: submit end -> drain complete, summed
    drain_ms: float  # measured: blocked readback slice of device_ms
    device_by_phase: dict = dataclasses.field(default_factory=dict)

    @property
    def kind(self) -> str:
        """Dominant phase label for per-phase metric families."""
        if not self.device_by_phase:
            return "host"
        return max(self.device_by_phase, key=self.device_by_phase.get)


class _DispatchScope:
    """Stamps submit start/end around one runner dispatch and enters the
    profiler scope. `submit_end` (monotonic seconds) is the per-request
    attribution anchor callers may keep."""

    def __init__(self, trace: "StepTrace", phase: str,
                 step: Optional[int]) -> None:
        self._trace = trace
        self._phase = phase
        self._ann = annotation(phase, step)
        self.submit_end = 0.0

    def __enter__(self) -> "_DispatchScope":
        t = self._trace._clock()
        if self._trace._first_submit is None:
            self._trace._first_submit = t
        self._start = t
        self._ann.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._ann.__exit__(exc_type, exc, tb)
        end = self._trace._clock()
        self.submit_end = end
        self._trace._dispatch_ms += (end - self._start) * 1e3
        self._trace._submit_end[self._phase] = end
        return False


class _DrainScope:
    """Stamps the blocking drain; on exit `device_ms` holds this step's
    device window for the phase (its submit end -> drain complete). A drain
    of work submitted in a PREVIOUS step must pass `anchored=False` and
    counts only its blocked wait: this step's submit stamp (if any) belongs
    to DIFFERENT in-flight work, and anchoring there would credit host
    overlap time as device."""

    def __init__(self, trace: "StepTrace", phase: str,
                 anchored: bool = True) -> None:
        self._trace = trace
        self._phase = phase
        self._anchored = anchored
        self.device_ms = 0.0

    def __enter__(self) -> "_DrainScope":
        self._start = self._trace._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = self._trace._clock()
        anchor = self._start
        if self._anchored:
            anchor = self._trace._submit_end.get(self._phase, self._start)
        self.device_ms = max(0.0, (end - anchor) * 1e3)
        self._trace._drain_ms += (end - self._start) * 1e3
        self._trace._device_by_phase[self._phase] = (
            self._trace._device_by_phase.get(self._phase, 0.0)
            + self.device_ms)
        return False


class _SyncScope:
    """Dispatch + execute + readback in ONE host call (a host-sampling
    decode step, a prefill chunk whose token is needed now): the whole
    duration is the device window (the host was blocked on the card for
    all of it)."""

    def __init__(self, trace: "StepTrace", phase: str,
                 step: Optional[int]) -> None:
        self._trace = trace
        self._phase = phase
        self._ann = annotation(phase, step)
        self.device_ms = 0.0

    def __enter__(self) -> "_SyncScope":
        t = self._trace._clock()
        if self._trace._first_submit is None:
            self._trace._first_submit = t
        self._start = t
        self._ann.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._ann.__exit__(exc_type, exc, tb)
        end = self._trace._clock()
        self.device_ms = (end - self._start) * 1e3
        self._trace._drain_ms += self.device_ms
        self._trace._device_by_phase[self._phase] = (
            self._trace._device_by_phase.get(self._phase, 0.0)
            + self.device_ms)
        return False


class StepTrace:
    """Per-scheduler step decomposition accumulator.

    Producer side (scheduler thread): begin() -> dispatch()/sync()/drain()
    scopes -> commit(wall_ms). Consumer side (the worker's metrics tick)
    reads totals and drain_samples() under the lock. The injectable clock
    keeps the unit tests deterministic."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 capacity: int = 1024) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque(
            maxlen=max(1, capacity))
        # cumulative totals (read cross-thread; float writes are atomic
        # enough under the GIL for gauges)
        self.steps = 0
        self.device_ms_total = 0.0
        self.host_ms_total = 0.0
        self.dispatch_ms_total = 0.0
        self.device_ms_by_phase: dict[str, float] = {}
        # persistence streak behind the host-bound verdict
        self._host_over_device = 0
        self.last: Optional[StepSample] = None
        self._reset_step()

    def _reset_step(self) -> None:
        self._first_submit: Optional[float] = None
        self._dispatch_ms = 0.0
        self._drain_ms = 0.0
        self._submit_end: dict[str, float] = {}
        self._device_by_phase: dict[str, float] = {}
        self._t0 = 0.0

    # -- producer (scheduler thread) ----------------------------------------

    def begin(self) -> None:
        self._reset_step()
        self._t0 = self._clock()

    def dispatch(self, phase: str,
                 step: Optional[int] = None) -> _DispatchScope:
        return _DispatchScope(self, phase, step)

    def drain(self, phase: str, anchored: bool = True) -> _DrainScope:
        return _DrainScope(self, phase, anchored)

    def sync(self, phase: str, step: Optional[int] = None) -> _SyncScope:
        return _SyncScope(self, phase, step)

    def commit(self, wall_ms: float) -> StepSample:
        """Close the step: device is the measured window sum (clamped to
        the wall: phase windows can overlap when a deferred prefill drain
        rides a decode block), host is the residual."""
        device = min(sum(self._device_by_phase.values()), wall_ms)
        prep = 0.0
        if self._first_submit is not None:
            prep = max(0.0, (self._first_submit - self._t0) * 1e3)
        sample = StepSample(
            wall_ms=wall_ms,
            host_ms=max(0.0, wall_ms - device),
            prep_ms=prep,
            dispatch_ms=self._dispatch_ms,
            device_ms=device,
            drain_ms=self._drain_ms,
            device_by_phase=dict(self._device_by_phase),
        )
        with self._lock:
            self._samples.append(sample)
            self.steps += 1
            self.device_ms_total += sample.device_ms
            self.host_ms_total += sample.host_ms
            self.dispatch_ms_total += sample.dispatch_ms
            for phase, ms in sample.device_by_phase.items():
                self.device_ms_by_phase[phase] = (
                    self.device_ms_by_phase.get(phase, 0.0) + ms)
            if sample.host_ms > sample.device_ms:
                self._host_over_device += 1
            else:
                self._host_over_device = 0
            self.last = sample
        return sample

    # -- consumer (metrics tick) ----------------------------------------------

    def drain_samples(self) -> list[StepSample]:
        """Committed samples since the previous call (bounded buffer: a
        stalled consumer loses the oldest steps, never memory)."""
        with self._lock:
            out = list(self._samples)
            self._samples.clear()
        return out

    @property
    def host_bound(self) -> bool:
        """True once the host residual has exceeded the device window for
        HOST_BOUND_STEPS consecutive committed steps: more devices will not
        move this pool's latency."""
        return self._host_over_device >= HOST_BOUND_STEPS


def detect_chip():
    """ChipSpec of the local card for the live roofline gauges; the cpu
    spec wherever detection fails (no card, an unknown one), so the gauges
    always publish something comparable."""
    from ..profiler.chips import CHIPS

    try:
        if not torch.cuda.is_available():
            return CHIPS["cpu"]
        name = torch.cuda.get_device_name().lower().replace(" ", "")
    except Exception:  # noqa: BLE001 — a broken CUDA install reads as no card
        return CHIPS["cpu"]
    if "h100" in name:
        return CHIPS["h100"]
    return CHIPS["cpu"]


class LiveRoofline:
    """Live MFU / roofline fraction from serving-interval deltas.

    Compares measured device time against the analytical roofline model
    (`profiler/timing_model.py`) for the work actually done:

      mfu               achieved fraction of peak matmul FLOPs
                        (2 * params * tokens / (device_s * peak))
      roofline_fraction ideal device time at the roofline for the
                        interval's steps / measured device time (prefill
                        compute-bound + decode memory-bound)
    """

    def __init__(self, model_config, num_chips: int = 1, chip=None,
                 weight_bytes_per_param: float = 2.0,
                 kv_dtype_bytes: int = 2) -> None:
        from ..profiler.timing_model import param_count

        self.model = model_config
        self.chip = chip if chip is not None else detect_chip()
        self.num_chips = max(1, num_chips)
        self.params = param_count(model_config)
        self.weight_bytes = self.params * weight_bytes_per_param
        self.kv_dtype_bytes = kv_dtype_bytes

    def observe(self, *, prefill_tokens: float, decode_tokens: float,
                decode_steps: float, active_kv_tokens: float,
                device_s: float) -> tuple[float, float]:
        """(mfu, roofline_fraction) for one interval. decode_steps is the
        number of device decode steps executed (a fused block counts k);
        active_kv_tokens is the KV working set each decode step streams."""
        if device_s <= 0:
            return 0.0, 0.0
        tokens = prefill_tokens + decode_tokens
        peak = self.chip.bf16_tflops * 1e12 * self.num_chips
        mfu = (2.0 * self.params * tokens) / (device_s * peak)
        ideal_s = self.ideal_s(prefill_tokens=prefill_tokens,
                               decode_steps=decode_steps,
                               active_kv_tokens=active_kv_tokens)
        return mfu, min(1.0, ideal_s / device_s)

    def ideal_s(self, *, prefill_tokens: float, decode_steps: float,
                active_kv_tokens: float) -> float:
        """The interval's device seconds at the roofline: prefill at peak
        FLOPs, each decode step streaming the weights and the KV working set
        at peak HBM bandwidth. `observe`'s fraction is this over the
        measured device seconds, clamped to 1."""
        from ..profiler.timing_model import kv_bytes_per_token

        peak = self.chip.bf16_tflops * 1e12 * self.num_chips
        ideal_s = 0.0
        if prefill_tokens:
            ideal_s += 2.0 * self.params * prefill_tokens / peak
        if decode_steps:
            kv_bytes = active_kv_tokens * kv_bytes_per_token(
                self.model, self.kv_dtype_bytes)
            bw = self.chip.hbm_gbps * 1e9 * self.num_chips
            ideal_s += decode_steps * (self.weight_bytes + kv_bytes) / bw
        return ideal_s
