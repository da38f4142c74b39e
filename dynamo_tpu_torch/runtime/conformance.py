"""Runtime protocol conformance: live lifecycles against the protocol specs.

Port of `dynamo_tpu/runtime/conformance.py`. A ProtocolMonitor replays the
lifecycle events this process actually executes against hand-written state
machines: flight-recorder stamps, drain-state transitions, breaker trips,
streamed-transfer mutations and preemption park / resume.

The machines are JSON specs in `runtime/protocols/` beside this module:
`preemption`, `breaker`, `drain_ladder`, `flight_recorder`,
`kv_stream_transfer`, `coldstart` and `striped_weight_pull`, copies of the
reference's (its `tools/dynastate/protocols/`, which its static analyzer
also checks; the port reads only its own copies). The reference's other
specs (journal, federation, observatory) belong to modules the port does
not have yet.

Hook sites call :func:`observe` with the protocol name, a per-lifecycle
instance key and the event. Hooks sit AFTER each site's terminal guard, so
the monitor sees the transitions the process *accepted*: a violation is an
accepted transition the spec forbids (an unguarded new call site, a phase
running backwards, an event after a terminal state).

Off by default (``DYNT_CONFORMANCE=0``): every hook is then one cached
boolean check. On, violations count into
``dynamo_protocol_violations_total{protocol,rule}`` and `snapshot()` gives
the JSON-ready summary a check asserts zero violations on.
"""

from __future__ import annotations

import json
import logging
import pathlib
import threading
from typing import Optional

from ..config import env

log = logging.getLogger("dynamo_tpu_torch.conformance")

# Violations keep the static rule ids, so one catalogue covers both halves:
# RULE_UNHANDLED = the machine has no transition for this event in this
# state; RULE_POST_TERMINAL = the event arrived after a terminal state.
RULE_UNHANDLED = "DS101"
RULE_POST_TERMINAL = "DS201"

# Bound on the retained violation details (the counter keeps exact totals).
MAX_DETAILS = 200


def _default_spec_dir() -> Optional[pathlib.Path]:
    """The specs shipped with this package (None if they are missing: the
    monitor then stays inert)."""
    spec_dir = pathlib.Path(__file__).resolve().parent / "protocols"
    return spec_dir if spec_dir.is_dir() else None


class _Machine:
    __slots__ = ("name", "initial", "transitions", "terminal", "events")

    def __init__(self, raw: dict) -> None:
        self.name = raw.get("protocol", "")
        self.initial = raw.get("initial")
        states = raw.get("states", {}) or {}
        self.transitions = {s: dict((body or {}).get("on", {}) or {})
                            for s, body in states.items()}
        self.terminal = {s for s, body in states.items()
                         if (body or {}).get("terminal")}
        self.events = set((raw.get("events", {}) or {}))


def _load_machines(spec_dir: Optional[pathlib.Path]) -> dict:
    machines: dict[str, _Machine] = {}
    if spec_dir is None:
        return machines
    try:
        paths = sorted(spec_dir.glob("*.json"))
    except OSError:
        return machines
    for path in paths:
        if path.name == "protocol_registry.json":
            continue
        try:
            raw = json.loads(path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            # a broken spec must never take a serving process down
            continue
        if isinstance(raw, dict) and raw.get("protocol"):
            m = _Machine(raw)
            machines[m.name] = m
    return machines


class ProtocolMonitor:
    """Replays observed lifecycle events against the spec machines.

    Thread-safe (hooks fire from the scheduler thread, the event loop and
    executor threads alike). Each (protocol, instance) starts at the spec's
    initial state on its first observation.
    """

    def __init__(self, spec_dir: Optional[pathlib.Path] = None,
                 enabled: Optional[bool] = None) -> None:
        self.enabled = (bool(env("DYNT_CONFORMANCE"))
                        if enabled is None else enabled)
        self._machines = _load_machines(
            spec_dir if spec_dir is not None else _default_spec_dir())
        self._lock = threading.Lock()
        self._state: dict[tuple[str, str], str] = {}
        self._total = 0
        self._by_key: dict[tuple[str, str], int] = {}
        self._details: list[dict] = []

    # -- observation -------------------------------------------------------

    def observe(self, protocol: str, instance: object, event: str) -> None:
        if not self.enabled:
            return
        machine = self._machines.get(protocol)
        if machine is None or machine.initial is None:
            return
        key = (protocol, str(instance))
        with self._lock:
            state = self._state.get(key, machine.initial)
            if state in machine.terminal:
                self._violate(protocol, key[1], state, event,
                              RULE_POST_TERMINAL)
                return
            dst = machine.transitions.get(state, {}).get(event)
            if dst is None:
                self._violate(protocol, key[1], state, event,
                              RULE_UNHANDLED)
                return
            self._state[key] = dst

    def _violate(self, protocol: str, instance: str, state: str,
                 event: str, rule: str) -> None:
        self._total += 1
        k = (protocol, rule)
        self._by_key[k] = self._by_key.get(k, 0) + 1
        if len(self._details) < MAX_DETAILS:
            self._details.append({
                "protocol": protocol, "instance": instance,
                "state": state, "event": event, "rule": rule})
        try:
            from .metrics import PROTOCOL_VIOLATIONS

            PROTOCOL_VIOLATIONS.labels(protocol=protocol, rule=rule).inc()
        except Exception:  # noqa: BLE001 — accounting never breaks serving
            pass
        log.warning("protocol violation [%s] %s#%s: event %r in state %r",
                    rule, protocol, instance, event, state)

    # -- reporting ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready conformance summary."""
        with self._lock:
            by_protocol: dict[str, dict[str, int]] = {}
            for (protocol, rule), count in sorted(self._by_key.items()):
                by_protocol.setdefault(protocol, {})[rule] = count
            return {
                "enabled": self.enabled,
                "protocols_loaded": sorted(self._machines),
                "instances_tracked": len(self._state),
                "total_violations": self._total,
                "by_protocol": by_protocol,
                "violations": list(self._details),
            }


_monitor: Optional[ProtocolMonitor] = None
_monitor_lock = threading.Lock()


def get_monitor() -> ProtocolMonitor:
    global _monitor
    if _monitor is None:
        with _monitor_lock:
            if _monitor is None:
                _monitor = ProtocolMonitor()
    return _monitor


def reset_monitor() -> None:
    """Drop the singleton; the next get re-reads DYNT_CONFORMANCE and the
    specs (call it after flipping the knob)."""
    global _monitor
    with _monitor_lock:
        _monitor = None


def observe(protocol: str, instance: object, event: str) -> None:
    """Hook-site entry point: record one lifecycle event. Near-free when
    DYNT_CONFORMANCE is off (one attribute check)."""
    get_monitor().observe(protocol, instance, event)


def chaos_assertion(snap: dict) -> dict:
    """The zero-violations assertion row a scenario report carries (the
    `{name, ok, detail}` shape of a scenario's own checks): one forbidden
    transition observed during any pass fails it."""
    return {
        "name": "protocol_conformance",
        "ok": snap.get("total_violations", 0) == 0,
        "detail": {
            "total_violations": snap.get("total_violations", 0),
            "by_protocol": snap.get("by_protocol", {}),
            "violations": list(snap.get("violations", []))[:5],
        },
    }
