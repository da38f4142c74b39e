"""The port's protocol-conformance monitor against the JAX package's.

  * the seven protocol specs the port ships (`runtime/protocols/`) are
    JSON-equal to the reference's (`tools/dynastate/protocols/`);
  * the reference's monitor-core cases, run on both monitors: the same
    snapshots (the loaded protocol list aside: the port loads its seven);
  * a hypothesis property: random event sequences over each protocol's
    events (and one the spec does not know) give both monitors the same
    snapshot;
  * with DYNT_CONFORMANCE=1, the port's own lifecycles record no violation:
    a request served by a TorchWorker (its flight-recorder timeline) and
    that worker's drain ladder, a breaker trip cycle, and a streamed
    transfer with the terminal guards the reference pins.

CPU only, tiny-test, no process spawned, no socket bound.
"""

import asyncio
import json
import pathlib

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime import conformance as ref_conformance
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.llm.kv_transfer import (
    KvLayoutDescriptor,
    PendingTransferTable,
    StreamingTransfer,
)
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import conformance
from dynamo_tpu_torch.runtime.conformance import (
    MAX_DETAILS,
    RULE_POST_TERMINAL,
    RULE_UNHANDLED,
    ProtocolMonitor,
    chaos_assertion,
    get_monitor,
    observe,
    reset_monitor,
)
from dynamo_tpu_torch.runtime.flight_recorder import FlightRecorder
from dynamo_tpu_torch.runtime.resilience import CircuitBreaker

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_SPECS = ROOT / "tools" / "dynastate" / "protocols"
PORT_SPECS = ROOT / "dynamo_tpu_torch" / "runtime" / "protocols"
PROTOCOLS = ("preemption", "breaker", "drain_ladder", "flight_recorder",
             "kv_stream_transfer", "coldstart", "striped_weight_pull")


@pytest.fixture
def monitor_on(monkeypatch):
    monkeypatch.setenv("DYNT_CONFORMANCE", "1")
    reset_monitor()
    yield get_monitor()
    reset_monitor()


@pytest.mark.parametrize("name", PROTOCOLS)
def test_spec_copies_equal_the_reference(name):
    port = json.loads((PORT_SPECS / f"{name}.json").read_text())
    ref = json.loads((REF_SPECS / f"{name}.json").read_text())
    assert port == ref


def test_the_port_ships_exactly_its_five_specs():
    # (named when the port shipped five; it ships seven since the arrival
    # ladder's coldstart and striped_weight_pull)
    assert sorted(p.stem for p in PORT_SPECS.glob("*.json")) == sorted(
        PROTOCOLS)
    assert ProtocolMonitor(enabled=True).snapshot()["protocols_loaded"] == (
        sorted(PROTOCOLS))


def _observations(monitor, observe_fn, body) -> dict:
    body(observe_fn)
    snap = monitor.snapshot()
    snap.pop("protocols_loaded")
    return snap


def _core_valid(obs):
    obs("kv_stream_transfer", "t-ok", "append")
    obs("kv_stream_transfer", "t-ok", "append")
    obs("kv_stream_transfer", "t-ok", "finish")


def _core_unhandled(obs):
    obs("kv_stream_transfer", "t-bad", "bogus_event")


def _core_post_terminal(obs):
    obs("kv_stream_transfer", "t-late", "finish")
    obs("kv_stream_transfer", "t-late", "append")


def _core_independent(obs):
    obs("kv_stream_transfer", "a", "finish")
    obs("kv_stream_transfer", "b", "append")


def _core_unknown_protocol(obs):
    obs("no_such_protocol", "x", "whatever")


def _core_capped(obs):
    for i in range(MAX_DETAILS + 50):
        obs("kv_stream_transfer", f"cap-{i}", "bogus_event")


def _core_preemption(obs):
    for event in ("park", "resume", "park", "migrate", "resume"):
        obs("preemption", "s1", event)
    obs("preemption", "s2", "drop")


CORE = {
    "valid_sequence_is_clean": (_core_valid, dict(
        total_violations=0, instances_tracked=1)),
    "unhandled_event_is_ds101": (_core_unhandled, dict(
        total_violations=1,
        by_protocol={"kv_stream_transfer": {RULE_UNHANDLED: 1}},
        violations=[{"protocol": "kv_stream_transfer", "instance": "t-bad",
                     "state": "streaming", "event": "bogus_event",
                     "rule": RULE_UNHANDLED}])),
    "event_after_terminal_is_ds201": (_core_post_terminal, dict(
        by_protocol={"kv_stream_transfer": {RULE_POST_TERMINAL: 1}})),
    "instances_are_independent": (_core_independent, dict(
        total_violations=0)),
    "unknown_protocol_ignored": (_core_unknown_protocol, dict(
        total_violations=0, instances_tracked=0)),
    "details_capped_but_totals_exact": (_core_capped, dict(
        total_violations=MAX_DETAILS + 50)),
    "preemption_lifecycle": (_core_preemption, dict(
        total_violations=2,
        by_protocol={"preemption": {RULE_POST_TERMINAL: 1,
                                    RULE_UNHANDLED: 1}})),
}


@pytest.mark.parametrize("case", list(CORE) + ["disabled_monitor_is_inert",
                                               "chaos_assertion_row"])
def test_monitor_core_matches_the_reference(case, monkeypatch):
    """The reference's TestMonitorCore cases on the port's monitor and the
    reference's, each on its own specs: equal snapshots."""
    if case == "disabled_monitor_is_inert":
        monkeypatch.delenv("DYNT_CONFORMANCE", raising=False)
    else:
        monkeypatch.setenv("DYNT_CONFORMANCE", "1")
    port, ref = ProtocolMonitor(), ref_conformance.ProtocolMonitor()
    if case == "disabled_monitor_is_inert":
        body, want = _core_unhandled, dict(enabled=False, total_violations=0,
                                           instances_tracked=0)
    elif case == "chaos_assertion_row":
        def body(obs):
            for i in range(7):
                obs("kv_stream_transfer", f"x-{i}", "bogus_event")
        want = {}
        assert chaos_assertion(port.snapshot()) == {
            "name": "protocol_conformance", "ok": True,
            "detail": {"total_violations": 0, "by_protocol": {},
                       "violations": []}}
    else:
        body, want = CORE[case]
    got = _observations(port, port.observe, body)
    assert got == _observations(ref, ref.observe, body)
    for key, value in want.items():
        assert got[key] == value, key
    if case == "details_capped_but_totals_exact":
        assert len(got["violations"]) == MAX_DETAILS
    if case == "chaos_assertion_row":
        row = chaos_assertion(port.snapshot())
        assert row == ref_conformance.chaos_assertion(ref.snapshot())
        assert row["ok"] is False
        assert row["detail"]["total_violations"] == 7
        assert len(row["detail"]["violations"]) == 5


def _events(protocol: str) -> list:
    spec = json.loads((PORT_SPECS / f"{protocol}.json").read_text())
    return sorted(spec["events"]) + ["bogus_event"]


@st.composite
def _sequences(draw):
    protocol = draw(st.sampled_from(PROTOCOLS))
    steps = draw(st.lists(
        st.tuples(st.sampled_from(["a", "b", "c"]),
                  st.sampled_from(_events(protocol))),
        max_size=30))
    return protocol, steps


@settings(max_examples=120, deadline=None, derandomize=True)
@given(_sequences())
def test_random_sequences_give_the_reference_snapshot(seq):
    protocol, steps = seq
    port = ProtocolMonitor(enabled=True)
    ref = ref_conformance.ProtocolMonitor(enabled=True)

    def body(obs):
        for instance, event in steps:
            obs(protocol, instance, event)

    assert (_observations(port, port.observe, body)
            == _observations(ref, ref.observe, body))
    # the protocol's states as the monitors keep them
    assert port._state == ref._state


def test_the_hooks_are_inert_when_off(monkeypatch):
    monkeypatch.delenv("DYNT_CONFORMANCE", raising=False)
    reset_monitor()
    try:
        rec = FlightRecorder(capacity=4)
        rec.start("r")
        rec.stamp("r", "first_token")
        rec.stamp("r", "queued")  # backwards, but nobody is watching
        rec.finish("r")
        snap = get_monitor().snapshot()
        assert snap["enabled"] is False
        assert snap["instances_tracked"] == snap["total_violations"] == 0
    finally:
        reset_monitor()


def test_a_served_request_and_the_drain_ladder_conform(monitor_on):
    """A TorchWorker serves a request through `generate` (its flight-
    recorder timeline: queued, scheduled, prefill_start, first_token,
    finished), then drains (serving, draining, drained): no violation, and
    both lifecycles reach their end states."""
    worker = TorchWorker("tiny-test", RunnerConfig(
        page_size=4, num_pages=64, max_batch=2, max_pages_per_seq=16,
        prefill_buckets=(8, 16, 32)), device="cpu")
    worker.start()
    try:
        body = PreprocessedRequest(
            request_id="conform-1", token_ids=list(range(3, 20)),
            sampling=SamplingOptions(max_tokens=6, temperature=0.0),
            stop=StopConditions(ignore_eos=True)).to_wire()

        async def go():
            frames = [f async for f in worker.generate(body)]
            report = await worker.drain("test", deadline_secs=5.0)
            return frames, report

        frames, report = asyncio.run(go())
    finally:
        worker.close()
    assert sum(len(f.get("t", [])) for f in frames) == 6
    assert report["completed"] is True
    snap = monitor_on.snapshot()
    assert snap["total_violations"] == 0, snap["violations"]
    states = monitor_on._state
    assert states[("flight_recorder", "conform-1")] == "finished"
    assert states[("drain_ladder", str(worker.instance_id))] == "drained"


def test_a_breaker_trip_cycle_conforms(monitor_on):
    b = CircuitBreaker(failure_threshold=1, reset_secs=0.0)
    b.record_failure()                    # closed -> open
    assert b.try_acquire()                # open -> half_open (the probe)
    b.record_failure(probe=True)          # half_open -> open
    assert b.try_acquire()                # open -> half_open again
    b.record_success(probe=True)          # half_open -> closed
    b.record_failure()                    # closed -> open
    b.reset()                             # open -> closed
    snap = monitor_on.snapshot()
    assert snap["total_violations"] == 0
    assert monitor_on._state[("breaker", str(id(b)))] == "closed"


def _transfer(transfer_id):
    released = []
    table = PendingTransferTable()
    t = StreamingTransfer(
        transfer_id, [], lambda: released.append(1),
        KvLayoutDescriptor(n_layers=2, kv_heads=2, head_dim=4, page_size=16,
                           dtype="float32"), 128, table=table)
    table.add(t)
    return t, released


@pytest.mark.parametrize("order", ["append_finish", "fail_then_finish",
                                   "finish_then_append", "finish_then_fail"])
def test_a_streamed_transfer_conforms(monitor_on, order):
    """The terminal guards hold under an enabled monitor: nothing after
    finish or fail mutates the transfer or reaches the monitor."""
    t, released = _transfer(order)
    if order == "append_finish":
        t.append_pages([1])
        t.append_pages([2])
        t.finish(7, [1, 2, 3])
        assert t.page_ids == [1, 2, 3] and t.first_token == 7
        end = "finished"
    elif order == "fail_then_finish":
        t.fail()
        t.finish(5, [1, 2])
        assert t.failed and not t.done and t.page_ids == []
        assert released == [1]
        end = "failed"
    elif order == "finish_then_append":
        t.append_pages([1])
        t.finish(7, [1, 2])
        t.append_pages([9])
        assert t.page_ids == [1, 2]
        end = "finished"
    else:
        t.finish(7, [1, 2])
        t.fail()
        assert t.done and not t.failed and released == []
        end = "finished"
    assert monitor_on.snapshot()["total_violations"] == 0
    assert monitor_on._state[("kv_stream_transfer", order)] == end


def test_a_violation_counts_into_the_metric(monitor_on):
    from dynamo_tpu_torch.runtime.metrics import PROTOCOL_VIOLATIONS

    before = PROTOCOL_VIOLATIONS.labels(protocol="preemption",
                                        rule=RULE_UNHANDLED).get()
    observe("preemption", "m1", "resume")  # resume while running
    assert PROTOCOL_VIOLATIONS.labels(
        protocol="preemption", rule=RULE_UNHANDLED).get() == before + 1
    assert conformance.get_monitor().snapshot()["total_violations"] == 1
