"""Priority classes and preemption in the port's scheduler, held against the
JAX package's `InferenceScheduler` (tiny-test, CPU, page size 4, the same
weights in both packages through `params_from_numpy`).

Both schedulers are pumped step by step on the test's thread, so a request
that arrives "mid-decode" arrives at the same step in both packages and the
two runs take the same decisions. A batch request decodes alone in a
one-slot engine; an interactive request then preempts it. The contract, as
`tests/test_preemption.py` pins it for the reference:

  * the resumed stream (greedy, temperature, a speculating slot, a penalty
    processor slot) equals the uninterrupted port stream and the JAX
    package's preempted stream, token for token (tolerance 0: token ids);
    preempt_parked / resumed / migrated equal the reference's;
  * the pool's pages come back; park, claim and drop each happen exactly
    once (a ledger stub and the real KvBlockManager);
  * the deadline burns across a park; with no park store the victim
    migrates, one victim per step; DYNT_PREEMPT_ENABLE=0 turns it off;
  * class-strict, FIFO-within-class admission order, the waiting depth,
    drain_sweep / drain_expire / _fail_all with a parked sequence and the
    `preempt` timeline events are the reference's.
"""

import jax
import numpy as np
import pytest

from dynamo_tpu import block_manager as ref_bm
from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.models import get_config as j_get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu.runtime.flight_recorder import get_recorder as ref_recorder
from dynamo_tpu_torch import block_manager as port_bm
from dynamo_tpu_torch.engine import InferenceScheduler, ModelRunner, RunnerConfig
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import get_config, params_from_numpy
from dynamo_tpu_torch.runtime.flight_recorder import (
    get_recorder as port_recorder,
)

RUNNER = dict(page_size=4, num_pages=96, max_pages_per_seq=24,
              prefill_buckets=(8, 16, 32))
RNG = np.random.default_rng(11)
BATCH_PROMPTS = [RNG.integers(1, 512, n).tolist() for n in (10, 13, 9)]
INTERACTIVE_PROMPT = RNG.integers(1, 512, 12).tolist()
CUT = 5  # tokens the batch stream has when the interactive request arrives
PACKAGES = ("port", "ref")

# (sampling fields, prompt) of each parametrised case; "spec" runs with
# DYNT_SPEC_ENABLE=1 on a repetitive prompt, so the slot drafts
CASES = {
    "greedy": (dict(temperature=0.0), BATCH_PROMPTS[0]),
    "temperature": (dict(temperature=0.9, seed=123), BATCH_PROMPTS[1]),
    "spec": (dict(temperature=0.0), [5, 6, 7] * 6),
    "penalty": (dict(temperature=0.0, frequency_penalty=0.8,
                     presence_penalty=0.5), BATCH_PROMPTS[2]),
}


class ParkStore:
    """The park-store surface the preemption touches, with a ledger of its
    operations (the reference test's stub, for either package)."""

    def __init__(self):
        self.store: dict = {}
        self.ops: list = []

    def attach_engine(self, **kw):
        self.engine = kw

    def notify_stored(self, hashes, parent):
        pass

    def match_prefix(self, hashes):
        return 0

    def read_blocks(self, hashes):
        return None

    def park_sequence(self, rid, bundle):
        self.ops.append(("park", rid))
        self.store[rid] = bundle
        return True

    def claim_parked(self, rid):
        self.ops.append(("claim", rid))
        return self.store.pop(rid, None)

    def drop_parked(self, rid):
        self.ops.append(("drop", rid))
        return self.store.pop(rid, None) is not None

    def op_counts(self, rid):
        return {op: sum(1 for o, r in self.ops if o == op and r == rid)
                for op in ("park", "claim", "drop")}


def _ledgered(mgr):
    """The real KvBlockManager with its park-store calls logged."""
    mgr.ops = []
    for op, name in (("park", "park_sequence"), ("claim", "claim_parked"),
                     ("drop", "drop_parked")):
        fn = getattr(mgr, name)

        def logged(rid, *args, _fn=fn, _op=op):
            mgr.ops.append((_op, rid))
            return _fn(rid, *args)

        setattr(mgr, name, logged)
    mgr.op_counts = ParkStore.op_counts.__get__(mgr)
    return mgr


class FakeDeadline:
    def __init__(self):
        self.is_expired = False

    def expired(self):
        return self.is_expired

    def remaining(self):
        return 0.0 if self.is_expired else 1.0


class Stream:
    def __init__(self):
        self.outputs: list = []

    def emit(self, out) -> None:
        self.outputs.append(out)

    @property
    def tokens(self):
        return [t for o in self.outputs for t in o.token_ids]

    @property
    def done(self):
        return bool(self.outputs) and self.outputs[-1].finish_reason is not None

    @property
    def finish(self):
        return self.outputs[-1].finish_reason if self.outputs else None

    @property
    def error(self):
        return self.outputs[-1].error if self.outputs else None


def _request(pkg, rid, tokens, max_tokens, priority="standard", **sampling):
    req_cls, samp_cls, stop_cls = (
        (PreprocessedRequest, SamplingOptions, StopConditions)
        if pkg == "port" else (JRequest, JSampling, JStop))
    sampling.setdefault("seed", 7)
    return req_cls(request_id=rid, token_ids=list(tokens),
                   sampling=samp_cls(max_tokens=max_tokens, **sampling),
                   stop=stop_cls(ignore_eos=True), priority=priority)


def _pump(sched, done, limit=2000) -> None:
    """Run the scheduler's loop body on this thread until `done()`."""
    for _ in range(limit):
        if done():
            return
        sched._drain_control()
        sched._drain_incoming()
        if not sched._step():
            sched._drain_gap()
    raise AssertionError("the scheduler stalled")


def _idle(sched) -> bool:
    return (not sched._waiting and not sched._parked
            and all(s is None for s in sched._slots))


def _pages(sched) -> int:
    return sched.pool.free_count() + sched.pool.cached_count()


@pytest.fixture(scope="module")
def runners():
    """The port's and the JAX package's runners on the same weights, with
    one slot (a single decode slot forces the preemption decision) and with
    two."""
    j_cfg = j_get_config("tiny-test")
    params = jax.device_get(j_init(jax.random.PRNGKey(0), j_cfg))
    cfg = get_config("tiny-test")
    port_params = params_from_numpy(params, cfg, device="cpu")
    mesh = make_mesh(MeshConfig())
    out = {}
    for mb in (1, 2):
        out[("port", mb)] = ModelRunner(
            cfg, RunnerConfig(max_batch=mb, **RUNNER), device="cpu",
            params=port_params)
        out[("ref", mb)] = JRunner(j_cfg, JRunnerConfig(max_batch=mb,
                                                        **RUNNER),
                                   mesh, params=params)
    return out


def _scheduler(runners, pkg, mb=1, kvbm=None):
    cls = InferenceScheduler if pkg == "port" else JScheduler
    return cls(runners[(pkg, mb)], kvbm=kvbm)


def _uninterrupted(runners, pkg, case) -> list:
    sampling, prompt = CASES[case]
    sched = _scheduler(runners, pkg)
    s = Stream()
    sched.submit(_request(pkg, f"alone-{case}", prompt, 24, **sampling),
                 s.emit)
    _pump(sched, lambda: s.done and _idle(sched))
    assert s.finish == "length"
    return s.tokens


def _preempted(runners, pkg, case, kvbm, deadline=None) -> dict:
    """The case's batch request decodes alone until it has CUT tokens; an
    interactive request then arrives. Runs until both finish, with the
    batch request's flight-recorder timeline open."""
    sampling, prompt = CASES[case]
    recorder = port_recorder() if pkg == "port" else ref_recorder()
    rid = f"{pkg}-{case}-{id(kvbm)}"
    sched = _scheduler(runners, pkg, kvbm=kvbm)
    pages0 = _pages(sched)
    recorder.start(rid)
    batch, inter = Stream(), Stream()
    request = _request(pkg, rid, prompt, 24, priority="batch", **sampling)
    request.deadline = deadline
    sched.submit(request, batch.emit, record_id=rid)
    _pump(sched, lambda: len(batch.tokens) >= CUT)
    if deadline is not None:
        deadline.is_expired = True
    sched.submit(_request(pkg, f"{rid}-i", INTERACTIVE_PROMPT, 4,
                          priority="interactive"), inter.emit)
    depth = None

    def parked_once():
        nonlocal depth
        if depth is None and sched.stats.preempt_parked:
            depth = sched.queue_depth()
        return batch.done and inter.done and _idle(sched)

    _pump(sched, parked_once)
    timeline = recorder.finish(rid)
    events = [{k: v for k, v in e.items() if k != "ts"}
              for e in timeline.events if e["event"] == "preempt"]
    return {"batch": batch, "inter": inter, "rid": rid,
            "stats": {k: getattr(sched.stats, k) for k in (
                "preempt_parked", "preempt_resumed", "preempt_migrated")},
            "spec_proposed": sched.stats.spec_proposed,
            "pages": (pages0, _pages(sched)), "events": events,
            "depth_while_parked": depth}


@pytest.mark.parametrize("case", list(CASES))
def test_resumed_stream_equals_uninterrupted_and_reference(runners, case,
                                                           monkeypatch):
    if case == "spec":
        monkeypatch.setenv("DYNT_SPEC_ENABLE", "1")
        monkeypatch.setenv("DYNT_SPEC_MIN_EMA", "0")
    alone = _uninterrupted(runners, "port", case)
    got = {pkg: _preempted(runners, pkg, case, ParkStore())
           for pkg in PACKAGES}
    port, ref = got["port"], got["ref"]
    assert port["batch"].finish == ref["batch"].finish == "length"
    assert port["batch"].tokens == alone == ref["batch"].tokens
    assert port["inter"].tokens == ref["inter"].tokens
    assert port["inter"].finish == "length"
    if case == "spec":
        assert port["spec_proposed"] > 0  # the slot drafted
    assert port["stats"] == ref["stats"] == {
        "preempt_parked": 1, "preempt_resumed": 1, "preempt_migrated": 0}
    # the pool's pages all came back
    assert port["pages"][0] == port["pages"][1]
    # the timeline's preempt events: the reference's kinds and counts
    assert port["events"] == ref["events"]
    assert [e["kind"] for e in port["events"]] == ["park", "resume"]


@pytest.mark.parametrize("store", ["stub", "kvbm"])
def test_park_claim_drop_exactly_once(runners, store):
    """One park, one claim, no drop, the store empty after: with the ledger
    stub, and with each package's real KvBlockManager (its bundle the
    runner's layout, gathered, parked and scattered back)."""
    got = {}
    for pkg in PACKAGES:
        if store == "stub":
            kvbm = ParkStore()
        else:
            bm = port_bm if pkg == "port" else ref_bm
            kvbm = _ledgered(bm.KvBlockManager(
                bm.KvbmConfig(host_blocks=16),
                bm.BlockLayoutSpec.from_runner_layout(
                    runners[(pkg, 1)].kv_layout())))
        try:
            out = _preempted(runners, pkg, "greedy", kvbm)
            out["ops"] = kvbm.op_counts(out["rid"])
            out["left"] = (len(kvbm.store) if store == "stub"
                           else kvbm.parked_count())
        finally:
            if store == "kvbm":
                kvbm.close()
        got[pkg] = out
    for pkg in PACKAGES:
        assert got[pkg]["ops"] == {"park": 1, "claim": 1, "drop": 0}
        assert got[pkg]["left"] == 0
    assert got["port"]["batch"].tokens == got["ref"]["batch"].tokens


def test_the_deadline_burns_across_a_park(runners):
    """A budget that expires while the sequence is parked ends it with an
    honest error; its bundle is dropped once, never claimed."""
    got = {pkg: _preempted(runners, pkg, "greedy", ParkStore(),
                           deadline=FakeDeadline()) for pkg in PACKAGES}
    for pkg in PACKAGES:
        out = got[pkg]
        assert out["batch"].finish == "error"
        assert "deadline" in out["batch"].error
        assert out["stats"]["preempt_parked"] == 1
        assert out["pages"][0] == out["pages"][1]
    assert got["port"]["batch"].error == got["ref"]["batch"].error
    assert got["port"]["batch"].tokens == got["ref"]["batch"].tokens
    assert got["port"]["events"] == got["ref"]["events"]
    assert [e["kind"] for e in got["port"]["events"]] == ["park", "expired"]


def test_waiting_depth_includes_the_parked(runners):
    got = {pkg: _preempted(runners, pkg, "greedy", ParkStore())
           for pkg in PACKAGES}
    # one live slot (the interactive request) and the parked one waiting
    assert got["port"]["depth_while_parked"] == (1, 1)
    assert got["ref"]["depth_while_parked"] == (1, 1)


def _two_batch_one_interactive(runners, pkg) -> tuple:
    """Two batch streams fill a two-slot engine with no park store; one
    interactive request arrives once both decode."""
    sched = _scheduler(runners, pkg, mb=2)
    b1, b2, inter = Stream(), Stream(), Stream()
    sched.submit(_request(pkg, "b1", BATCH_PROMPTS[0], 24,
                          priority="batch"), b1.emit)
    sched.submit(_request(pkg, "b2", BATCH_PROMPTS[1], 24,
                          priority="batch"), b2.emit)
    _pump(sched, lambda: len(b1.tokens) >= CUT and len(b2.tokens) >= CUT)
    sched.submit(_request(pkg, "i", INTERACTIVE_PROMPT, 4,
                          priority="interactive"), inter.emit)
    _pump(sched, lambda: b1.done and b2.done and inter.done and _idle(sched))
    return sched, (b1, b2, inter)


def test_without_a_park_store_one_victim_migrates_per_step(runners):
    """kvbm=None: the victim takes the cooperative migrate, and one waiting
    head migrates one victim, not every lower-class slot."""
    got = {pkg: _two_batch_one_interactive(runners, pkg) for pkg in PACKAGES}
    for pkg in PACKAGES:
        sched, (b1, b2, inter) = got[pkg]
        assert sched.stats.preempt_migrated == 1
        assert sched.stats.preempt_parked == 0
        assert sorted([b1.finish, b2.finish]) == ["length", "migrate"]
        victim = b1 if b1.finish == "migrate" else b2
        assert "preempted" in victim.error
        assert inter.finish == "length"
    port, ref = got["port"][1], got["ref"][1]
    assert [(s.tokens, s.finish, s.error) for s in port] == [
        (s.tokens, s.finish, s.error) for s in ref]


def test_preemption_can_be_turned_off(runners, monkeypatch):
    monkeypatch.setenv("DYNT_PREEMPT_ENABLE", "0")
    for pkg in PACKAGES:
        kvbm = ParkStore()
        sched = _scheduler(runners, pkg, kvbm=kvbm)
        assert sched.preempt_enabled is False
        batch, inter = Stream(), Stream()
        sched.submit(_request(pkg, "b", BATCH_PROMPTS[0], 16,
                              priority="batch"), batch.emit)
        _pump(sched, lambda: len(batch.tokens) >= CUT)
        sched.submit(_request(pkg, "i", INTERACTIVE_PROMPT, 2,
                              priority="interactive"), inter.emit)
        # the batch stream finishes first: the single slot is not taken
        _pump(sched, lambda: batch.done)
        assert not inter.outputs
        _pump(sched, lambda: inter.done and _idle(sched))
        assert (batch.finish, inter.finish) == ("length", "length")
        assert sched.stats.preempt_parked == sched.stats.preempt_migrated == 0
        assert kvbm.ops == []


def test_admission_is_class_strict_and_fifo_within_a_class(runners,
                                                           monkeypatch):
    """Arrivals drained together are sorted by class, stably; a later
    interactive arrival overtakes the waiting standard and batch requests
    and queues behind the earlier interactive ones. The waiting order and
    the finish order are the reference's."""
    monkeypatch.setenv("DYNT_PREEMPT_ENABLE", "0")
    first = ["batch", "standard", "interactive", "batch", "standard",
             "interactive"]
    later = ["batch", "interactive"]
    got = {}
    for pkg in PACKAGES:
        sched = _scheduler(runners, pkg)
        finished = []

        def submit(i, prio):
            def emit(out, rid=f"{prio}-{i}"):
                if out.finish_reason is not None:
                    finished.append(rid)
            sched.submit(_request(pkg, f"{prio}-{i}", BATCH_PROMPTS[0], 2,
                                  priority=prio), emit)

        for i, prio in enumerate(first):
            submit(i, prio)
        sched._drain_incoming()
        for i, prio in enumerate(later, start=len(first)):
            submit(i, prio)
        sched._drain_incoming()
        waiting = [s.request.request_id for s in sched._waiting]
        _pump(sched, lambda: len(finished) == 8 and _idle(sched))
        got[pkg] = (waiting, finished)
    assert got["port"] == got["ref"]
    assert got["port"][0] == [
        "interactive-2", "interactive-5", "interactive-7", "standard-1",
        "standard-4", "batch-0", "batch-3", "batch-6"]


def _parked_scheduler(runners, pkg, kvbm):
    """A one-slot scheduler whose batch request is parked behind a live
    interactive one, with a third (batch) request waiting."""
    sched = _scheduler(runners, pkg, kvbm=kvbm)
    streams = {name: Stream() for name in ("parked", "live", "waiting")}
    sched.submit(_request(pkg, "parked", BATCH_PROMPTS[0], 24,
                          priority="batch"), streams["parked"].emit)
    _pump(sched, lambda: len(streams["parked"].tokens) >= CUT)
    sched.submit(_request(pkg, "live", INTERACTIVE_PROMPT, 16,
                          priority="interactive"), streams["live"].emit)
    _pump(sched, lambda: sched.stats.preempt_parked == 1)
    sched.submit(_request(pkg, "waiting", BATCH_PROMPTS[1], 8,
                          priority="batch"), streams["waiting"].emit)
    sched._drain_incoming()
    assert len(sched._parked) == 1 and sched.queue_depth() == (1, 2)
    return sched, streams


def _ends(streams) -> dict:
    return {name: (s.finish, s.error, len(s.tokens))
            for name, s in streams.items()}


@pytest.mark.parametrize("how", ["drain_sweep", "drain_expire", "fail_all"])
def test_vacating_with_a_parked_sequence(runners, how):
    """drain_sweep replays the parked sequence, drain_expire errors it,
    each dropping its bundle once, as the reference does; _fail_all (the
    port's engine-failure path, the reference's abort_all with an error in
    place of a migrate) errors it and drops its bundle."""
    got = {}
    for pkg in PACKAGES:
        kvbm = ParkStore()
        sched, streams = _parked_scheduler(runners, pkg, kvbm)
        if how == "drain_sweep":
            result = sched.drain_sweep()
        elif how == "drain_expire":
            result = sched.drain_expire("drain deadline")
        elif pkg == "port":
            result = sched._fail_all("engine failed")
        else:
            result = sched.abort_all("engine failed")
        got[pkg] = {"result": result, "ends": _ends(streams),
                    "ops": kvbm.op_counts("parked"), "store": kvbm.store,
                    "parked": list(sched._parked),
                    "depth": sched.queue_depth()}
    port, ref = got["port"], got["ref"]
    assert port["ops"] == ref["ops"] == {"park": 1, "claim": 0, "drop": 1}
    assert port["store"] == ref["store"] == {}
    assert port["parked"] == ref["parked"] == []
    if how == "fail_all":
        # a failed engine's loop ends: only the parked list is emptied
        assert {k: v[0] for k, v in port["ends"].items()} == {
            "parked": "error", "live": "error", "waiting": "error"}
        assert {k: v[0] for k, v in ref["ends"].items()} == {
            "parked": "migrate", "live": "migrate", "waiting": "migrate"}
        assert ({k: v[2] for k, v in port["ends"].items()}
                == {k: v[2] for k, v in ref["ends"].items()})
    else:
        assert port["depth"] == ref["depth"] == (0, 0)
        assert port["result"] == ref["result"]
        assert port["ends"] == ref["ends"]
