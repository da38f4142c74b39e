"""The port's admission control against the JAX package's.

`dynamo_tpu_torch/runtime/admission.py` and its edges (the router's
admission queue and the HTTP frontend) held against `dynamo_tpu/runtime/
admission.py` (the cases of tests/test_admission.py): both packages'
DrainRateEwma, QueueWaitEstimator and TenantLedger are driven through the
same seeded event sequences on the same injected clock (`now=`) and must
give the same rates, depths, wait estimates, verdicts, Retry-After values
and tenant shares. Then the edges: the router queue refuses a doomed
budget and an over-share tenant before parking; both packages' frontends,
over one fake worker, shed the same doomed request with the same 503,
Retry-After and body. Binds 127.0.0.1 only, spawns no subprocess.
"""

import asyncio
import http.client
import json
import math
import random
import time
import uuid

import pytest

from dynamo_tpu.frontend import Frontend as RefFrontend
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu.runtime import admission as ref
from dynamo_tpu_torch.frontend import Frontend
from dynamo_tpu_torch.kv_router import (
    KvRouterConfig,
    KvScheduler,
    WorkerWithDpRank,
)
from dynamo_tpu_torch.kv_router.queue import QueuedRequest, SchedulerQueue
from dynamo_tpu_torch.llm.http_service import _LatencyObserver
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, publish_card
from dynamo_tpu_torch.llm.protocols import EngineOutput
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime import admission as port
from dynamo_tpu_torch.runtime.metrics import REQUESTS_SHED, TENANT_SHED
from dynamo_tpu_torch.runtime.resilience import Deadline


class _FixedDeadline:
    """A deadline with a fixed remaining budget, read by both packages."""

    def __init__(self, secs: float) -> None:
        self.secs = secs

    def remaining(self) -> float:
        return self.secs


# -- DrainRateEwma and QueueWaitEstimator ------------------------------------


def test_cold_rate_is_none():
    assert port.DrainRateEwma().rate(now=10.0) is None
    assert port.QueueWaitEstimator().estimate_wait_ms(now=1.0) == 0.0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("halflife", [0.5, 2.0, 5.0])
def test_drain_rate_equals_the_reference(seed, halflife):
    """Irregular drains, batches and silences (stalls past several
    half-lives): the same rate at every read."""
    rng = random.Random(seed)
    a, b = port.DrainRateEwma(halflife), ref.DrainRateEwma(halflife)
    t = 0.0
    for _ in range(150):
        t += rng.choice((0.01, 0.1, 0.25, 1.0, halflife * 3, 0.0))
        if rng.random() < 0.7:
            n = rng.choice((1, 1, 2, 0.5, 0))
            a.observe(n, now=t)
            b.observe(n, now=t)
        probe = t + rng.choice((0.0, halflife / 2, halflife * 4))
        assert a.rate(now=probe) == b.rate(now=probe)


def test_rate_converges_and_stall_decays():
    ewma = port.DrainRateEwma(halflife_s=2.0)
    t = 0.0
    while t < 30.0:
        ewma.observe(1, now=t)
        t += 0.25
    assert ewma.rate(now=t) == pytest.approx(4.0, rel=0.15)
    healthy = ewma.rate(now=t)
    assert ewma.rate(now=t + 1.5) == pytest.approx(healthy)
    assert ewma.rate(now=t + 2.0 + 20.0) < healthy / 500


@pytest.mark.parametrize("seed", range(8))
def test_wait_estimates_equal_the_reference(seed, monkeypatch):
    """Worker reports, set_depth, forgets, drains and TTL expiry in one
    seeded sequence: the same depth, wait, Retry-After and verdict under
    the same budgets."""
    rng = random.Random(seed)
    monkeypatch.setenv("DYNT_ADMISSION_MARGIN", str(rng.choice((1.0, 1.2))))
    a = port.QueueWaitEstimator(pool="p", halflife_s=2.0, worker_ttl_s=30.0)
    b = ref.QueueWaitEstimator(pool="p", halflife_s=2.0, worker_ttl_s=30.0)
    t = 0.0
    for _ in range(200):
        t += rng.choice((0.05, 0.2, 1.0, 5.0, 31.0))
        op = rng.random()
        if op < 0.35:
            a.observe_drained(1, now=t)
            b.observe_drained(1, now=t)
        elif op < 0.6:
            wid, n = rng.randrange(4), rng.randrange(60)
            a.update_worker(wid, n, now=t)
            b.update_worker(wid, n, now=t)
        elif op < 0.7:
            wid = rng.randrange(4)
            a.forget_worker(wid)
            b.forget_worker(wid)
        elif op < 0.8:
            depth = rng.randrange(20)
            a.set_depth(depth, now=t)
            b.set_depth(depth, now=t)
        extra = rng.randrange(3)
        assert a.depth(now=t) == b.depth(now=t)
        wait = a.estimate_wait_ms(extra=extra, now=t)
        assert wait == b.estimate_wait_ms(extra=extra, now=t)
        assert a.retry_after_s(wait) == b.retry_after_s(wait)
        budget = _FixedDeadline(rng.choice((0.001, 0.5, 5.0, 60.0)))
        for deadline in (None, budget):
            da = a.check(deadline, extra=extra, now=t)
            db = b.check(deadline, extra=extra, now=t)
            assert (da.admit, da.est_wait_ms, da.retry_after_s,
                    da.reason) == (db.admit, db.est_wait_ms,
                                   db.retry_after_s, db.reason)


def _warmed(pool="p", rate=5.0, until=20.0):
    est = port.QueueWaitEstimator(pool=pool, halflife_s=2.0)
    t = 0.0
    while t < until:
        est.observe_drained(1, now=t)
        t += 1.0 / rate
    return est


def test_wait_tracks_depth_over_rate():
    est = _warmed(rate=5.0)
    assert est.check(_FixedDeadline(0.001), now=20.0).admit  # empty queue
    est.update_worker(1, 10, now=20.0)
    est.update_worker(2, 10, now=20.0)
    assert est.estimate_wait_ms(now=20.0) == pytest.approx(4000, rel=0.3)
    assert not est.check(_FixedDeadline(1.0), now=20.0).admit
    assert est.check(_FixedDeadline(30.0), now=20.0).admit
    assert est.check(None, now=20.0).admit


def test_stalled_drain_refuses_with_capped_retry_after():
    est = _warmed(rate=5.0)
    est.update_worker(1, 10, now=120.0)
    assert math.isinf(est.estimate_wait_ms(now=120.0))
    decision = est.check(_FixedDeadline(60.0), now=120.0)
    assert not decision.admit and decision.retry_after_s == 30.0


@pytest.mark.parametrize("wait_ms", [0.0, 10.0, 999.0, 1500.0, 10_000.0,
                                     29_999.0, 10_000_000.0, math.inf])
@pytest.mark.parametrize("floor,cap", [("1", "30"), ("2", "10")])
def test_clamp_retry_after_equals_the_reference(monkeypatch, wait_ms, floor,
                                                cap):
    monkeypatch.setenv("DYNT_RETRY_AFTER_MIN_SECS", floor)
    monkeypatch.setenv("DYNT_RETRY_AFTER_MAX_SECS", cap)
    assert port.clamp_retry_after_s(wait_ms) == \
        ref.clamp_retry_after_s(wait_ms)


def test_dead_worker_and_vanished_pool_expire():
    est = _warmed(rate=5.0, until=100.0)
    est.update_worker(1, 40, now=100.0)
    assert est.depth(now=100.0) == 40
    assert est.depth(now=140.0) == 0
    est.set_depth(7, now=200.0)
    assert est.depth(now=210.0) == 7
    assert est.depth(now=240.0) == 0
    est.update_worker(3, 9, now=300.0)
    est.forget_worker(3)
    assert est.depth(now=300.0) == 0


# -- check_admission ---------------------------------------------------------


def _stalled() -> port.QueueWaitEstimator:
    """A stalled pool on the real clock (check_admission reads it)."""
    base = time.monotonic()
    est = port.QueueWaitEstimator(pool=f"t-{uuid.uuid4().hex[:6]}",
                                  halflife_s=1.0)
    for i in range(10):
        est.observe_drained(1, now=base - 500.0 + i)
    est.update_worker(1, 50, now=base)
    return est


def test_refusal_raises_and_counts():
    est = _stalled()
    before = REQUESTS_SHED.labels(reason="queue").get()
    tenant_before = TENANT_SHED.labels(tenant="acme", reason="queue").get()
    with pytest.raises(port.AdmissionRefused) as info:
        port.check_admission(est, Deadline(5.0), tenant="acme")
    assert info.value.retry_after_s == 30.0 and info.value.pool == est.pool
    assert info.value.reason == "queue"
    assert REQUESTS_SHED.labels(reason="queue").get() == before + 1
    assert TENANT_SHED.labels(tenant="acme",
                              reason="queue").get() == tenant_before + 1


def test_disabled_admits_unconditionally(monkeypatch):
    monkeypatch.setenv("DYNT_ADMISSION_ENABLE", "0")
    assert not port.admission_enabled() and not ref.admission_enabled()
    assert port.check_admission(_stalled(), Deadline(5.0)).admit


# -- TenantLedger -------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_tenant_ledger_equals_the_reference(seed):
    """Observations from weighted tenants over a sliding window: the same
    rates, shares and verdicts (reason and Retry-After included)."""
    rng = random.Random(seed)
    weights = {"gold": 3.0, "bronze": 1.0}
    capacity, window = rng.choice(((1000.0, 10.0), (100.0, 2.0)))
    a = port.TenantLedger(capacity_tps=capacity, window_s=window,
                          weights=weights, default_weight=1.0)
    b = ref.TenantLedger(capacity_tps=capacity, window_s=window,
                         weights=weights, default_weight=1.0)
    tenants = ("gold", "bronze", "flood", "")
    t = 0.0
    for _ in range(200):
        t += rng.choice((0.0, 0.1, 0.5, 2.0, window))
        tenant = rng.choice(tenants)
        tokens = rng.choice((0, 50, 500, 4000))
        if rng.random() < 0.5:
            a.observe(tenant, tokens, now=t)
            b.observe(tenant, tokens, now=t)
        contended = rng.random() < 0.5
        da = a.check(tenant, tokens, contended=contended, now=t)
        db = b.check(tenant, tokens, contended=contended, now=t)
        assert (da.admit, da.retry_after_s, da.reason) == (
            db.admit, db.retry_after_s, db.reason)
        for name in tenants[:3]:
            assert a.rate(name, now=t) == b.rate(name, now=t)
            assert a.share(name, now=t) == b.share(name, now=t)
        assert a.total_rate(now=t) == b.total_rate(now=t)


def test_over_share_refused_under_contention():
    ledger = port.TenantLedger(capacity_tps=1000.0, window_s=10.0,
                               weights={}, default_weight=1.0)
    ledger.observe("flood", 8000, now=0.0)
    assert ledger.check("flood", 1000, contended=True, now=0.0).admit
    ledger.observe("victim", 4000, now=0.0)
    flood = ledger.check("flood", 500, contended=True, now=0.0)
    assert not flood.admit and "fair share" in flood.reason
    assert flood.retry_after_s >= 1.0
    assert ledger.check("victim", 500, contended=True, now=0.0).admit
    assert ledger.check("", 10_000, contended=True, now=0.0).admit
    assert port.TenantLedger(capacity_tps=0.0).check(
        "flood", 10_000, contended=True).admit


def test_check_tenant_admission_counts_and_observes():
    ledger = port.TenantLedger(capacity_tps=100.0, window_s=10.0,
                               weights={}, default_weight=1.0)
    now = time.monotonic()
    ledger.observe("flood", 2000, now=now)
    ledger.observe("peer", 500, now=now)
    before = TENANT_SHED.labels(tenant="flood", reason="quota").get()
    before_q = REQUESTS_SHED.labels(reason="quota").get()
    with pytest.raises(port.AdmissionRefused) as info:
        port.check_tenant_admission(ledger, "flood", 100, contended=True)
    assert info.value.reason == "quota" and info.value.pool == "tenant"
    assert TENANT_SHED.labels(tenant="flood",
                              reason="quota").get() == before + 1
    assert REQUESTS_SHED.labels(reason="quota").get() == before_q + 1
    big = port.TenantLedger(capacity_tps=10_000.0, window_s=10.0,
                            weights={}, default_weight=1.0)
    port.check_tenant_admission(big, "a", 100, observe=False)
    assert big.rate("a") == 0.0
    port.check_tenant_admission(big, "a", 100, observe=True)
    assert big.rate("a") > 0.0


@pytest.mark.parametrize("spec", ["a=4,b=1.5", "a=4,junk,c=-1,=2,d=x", "",
                                  " x = 2 , y=0 ,z=1e1"])
def test_parse_weights_equal_the_reference(spec):
    assert port.parse_tenant_weights(spec) == ref.parse_tenant_weights(spec)


def test_ledger_reads_the_knobs_and_singleton_resets(monkeypatch):
    monkeypatch.setenv("DYNT_TENANT_RATE_LIMIT", "250")
    monkeypatch.setenv("DYNT_TENANT_WINDOW_SECS", "4")
    monkeypatch.setenv("DYNT_TENANT_WEIGHTS", "a=2,b=1")
    monkeypatch.setenv("DYNT_TENANT_DEFAULT_WEIGHT", "0.5")
    a, b = port.TenantLedger(), ref.TenantLedger()
    assert (a.capacity, a.window_s, a.weights, a.default_weight) == (
        b.capacity, b.window_s, b.weights, b.default_weight)
    port.reset_tenant_ledger()
    first = port.get_tenant_ledger()
    assert port.get_tenant_ledger() is first and first.capacity == 250.0
    port.reset_tenant_ledger()
    assert port.get_tenant_ledger() is not first
    port.reset_tenant_ledger()


# -- the router queue edge ------------------------------------------------------


BS = 16
W0 = WorkerWithDpRank(1)


def _queue() -> SchedulerQueue:
    return SchedulerQueue(KvScheduler(KvRouterConfig(block_size=BS)),
                          threshold_frac=0.5,
                          max_batched_tokens=lambda w: 100)


def test_park_with_surviving_budget_still_parks(run):
    async def body():
        q = _queue()
        await q.schedule(QueuedRequest(candidates=[W0], block_hashes=[],
                                       isl_tokens=96, request_id="warm"))
        task = asyncio.create_task(q.schedule(QueuedRequest(
            candidates=[W0], block_hashes=[], isl_tokens=8,
            request_id="r1", deadline=Deadline(60.0))))
        await asyncio.sleep(0.05)
        assert q.pending_count == 1
        assert q.wait_estimator.drain.rate() is None  # cold
        q.scheduler.free("warm")
        q.update()
        assert (await asyncio.wait_for(task, 2.0)).worker == W0
        assert q.wait_estimator.drain.rate() is not None

    run(body())


def test_park_with_doomed_budget_refused(run):
    async def body():
        q = _queue()
        for i in range(10):
            q.wait_estimator.observe_drained(1, now=float(i))
        q.wait_estimator.drain._last = -1000.0  # a long-dead drain
        await q.schedule(QueuedRequest(candidates=[W0], block_hashes=[],
                                       isl_tokens=96, request_id="warm"))
        parked = asyncio.create_task(q.schedule(QueuedRequest(
            candidates=[W0], block_hashes=[], isl_tokens=8,
            request_id="r1")))
        await asyncio.sleep(0.05)
        assert q.pending_count == 1
        with pytest.raises(port.AdmissionRefused):
            await q.schedule(QueuedRequest(
                candidates=[W0], block_hashes=[], isl_tokens=8,
                request_id="r2", deadline=Deadline(2.0)))
        assert q.pending_count == 1
        parked.cancel()
        with pytest.raises(asyncio.CancelledError):
            await parked

    run(body())


def test_over_share_tenant_refused_before_parking(run, monkeypatch):
    monkeypatch.setenv("DYNT_TENANT_RATE_LIMIT", "100")
    port.reset_tenant_ledger()

    async def body():
        ledger = port.get_tenant_ledger()
        ledger.observe("flood", 2000)
        ledger.observe("peer", 500)
        q = _queue()
        await q.schedule(QueuedRequest(candidates=[W0], block_hashes=[],
                                       isl_tokens=96, request_id="warm"))
        with pytest.raises(port.AdmissionRefused) as info:
            await q.schedule(QueuedRequest(
                candidates=[W0], block_hashes=[], isl_tokens=8,
                request_id="r1", tenant="flood"))
        assert info.value.reason == "quota" and q.pending_count == 0
        task = asyncio.create_task(q.schedule(QueuedRequest(
            candidates=[W0], block_hashes=[], isl_tokens=8,
            request_id="r2", tenant="peer")))
        await asyncio.sleep(0.05)
        assert q.pending_count == 1
        q.scheduler.free("warm")
        q.update()
        await asyncio.wait_for(task, 2.0)

    try:
        run(body())
    finally:
        port.reset_tenant_ledger()


# -- the frontend edge ----------------------------------------------------------


def test_first_token_observes_drain():
    est = port.QueueWaitEstimator(pool="obs")
    obs = _LatencyObserver("m", est)
    obs.on_output(EngineOutput(token_ids=[]))
    assert est.drain._last is None
    obs.on_output(EngineOutput(token_ids=[5]))
    first = est.drain._last
    assert first is not None
    obs.on_output(EngineOutput(token_ids=[6]))
    assert est.drain._last == first


def _post(port_: int, body: dict, headers: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port_, timeout=30)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **headers})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def test_frontends_shed_as_the_reference(run, tmp_path):
    """Both packages' frontends over one fake worker: a spent budget, a
    budget below the forced queue estimate, and a patient request, with the
    same statuses, Retry-After values and bodies."""

    async def fake_generate(body, ctx):
        yield EngineOutput(token_ids=[7], finish_reason="length",
                           prompt_tokens=len(body["token_ids"])).to_wire()

    async def body():
        root = str(tmp_path / "disc")
        wrt = await DistributedRuntime(RuntimeConfig(
            discovery_backend="file", discovery_path=root,
            tcp_host="127.0.0.1", system_enabled=False)).start()
        frt = await DistributedRuntime(RuntimeConfig(
            discovery_backend="file", discovery_path=root,
            tcp_host="127.0.0.1", system_enabled=False)).start()
        rrt = await RefRuntime(RefRuntimeConfig.from_env(
            discovery_backend="file", discovery_path=root,
            request_plane="tcp", tcp_host="127.0.0.1", event_plane="mem",
            system_enabled=False)).start()
        card = ModelDeploymentCard(name="adm")
        fes = [Frontend(frt, host="127.0.0.1", port=0),
               RefFrontend(rrt, host="127.0.0.1", port=0)]
        try:
            ep = wrt.namespace(card.namespace).component(
                card.component).endpoint(card.endpoint)
            await ep.serve_endpoint(fake_generate, instance_id=11)
            await publish_card(wrt, card, 11)
            for fe in fes:
                await fe.start()
                while fe.manager.get("adm") is None:
                    await asyncio.sleep(0.05)
            payload = {"model": "adm", "prompt": "hello", "max_tokens": 1}
            out = []
            for fe in fes:
                got = [await asyncio.to_thread(
                    _post, fe.port, payload,
                    {"x-dynt-deadline-ms": "30000"})]
                # ~1 drain every 2 s learned, 30 queued: ~60 s of wait
                entry = fe.manager.get("adm")
                est = entry.wait_estimator
                base = time.monotonic()
                for i in range(10):
                    est.observe_drained(1, now=base - 20.0 + i * 2.0)
                est.drain._last = base
                est.update_worker(11, 30)
                for headers in ({"x-dynt-deadline-ms": "2000"},
                                {"x-dynt-deadline-ms": "0"},
                                {"x-dynt-deadline-ms": "300000"}):
                    got.append(await asyncio.to_thread(
                        _post, fe.port, payload, headers))
                out.append(got)
            return out
        finally:
            for fe in fes:
                await fe.close()
            for rt in (rrt, frt, wrt):
                await rt.shutdown()

    mine, theirs = run(body(), timeout=60)
    assert [s for s, _, _ in mine] == [s for s, _, _ in theirs] == [
        200, 503, 503, 200]
    for (s, h, b), (s2, h2, b2) in zip(mine, theirs):
        if s == 503:
            assert h["Retry-After"] == h2["Retry-After"] == "30"
            msg, ref_msg = b["error"]["message"], b2["error"]["message"]
            assert b["error"]["type"] == b2["error"]["type"] == "overloaded"
            # the estimate in the message moves with the clock between
            # the two frontends; the wording is the reference's
            assert msg.split(" ")[:3] == ref_msg.split(" ")[:3]
        else:
            assert b["choices"][0]["text"] == b2["choices"][0]["text"]
            assert b["usage"] == b2["usage"]
    assert "queue wait" in mine[1][2]["error"]["message"]
    assert mine[2][2]["error"]["message"] == "request deadline already spent"


@pytest.mark.parametrize("side", ["port", "ref"])
def test_a_removed_worker_leaves_the_estimate(run, side):
    """The port's manager forgets a deleted worker's published backlog at
    once; the reference's keeps counting it until the estimator's 30 s TTL
    (ROADMAP.md Queue 3). Both zero a draining worker's."""
    if side == "port":
        from dynamo_tpu_torch.llm import manager as mod
        from dynamo_tpu_torch.llm.model_card import (
            ModelDeploymentCard as Card,
        )
    else:
        from dynamo_tpu.llm import manager as mod
        from dynamo_tpu.llm.model_card import ModelDeploymentCard as Card

    class _Router:
        def set_draining(self, iid, draining=True):
            return True

    async def body():
        models = mod.ModelManager()
        watcher = mod.ModelWatcher(None, models)
        card = Card(name="m")
        entry = mod.ModelEntry(card=card, preprocessor=None, engine=None,
                               router=_Router(), scheduler=None)
        entry.instances = {1, 2, 3}
        models.register(entry)
        for iid, waiting in ((1, 10), (2, 5), (3, 7)):
            entry.wait_estimator.update_worker(iid, waiting)
        await watcher._handle_delete(card.card_key(1))
        after_delete = entry.wait_estimator.depth()
        watcher._mark_draining(entry, 3)
        return after_delete, entry.wait_estimator.depth()

    after_delete, after_drain = run(body())
    assert after_delete == (12 if side == "port" else 22)
    assert after_drain == (5 if side == "port" else 15)
