"""The port's resilience primitives against the JAX package's.

`dynamo_tpu_torch/runtime/resilience.py` and its use by the request plane,
the push router and migration, held against `dynamo_tpu/runtime/
resilience.py` (the cases of tests/test_resilience.py): both packages'
Deadline, RetryPolicy, RetryBudget and CircuitBreaker run side by side on
one fake monotonic clock and one seeded random source and must give the
same remaining budgets, wire headers, delays, balances, verdicts and
breaker transitions. Then the wire: deadlines refused before dispatch and
enforced by the server's watchdog, across packages both ways; the client's
stream idle timeout on a black-holed handler; the router's breaker, retry
budget and deadline. Binds 127.0.0.1 only, spawns no subprocess.
"""

import asyncio
import random
import time
import uuid

import pytest

from dynamo_tpu.llm.engine import Migration as RefMigration
from dynamo_tpu.llm.engine import TokenEngine as RefTokenEngine
from dynamo_tpu.llm.protocols import EngineOutput as RefOutput
from dynamo_tpu.llm.protocols import PreprocessedRequest as RefRequest
from dynamo_tpu.llm.protocols import SamplingOptions as RefSampling
from dynamo_tpu.llm.protocols import StopConditions as RefStop
from dynamo_tpu.runtime import resilience as ref
from dynamo_tpu.runtime.request_plane import ConnectionLost as RefLost
from dynamo_tpu.runtime.request_plane import RequestClient as RefClient
from dynamo_tpu.runtime.request_plane import (
    TcpRequestServer as RefTcpServer,
)
from dynamo_tpu_torch.llm.engine import Migration, TokenEngine
from dynamo_tpu_torch.llm.protocols import (
    EngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime import resilience as port
from dynamo_tpu_torch.runtime.push_router import PushRouter
from dynamo_tpu_torch.runtime.request_plane import (
    ConnectionLost,
    EndpointNotFound,
    MemRequestPlane,
    RequestClient,
    TcpRequestServer,
)


class FakeClock:
    """A monotonic clock the test advances by hand."""

    def __init__(self, start: float = 1000.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    # both packages read time.monotonic() at call time
    monkeypatch.setattr(time, "monotonic", fake)
    return fake


# -- Deadline ----------------------------------------------------------------


def test_deadline_counts_down_as_the_reference(clock):
    for budget in (0.5, 2.0, -0.1, 0.0):
        a, b = port.Deadline(budget), ref.Deadline(budget)
        for step in (0.0, 0.1, 0.3, 0.25):
            clock.now += step
            assert a.remaining() == b.remaining()
            assert a.expired() == b.expired()
            for timeout in (None, 0.05, 10.0):
                assert a.bound(timeout) == b.bound(timeout)
            assert a.to_wire() == b.to_wire()


@pytest.mark.parametrize("header", [
    None, {}, {"x-dynt-deadline-ms": "nope"}, {"x-dynt-deadline-ms": "250"},
    {"x-dynt-deadline-ms": 0}, {"x-dynt-deadline-ms": 1999.5},
    {"x-dynt-deadline-ms": None}, {"other": 5}])
def test_deadline_wire_as_the_reference(clock, header):
    a, b = port.Deadline.from_wire(header), ref.Deadline.from_wire(header)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.expires_at == b.expires_at
        assert a.to_wire() == b.to_wire()


def test_deadline_roundtrip_is_relative(clock):
    d = port.Deadline(2.0)
    assert d.to_wire() == {"x-dynt-deadline-ms": 2000}
    clock.now += 0.5
    assert d.to_wire() == {"x-dynt-deadline-ms": 1500}
    again = port.Deadline.from_wire(d.to_wire())
    assert again.remaining() == d.remaining() == 1.5


# -- RetryPolicy and RetryBudget --------------------------------------------


@pytest.mark.parametrize("base,cap", [(0.05, 2.0), (0.01, 0.5), (0.2, 0.3)])
def test_retry_delays_equal_the_reference(base, cap):
    """Decorrelated jitter on one seeded random source: the port's policy
    with an injected Random and with the module source draws the
    reference's delays."""
    ref_policy = ref.RetryPolicy(base_secs=base, cap_secs=cap)
    random.seed(7)
    want, prev = [], None
    for _ in range(40):
        prev = ref_policy.next_delay(prev)
        want.append(prev)
    injected = port.RetryPolicy(base_secs=base, cap_secs=cap,
                                rng=random.Random(7))
    random.seed(7)
    module = port.RetryPolicy(base_secs=base, cap_secs=cap)
    for policy in (injected, module):
        got, prev = [], None
        for _ in range(40):
            prev = policy.next_delay(prev)
            got.append(prev)
        assert got == want
    assert all(base <= d <= cap for d in want)


def test_retry_policy_reads_the_reference_knobs(monkeypatch):
    monkeypatch.setenv("DYNT_RETRY_BACKOFF_BASE_MS", "10")
    monkeypatch.setenv("DYNT_RETRY_BACKOFF_CAP_MS", "250")
    monkeypatch.setenv("DYNT_RETRY_MAX_ATTEMPTS", "6")
    a, b = port.RetryPolicy.from_env(), ref.RetryPolicy.from_env()
    assert (a.base_secs, a.cap_secs, a.max_attempts) == (
        b.base_secs, b.cap_secs, b.max_attempts) == (0.01, 0.25, 6)


@pytest.mark.parametrize("ratio,seed_tokens,cap", [
    (0.5, 0.0, 10.0), (1.0, 2.0, 3.0), (0.2, 3.0, 20.0), (0.1, 1.0, 0.5)])
def test_retry_budget_balances_equal_the_reference(ratio, seed_tokens, cap):
    rng = random.Random(3)
    a = port.RetryBudget(ratio=ratio, min_tokens=seed_tokens, cap=cap)
    b = ref.RetryBudget(ratio=ratio, min_tokens=seed_tokens, cap=cap)
    assert a.balance == b.balance
    for _ in range(200):
        if rng.random() < 0.6:
            a.deposit()
            b.deposit()
        else:
            assert a.try_spend() == b.try_spend()
        assert a.balance == b.balance


def test_retry_budget_deposits_fund_retries():
    budget = port.RetryBudget(ratio=0.5, min_tokens=0.0, cap=10.0)
    assert not budget.try_spend()
    for _ in range(4):
        budget.deposit()
    assert budget.try_spend() and budget.try_spend()
    assert not budget.try_spend()


# -- CircuitBreaker -----------------------------------------------------------


_OPS = ("acquire", "can", "success", "success_probe", "failure",
        "failure_probe", "release", "reset", "tick")


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("threshold,reset_secs", [(1, 5.0), (3, 0.5)])
def test_breaker_transitions_equal_the_reference(clock, seed, threshold,
                                                 reset_secs):
    """A seeded random walk over every breaker operation and the clock:
    the same verdicts, states and transitions in both packages."""
    rng = random.Random(seed)
    seen_port, seen_ref = [], []
    a = port.CircuitBreaker(threshold, reset_secs,
                            on_transition=seen_port.append)
    b = ref.CircuitBreaker(threshold, reset_secs,
                           on_transition=seen_ref.append)
    for _ in range(300):
        op = rng.choice(_OPS)
        if op == "tick":
            clock.now += rng.choice((0.1, reset_secs / 2, reset_secs))
        elif op == "acquire":
            assert a.try_acquire() == b.try_acquire()
        elif op == "can":
            assert a.can_attempt() == b.can_attempt()
        elif op == "success":
            a.record_success()
            b.record_success()
        elif op == "success_probe":
            a.record_success(probe=True)
            b.record_success(probe=True)
        elif op == "failure":
            a.record_failure()
            b.record_failure()
        elif op == "failure_probe":
            a.record_failure(probe=True)
            b.record_failure(probe=True)
        elif op == "release":
            a.release_probe()
            b.release_probe()
        else:
            a.reset()
            b.reset()
        assert a.state == b.state
    assert seen_port == seen_ref
    assert {port.OPEN, port.CLOSED} <= set(seen_port)


def test_breaker_single_probe_recovery(clock):
    transitions = []
    b = port.CircuitBreaker(failure_threshold=2, reset_secs=0.05,
                            on_transition=transitions.append)
    assert b.try_acquire()
    b.record_failure()
    assert b.state == port.CLOSED
    b.record_failure()
    assert b.state == port.OPEN
    assert not b.can_attempt() and not b.try_acquire()
    clock.now += 0.06
    assert b.can_attempt() and b.try_acquire()
    assert b.state == port.HALF_OPEN
    assert not b.try_acquire()
    b.release_probe()
    assert b.try_acquire()
    b.record_failure(probe=True)
    assert b.state == port.OPEN and not b.try_acquire()
    clock.now += 0.06
    assert b.try_acquire()
    b.record_success(probe=True)
    assert b.state == port.CLOSED
    assert transitions == [port.OPEN, port.HALF_OPEN, port.OPEN,
                           port.HALF_OPEN, port.CLOSED]


def test_breaker_board_reads_the_knobs_and_drops(monkeypatch):
    monkeypatch.setenv("DYNT_BREAKER_FAILURES", "2")
    monkeypatch.setenv("DYNT_BREAKER_RESET_SECS", "0.25")
    board = port.BreakerBoard("t/b/gen")
    ref_board = ref.BreakerBoard("t/b/gen")
    assert (board.failure_threshold, board.reset_secs) == (
        ref_board.failure_threshold, ref_board.reset_secs) == (2, 0.25)
    breaker = board.get(5)
    assert board.get(5) is breaker
    breaker.record_failure()
    assert breaker.state == port.CLOSED  # 1 of 2
    breaker.record_failure()
    assert breaker.state == port.OPEN
    board.reset(5)
    assert breaker.state == port.CLOSED
    board.drop(5)
    assert board.get(5) is not breaker


# -- the request plane --------------------------------------------------------


async def _server(kind: str):
    cls = TcpRequestServer if kind == "port" else RefTcpServer
    server = cls("127.0.0.1", 0, advertise_host="127.0.0.1")
    await server.start()
    return server


def _client(kind: str):
    return RequestClient() if kind == "port" else RefClient()


# (server, client) package pairs: the port on both ends, and across
PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.mark.parametrize("server_kind,client_kind", PAIRS)
def test_expired_deadline_refused_before_dispatch(run, server_kind,
                                                  client_kind):
    async def body():
        server = await _server(server_kind)
        dispatched = []

        async def handler(req, ctx):
            dispatched.append(req)
            yield {"ok": True}

        server.registry.register("s/dl", handler)
        client = _client(client_kind)
        try:
            with pytest.raises((port.DeadlineExceeded,
                                ref.DeadlineExceeded)):
                async for _ in client.call(server.address, "s/dl", {},
                                           {"x-dynt-deadline-ms": 0}):
                    pass
            assert dispatched == []
        finally:
            await client.close()
            await server.close()

    run(body())


@pytest.mark.parametrize("server_kind,client_kind", PAIRS)
def test_handler_cancelled_at_deadline(run, server_kind, client_kind):
    async def body():
        server = await _server(server_kind)
        stopped = asyncio.Event()

        async def handler(req, ctx):
            try:
                yield {"first": True}
                await asyncio.sleep(30.0)
                yield {"never": True}
            except asyncio.CancelledError:
                stopped.set()
                raise

        server.registry.register("s/slow", handler)
        client = _client(client_kind)
        got = []
        start = time.monotonic()
        try:
            with pytest.raises((port.DeadlineExceeded,
                                ref.DeadlineExceeded)):
                async for item in client.call(server.address, "s/slow", {},
                                              {"x-dynt-deadline-ms": 300}):
                    got.append(item)
            assert got == [{"first": True}]
            assert time.monotonic() - start < 5.0
            await asyncio.wait_for(stopped.wait(), 2.0)
        finally:
            await client.close()
            await server.close()

    run(body())


def test_context_remaining_exposes_budget(run):
    async def body():
        server = await _server("port")
        seen = {}

        async def handler(req, ctx):
            seen["remaining"] = ctx.remaining()
            seen["default"] = ctx.remaining(default=123.0)
            yield {"ok": True}

        server.registry.register("s/rem", handler)
        client = RequestClient()
        try:
            out = [x async for x in client.call(
                server.address, "s/rem", {}, {"x-dynt-deadline-ms": 5000})]
            assert out == [{"ok": True}]
            assert 0.0 < seen["remaining"] <= 5.0
            assert seen["default"] <= 5.0
            out = [x async for x in client.call(server.address, "s/rem", {})]
            assert out == [{"ok": True}]
            assert seen["remaining"] is None and seen["default"] == 123.0
        finally:
            await client.close()
            await server.close()

    run(body())


def test_mem_plane_refuses_expired(run):
    async def body():
        server = MemRequestPlane.create_server()

        async def handler(req, ctx):
            yield {"ok": True}

        server.registry.register("s/m", handler)
        with pytest.raises(port.DeadlineExceeded):
            async for _ in MemRequestPlane.call(server.address, "s/m", {},
                                                {"x-dynt-deadline-ms": 0}):
                pass
        out = [x async for x in MemRequestPlane.call(
            server.address, "s/m", {}, {"x-dynt-deadline-ms": 5000})]
        assert out == [{"ok": True}]
        await server.close()

    run(body())


@pytest.mark.parametrize("server_kind,client_kind", PAIRS)
@pytest.mark.parametrize("first", [True, False])
def test_idle_timeout_on_a_black_holed_handler(run, monkeypatch, server_kind,
                                               client_kind, first):
    """A handler that stops sending while its connection stays open: the
    client gives up after DYNT_STREAM_IDLE_TIMEOUT_SECS, on the first frame
    or a later one. The port raises ConnectionLost; the reference raises
    asyncio.TimeoutError, which its router and Migration treat alike."""
    monkeypatch.setenv("DYNT_STREAM_IDLE_TIMEOUT_SECS", "0.3")

    async def body():
        server = await _server(server_kind)

        async def handler(req, ctx):
            if not first:
                yield {"first": True}
            await asyncio.sleep(30.0)
            yield {"never": True}

        server.registry.register("s/hole", handler)
        client = _client(client_kind)
        got = []
        start = time.monotonic()
        try:
            want = (ConnectionLost if client_kind == "port"
                    else asyncio.TimeoutError)
            with pytest.raises(want):
                async for item in client.call(server.address, "s/hole", {}):
                    got.append(item)
            assert 0.25 < time.monotonic() - start < 5.0
            assert got == ([] if first else [{"first": True}])
        finally:
            await client.close()
            await server.close()

    run(body())


# -- the router ---------------------------------------------------------------


def _cfg() -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="mem",
                         discovery_path=uuid.uuid4().hex,
                         tcp_host="127.0.0.1", event_plane="mem",
                         system_enabled=False)


async def _fake_instance(rt, ep, instance_id: int) -> None:
    """Advertise an instance whose wire subject has no handler: dialing it
    fails with EndpointNotFound, a transport-class fault."""
    await rt.put_leased(f"{ep.instance_prefix}{instance_id}", {
        "instance_id": instance_id, "address": rt.request_server.address,
        "subject": f"{ep.subject}/{instance_id}", "endpoint": ep.subject})


def test_breaker_opens_and_recovers_via_probe(run):
    async def body():
        rt = await DistributedRuntime(_cfg()).start()
        try:
            async def healthy(req, ctx):
                yield {"ok": True}

            ep = rt.namespace("rz").component("w").endpoint("gen")
            await ep.serve_endpoint(healthy, instance_id=2)
            await _fake_instance(rt, ep, 1)
            client = ep.client()
            await client.wait_for_instances(2, timeout=5.0)
            router = PushRouter(
                client, mode="round_robin",
                retry_policy=port.RetryPolicy(0.001, 0.005, 3),
                retry_budget=port.RetryBudget(ratio=1.0, min_tokens=10.0),
                breakers=port.BreakerBoard("rz/w/gen", failure_threshold=1,
                                           reset_secs=0.2))
            for _ in range(4):
                assert [x async for x in router.generate({})] == [
                    {"ok": True}]
            breaker = router.breakers.get(1)
            assert breaker.state == port.OPEN
            assert router.available() == [2]
            rt.request_server.registry.register(f"{ep.subject}/1", healthy)
            await asyncio.sleep(0.25)
            assert 1 in router.available()
            for _ in range(6):
                assert [x async for x in router.generate({})] == [
                    {"ok": True}]
            assert breaker.state == port.CLOSED
        finally:
            await rt.shutdown()

    run(body(), timeout=30.0)


def test_retry_budget_exhaustion_stops_storm(run):
    async def body():
        rt = await DistributedRuntime(_cfg()).start()
        try:
            ep = rt.namespace("rz2").component("w").endpoint("gen")
            for iid in (1, 2, 3):
                await _fake_instance(rt, ep, iid)
            client = ep.client()
            await client.wait_for_instances(3, timeout=5.0)
            budget = port.RetryBudget(ratio=0.1, min_tokens=1.0)
            router = PushRouter(
                client, mode="round_robin",
                retry_policy=port.RetryPolicy(0.001, 0.002, 10),
                retry_budget=budget,
                breakers=port.BreakerBoard("rz2/w/gen", failure_threshold=99,
                                           reset_secs=0.1))
            with pytest.raises(EndpointNotFound):
                async for _ in router.generate({}):
                    pass
            # one seed token: exactly one retry, then the budget denied
            assert budget.balance < 1.0 and not budget.try_spend()
        finally:
            await rt.shutdown()

    run(body(), timeout=30.0)


def test_router_deadline_bounds_dispatch(run):
    async def body():
        rt = await DistributedRuntime(_cfg()).start()
        try:
            seen = []

            async def handler(req, ctx):
                seen.append(ctx.remaining())
                yield {"ok": True}

            ep = rt.namespace("rz3").component("w").endpoint("gen")
            await ep.serve_endpoint(handler, instance_id=1)
            client = ep.client()
            await client.wait_for_instances(1, timeout=5.0)
            router = PushRouter(client, mode="round_robin")
            out = [x async for x in router.generate(
                {}, deadline=port.Deadline(5.0))]
            assert out == [{"ok": True}]
            assert seen and 0.0 < seen[0] <= 5.0
            with pytest.raises(port.DeadlineExceeded):
                async for _ in router.generate(
                        {}, deadline=port.Deadline(-1.0)):
                    pass
            # the header form reaches the loop too
            with pytest.raises(port.DeadlineExceeded):
                async for _ in router.generate(
                        {}, headers={"x-dynt-deadline-ms": 0}):
                    pass
        finally:
            await rt.shutdown()

    run(body(), timeout=30.0)


def test_failure_after_output_is_not_retried(run):
    """A fault after the first output is raised as ConnectionLost (the
    replay is Migration's), and the instance's breaker records it."""

    async def body():
        rt = await DistributedRuntime(_cfg()).start()
        try:
            calls = []

            async def flaky(req, ctx):
                calls.append(1)
                yield {"tok": 1}
                raise ConnectionLost("peer went away")

            ep = rt.namespace("rz4").component("w").endpoint("gen")
            await ep.serve_endpoint(flaky, instance_id=1)
            client = ep.client()
            await client.wait_for_instances(1, timeout=5.0)
            router = PushRouter(client, mode="round_robin",
                                breakers=port.BreakerBoard("rz4/w/gen", 1,
                                                           60.0))
            got = []
            with pytest.raises(Exception) as info:
                async for item in router.generate({}):
                    got.append(item)
            assert got == [{"tok": 1}] and calls == [1]
            # a handler exception crosses the wire as an application error:
            # the breaker stays closed
            assert not isinstance(info.value, ConnectionLost)
            assert router.breakers.get(1).state == port.CLOSED
        finally:
            await rt.shutdown()

    run(body(), timeout=30.0)


# -- migration under a deadline ----------------------------------------------


@pytest.mark.parametrize("side", ["port", "ref"])
def test_migration_stops_when_budget_spent(run, side):
    """A replay consumes the remaining budget: with the deadline spent the
    overrun is reported, long before the attempt cap."""
    if side == "port":
        base, lost, out_cls = TokenEngine, ConnectionLost, EngineOutput
        req_cls, samp, stop, mig = (PreprocessedRequest, SamplingOptions,
                                    StopConditions, Migration)
        policy, deadline = port.RetryPolicy(0.01, 0.02, 3), port.Deadline
    else:
        base, lost, out_cls = RefTokenEngine, RefLost, RefOutput
        req_cls, samp, stop, mig = RefRequest, RefSampling, RefStop, \
            RefMigration
        policy, deadline = ref.RetryPolicy(0.01, 0.02, 3), ref.Deadline

    class AlwaysBroken(base):
        def __init__(self):
            self.attempts = 0

        async def generate(self, request):
            self.attempts += 1
            yield out_cls(token_ids=[self.attempts])
            raise lost("gone")

    async def body():
        inner = AlwaysBroken()
        migration = mig(inner, migration_limit=10_000, retry_policy=policy)
        request = req_cls(request_id="rz", token_ids=[1, 2],
                          sampling=samp(max_tokens=100), stop=stop(),
                          deadline=deadline(0.05))
        outs = [o async for o in migration.generate(request)]
        assert outs[-1].finish_reason == "error"
        assert "deadline exceeded" in outs[-1].error
        assert inner.attempts < 100

    run(body(), timeout=30.0)
