"""The port's runtime (discovery, TCP request plane, endpoints, PushRouter,
metrics, HTTP and status servers) against the JAX package's runtime, in both
directions where the two meet on the wire. Binds 127.0.0.1 only."""

import asyncio
import json
import random
import uuid

import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu.runtime import discovery as ref_discovery
from dynamo_tpu.runtime import push_router as ref_push_router
from dynamo_tpu.runtime import request_plane as ref_rp
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime import discovery, metrics, push_router
from dynamo_tpu_torch.runtime import request_plane as rp
from dynamo_tpu_torch.runtime.http import (
    HttpServer,
    Request,
    Response,
    json_response,
)
from dynamo_tpu_torch.runtime.status import SystemStatusServer

W = 10.0  # bound on each await


async def _next_event(watch):
    return await asyncio.wait_for(watch.__anext__(), W)


# -- discovery ---------------------------------------------------------------


def _mem():
    return discovery.MemDiscovery(cluster=uuid.uuid4().hex,
                                  reaper_interval=0.05)


def _file(root):
    return discovery.FileDiscovery(str(root), poll_interval=0.05)


@pytest.mark.parametrize("backend", ["mem", "file"])
def test_discovery_put_watch_and_lease_expiry(run, tmp_path, backend):
    async def go():
        disc = _mem() if backend == "mem" else _file(tmp_path)
        await disc.start()
        try:
            lease = await disc.create_lease(0.3)
            await disc.put("v1/instances/ns/c/e/1", {"a": 1}, lease)
            await disc.put("v1/other/x", {"b": 2})
            watch = await disc.watch_prefix("v1/instances/")
            first = await _next_event(watch)
            assert (first.kind, first.key, first.value) == (
                "put", "v1/instances/ns/c/e/1", {"a": 1})
            await disc.put("v1/instances/ns/c/e/2", {"a": 2}, lease)
            second = await _next_event(watch)
            assert (second.kind, second.value) == ("put", {"a": 2})
            assert set(await disc.get_prefix("v1/instances/")) == {
                "v1/instances/ns/c/e/1", "v1/instances/ns/c/e/2"}
            # no keep-alive: both leased keys expire, the unleased one stays
            gone = {(await _next_event(watch)).key for _ in range(2)}
            assert gone == {"v1/instances/ns/c/e/1", "v1/instances/ns/c/e/2"}
            assert await disc.get_prefix("v1/") == {"v1/other/x": {"b": 2}}
            with pytest.raises(discovery.LeaseExpired):
                await disc.keep_alive(lease)
            await watch.cancel()
        finally:
            await disc.close()

    run(go())


def test_discovery_keep_alive_holds_the_lease(run, tmp_path):
    async def go():
        disc = _file(tmp_path)
        await disc.start()
        try:
            lease = await disc.create_lease(0.3)
            await disc.put("k", {"v": 1}, lease)
            for _ in range(8):
                await asyncio.sleep(0.1)
                await disc.keep_alive(lease)
            assert await disc.get_prefix("k") == {"k": {"v": 1}}
            await disc.revoke_lease(lease)
            assert await disc.get_prefix("k") == {}
        finally:
            await disc.close()

    run(go())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_file_trees_are_read_across_packages(run, tmp_path, writer):
    """One package writes records under a lease, the other reads them and
    reaps them when the lease expires; the trees are the same files."""

    async def go():
        port = _file(tmp_path)
        ref = ref_discovery.FileDiscovery(str(tmp_path), poll_interval=0.05)
        w, r = (port, ref) if writer == "port" else (ref, port)
        await w.start()
        await r.start()
        try:
            record = {"instance_id": 7, "address": "tcp://127.0.0.1:1",
                      "subject": "ns/c/generate/7", "endpoint": "ns/c/generate",
                      "started_at": 1.5, "system_url": "",
                      "metadata": {"k": [1, 2]}}
            lease = await w.create_lease(0.4)
            await w.put("v1/instances/ns/c/generate/7", record, lease)
            watch = await r.watch_prefix("v1/instances/")
            event = await _next_event(watch)
            assert (event.kind, event.value) == ("put", record)
            assert await r.get_prefix("v1/") == {
                "v1/instances/ns/c/generate/7": record}
            await w.close()  # the owner dies: no more keep-alives
            event = await _next_event(watch)
            assert (event.kind, event.key) == (
                "delete", "v1/instances/ns/c/generate/7")
            await watch.cancel()
        finally:
            await w.close()
            await r.close()

    run(go())


def test_unported_discovery_backends_raise():
    for backend in ("etcd", "kube"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            discovery.make_discovery(backend)
    with pytest.raises(ValueError):
        discovery.make_discovery("zookeeper")


# -- TCP request plane ------------------------------------------------------

PKGS = {"port": rp, "reference": ref_rp}
PAIRS = [(s, c) for s in PKGS for c in PKGS]


async def _counting(body, ctx):
    for i in range(body["n"]):
        yield {"i": i, "echo": body["echo"]}


async def _failing(body, ctx):
    yield {"i": 0}
    raise ValueError("boom")


def _server_client(server_pkg, client_pkg):
    server = PKGS[server_pkg].TcpRequestServer("127.0.0.1", 0)
    client = PKGS[client_pkg].TcpRequestClient(connect_timeout=W)
    return server, client


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_request_plane_stream_error_and_ping(run, server_pkg, client_pkg):
    async def go():
        server, client = _server_client(server_pkg, client_pkg)
        await server.start()
        server.registry.register("ns/c/count", _counting)
        server.registry.register("ns/c/fail", _failing)
        try:
            got = [item async for item in client.call(
                server.address, "ns/c/count", {"n": 5, "echo": "é" * 40})]
            assert got == [{"i": i, "echo": "é" * 40} for i in range(5)]
            items = []
            with pytest.raises(PKGS[client_pkg].RemoteError) as err:
                async for item in client.call(server.address, "ns/c/fail",
                                              {}):
                    items.append(item)
            assert items == [{"i": 0}] and "boom" in str(err.value)
            with pytest.raises(PKGS[client_pkg].EndpointNotFound):
                async for _ in client.call(server.address, "ns/c/none", {}):
                    pass
            rtt = await client.ping(server.address)
            assert 0.0 <= rtt < W
        finally:
            await client.close()
            await server.close()

    run(go())


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_request_plane_cancel_reaches_the_handler(run, server_pkg,
                                                  client_pkg):
    """Closing the response stream early sends a `cancel` frame: the
    handler's generator is closed on the server."""

    async def go():
        server, client = _server_client(server_pkg, client_pkg)
        closed = asyncio.Event()

        async def endless(body, ctx):
            try:
                i = 0
                while True:
                    yield {"i": i}
                    i += 1
                    await asyncio.sleep(0.01)
            finally:
                closed.set()

        await server.start()
        server.registry.register("ns/c/endless", endless)
        try:
            stream = client.call(server.address, "ns/c/endless", {})
            assert (await stream.__anext__())["i"] == 0
            assert (await stream.__anext__())["i"] == 1
            await stream.aclose()
            await asyncio.wait_for(closed.wait(), W)
        finally:
            await client.close()
            await server.close()

    run(go())


def test_mem_request_plane_round_trips(run):
    async def go():
        server = rp.MemRequestPlane.create_server()
        server.registry.register("s", _counting)
        client = rp.RequestClient()
        got = [x async for x in client.call(server.address, "s",
                                            {"n": 2, "echo": b"\x00"})]
        await server.close()
        with pytest.raises(rp.ConnectionLost):
            async for _ in client.call(server.address, "s", {}):
                pass
        return got

    assert run(go()) == [{"i": 0, "echo": b"\x00"}, {"i": 1, "echo": b"\x00"}]


# -- components over discovery, across packages ------------------------------


def _port_rt(root):
    return DistributedRuntime(RuntimeConfig(
        discovery_backend="file", discovery_path=str(root),
        tcp_host="127.0.0.1", lease_ttl_secs=2.0, system_enabled=False))


def _ref_rt(root):
    return RefRuntime(RefRuntimeConfig.from_env(
        discovery_backend="file", discovery_path=str(root),
        request_plane="tcp", tcp_host="127.0.0.1", lease_ttl_secs=2.0,
        event_plane="mem", system_enabled=False))


@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_served_endpoint_is_routed_across_packages(run, tmp_path,
                                                    server_pkg):
    """An endpoint served by one package is found through discovery and
    routed to by the other package's Client and PushRouter; shutdown
    withdraws the instance record."""

    async def go():
        server_rt, client_rt = ((_port_rt(tmp_path), _ref_rt(tmp_path))
                                if server_pkg == "port"
                                else (_ref_rt(tmp_path), _port_rt(tmp_path)))
        await server_rt.start()
        await client_rt.start()
        try:
            served = await (server_rt.namespace("ns").component("c")
                            .endpoint("count").serve_endpoint(_counting))
            client = (client_rt.namespace("ns").component("c")
                      .endpoint("count").client())
            ids = await client.wait_for_instances(1, timeout=W)
            assert ids == [served.instance_id]
            router_mod = (ref_push_router if server_pkg == "port"
                          else push_router)
            router = router_mod.PushRouter(client, mode="round_robin")
            got = [x async for x in router.generate({"n": 3, "echo": 1})]
            assert got == [{"i": i, "echo": 1} for i in range(3)]
            await served.shutdown()
            for _ in range(200):
                if not client.instances:
                    break
                await asyncio.sleep(0.05)
            assert client.instances == {}
            await client.close()
        finally:
            await client_rt.shutdown()
            await server_rt.shutdown()

    run(go())


# -- PushRouter against the reference's --------------------------------------


class _Endpoint:
    subject = "ns/c/generate"


class _StubClient:
    """The instance set a router selects from."""

    def __init__(self, ids):
        self.endpoint = _Endpoint()
        self.instances = {i: {"instance_id": i} for i in ids}
        self.listeners = []

    def instance_ids(self):
        return sorted(self.instances)

    def on_change(self, fn):
        self.listeners.append(fn)

    async def start(self):
        pass


IDS = [0x51, 0x12, 0x7FFF, 0x3]


def _routers(mode, monkeypatch):
    monkeypatch.setenv("DYNT_BREAKER_RESET_SECS", "0.2")
    return (push_router.PushRouter(_StubClient(IDS), mode=mode),
            ref_push_router.PushRouter(_StubClient(IDS), mode=mode))


def test_round_robin_and_random_pick_as_the_reference(run, monkeypatch):
    async def go():
        out = {}
        for mode in ("round_robin", "random"):
            port, ref = _routers(mode, monkeypatch)
            random.seed(11)
            mine = [await port._pick(None, None) for _ in range(13)]
            random.seed(11)
            theirs = [await ref._pick(None, None) for _ in range(13)]
            out[mode] = (mine, theirs)
        return out

    out = run(go())
    for mode, (mine, theirs) in out.items():
        assert mine == theirs, mode
        assert set(mine) == set(IDS)
    assert out["round_robin"][0][:4] == sorted(IDS)


def test_direct_and_explicit_targets(run, monkeypatch):
    async def go():
        port, ref = _routers("direct", monkeypatch)
        assert await port._pick(None, 0x12) == await ref._pick(None, 0x12) \
            == 0x12
        with pytest.raises(ValueError):
            await port._pick(None, None)
        rr, ref_rr = _routers("round_robin", monkeypatch)
        rr.mark_down(0x12)
        ref_rr.mark_down(0x12)
        with pytest.raises(push_router.NoInstancesAvailable):
            await rr._pick(None, 0x12)
        with pytest.raises(ref_push_router.NoInstancesAvailable):
            await ref_rr._pick(None, 0x12)

    run(go())


def test_mark_down_as_the_reference(run, monkeypatch):
    """A marked-down instance leaves rotation until discovery re-confirms it
    or the cooldown (the reference's breaker reset) passes."""

    async def go():
        port, ref = _routers("round_robin", monkeypatch)
        for router in (port, ref):
            router.mark_down(0x51)
            router.mark_down(0x3)
        assert port.available() == ref.available() == [0x12, 0x7FFF]
        for router in (port, ref):
            for fn in router.client.listeners:
                fn("put", {"instance_id": 0x51})
        assert port.available() == ref.available() == [0x12, 0x51, 0x7FFF]
        await asyncio.sleep(0.3)
        assert port.available() == ref.available() == sorted(IDS)
        for router in (port, ref):
            for iid in IDS:
                router.mark_down(iid)
        with pytest.raises(push_router.NoInstancesAvailable):
            await port._pick(None, None)
        with pytest.raises(ref_push_router.NoInstancesAvailable):
            await ref._pick(None, None)

    run(go())


@pytest.mark.parametrize("mode", ["p2c", "kv"])
def test_p2c_and_kv_modes_pick_as_the_reference(run, monkeypatch, mode):
    """p2c: the less loaded of two random instances by local in-flight
    counts; kv: the selector's choice among the available instances, an
    explicit target honoured while it is live. Both as the reference's."""
    seen = {"port": [], "ref": []}

    def selector(side):
        async def select(body, avail):
            seen[side].append((body, list(avail)))
            return avail[body % len(avail)]
        return select

    async def go():
        port = push_router.PushRouter(_StubClient(IDS), mode=mode,
                                      selector=selector("port"))
        ref = ref_push_router.PushRouter(_StubClient(IDS), mode=mode,
                                         selector=selector("ref"))
        loads = {0x51: 3, 0x12: 0, 0x7FFF: 1, 0x3: 2}
        port._inflight.update(loads)
        ref._inflight.update(loads)
        port.mark_down(0x7FFF)
        ref.mark_down(0x7FFF)
        random.seed(5)
        mine = [await port._pick(i, None) for i in range(17)]
        random.seed(5)
        theirs = [await ref._pick(i, None) for i in range(17)]
        explicit = (await port._pick(3, 0x3), await ref._pick(3, 0x3))
        return mine, theirs, explicit

    mine, theirs, explicit = run(go())
    assert mine == theirs
    assert 0x7FFF not in mine
    assert explicit == (0x3, 0x3)
    if mode == "p2c":
        assert set(mine) <= {0x12, 0x3, 0x51} and 0x12 in mine
    else:
        assert seen["port"] == seen["ref"] == [
            (i, [0x3, 0x12, 0x51]) for i in range(17)]


# -- metrics -----------------------------------------------------------------


def test_metrics_render_the_text_format():
    reg = metrics.Registry()
    c = metrics.Counter("t_requests_total", "Requests", ["model", "status"],
                        registry=reg)
    g = metrics.Gauge("t_inflight", "In flight", ["pool"], registry=reg)
    h = metrics.Histogram("t_latency_seconds", "Latency", ["model"],
                          registry=reg, buckets=(0.1, 1.0))
    c.labels(model='a"b\\c', status="ok").inc()
    c.labels(model='a"b\\c', status="ok").inc(2)
    g.labels(pool="p").set(3)
    g.labels(pool="p").inc(-1)
    for v in (0.05, 0.5, 5.0):
        h.labels(model="m").observe(v)
    fams = {f.name: f for f in text_string_to_metric_families(
        reg.render().decode())}
    (req,) = [s for s in fams["t_requests"].samples
              if s.name == "t_requests_total"]
    assert req.labels == {"model": 'a"b\\c', "status": "ok"}
    assert req.value == 3.0
    assert fams["t_inflight"].samples[0].value == 2.0
    lat = {(s.name, s.labels.get("le")): s.value
           for s in fams["t_latency_seconds"].samples}
    assert lat[("t_latency_seconds_bucket", "0.1")] == 1
    assert lat[("t_latency_seconds_bucket", "1.0")] == 2
    assert lat[("t_latency_seconds_bucket", "+Inf")] == 3
    assert lat[("t_latency_seconds_count", None)] == 3
    assert lat[("t_latency_seconds_sum", None)] == pytest.approx(5.55)
    with pytest.raises(ValueError):
        c.labels(model="x")
    with pytest.raises(ValueError):
        metrics.Counter("t_requests_total", "again", registry=reg)


def test_metric_families_match_the_reference():
    from dynamo_tpu.runtime import metrics as ref_metrics

    for name in ("REQUESTS_TOTAL", "REQUEST_DURATION", "INFLIGHT",
                 "TTFT_SECONDS", "ITL_SECONDS", "INPUT_TOKENS",
                 "OUTPUT_TOKENS"):
        mine, theirs = getattr(metrics, name), getattr(ref_metrics, name)
        ref_name = theirs._name + ("_total"
                                   if theirs._type == "counter" else "")
        assert mine.name == ref_name
        assert mine.doc == theirs._documentation
        assert mine.labelnames == theirs._labelnames
        if mine.kind == "histogram":
            assert list(mine.buckets) == list(theirs._upper_bounds)


def test_endpoint_metrics_count_by_status(run):
    em = metrics.EndpointMetrics("ns-t", "comp", "ep")

    def count(status):
        return metrics.REQUESTS_TOTAL.labels(
            namespace="ns-t", component="comp", endpoint="ep",
            status=status).get()

    before = count("ok")
    em.observe_request(0.0, "ok")
    assert count("ok") - before == 1
    text = metrics.render().decode()
    assert ('dynamo_requests_total{namespace="ns-t",component="comp",'
            'endpoint="ep",status="ok"} ') in text
    assert "# TYPE dynamo_inflight_requests gauge" in text


# -- HTTP and status servers -------------------------------------------------


async def _http(port, raw: bytes, read_until_close=True) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(raw)
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), W) if read_until_close \
        else b""
    writer.close()
    return data


def test_http_server_keep_alive_limits_and_errors(run):
    async def echo(request: Request) -> Response:
        return json_response({"path": request.path,
                              "body": request.json()})

    async def go():
        server = HttpServer({("POST", "/echo"): echo}, "127.0.0.1", 0)
        await server.start()
        try:
            body = b'{"a": 1}'
            one = (b"POST /echo?x=1 HTTP/1.1\r\nContent-Length: %d\r\n\r\n%s"
                   % (len(body), body))
            last = (b"POST /echo HTTP/1.1\r\nConnection: close\r\n"
                    b"Content-Length: 2\r\n\r\n[]")
            both = await _http(server.port, one + last)
            assert both.count(b"HTTP/1.1 200 OK") == 2
            assert b'{"path": "/echo", "body": {"a": 1}}' in both
            assert both.endswith(b'"body": []}')
            big = b"POST /echo HTTP/1.1\r\nContent-Length: %d\r\n\r\n" % (
                2 * 1024 ** 2)
            assert (await _http(server.port, big)).startswith(
                b"HTTP/1.1 413")
            assert (await _http(server.port, b"garbage\r\n\r\n")).startswith(
                b"HTTP/1.1 400")
            nf = await _http(server.port, b"GET /x HTTP/1.1\r\n"
                                          b"Connection: close\r\n\r\n")
            assert nf.startswith(b"HTTP/1.1 404") and nf.endswith(
                b"404: Not Found")
            na = await _http(server.port, b"GET /echo HTTP/1.1\r\n"
                                          b"Connection: close\r\n\r\n")
            assert na.startswith(b"HTTP/1.1 405")
            bad = await _http(server.port, b"POST /echo HTTP/1.1\r\n"
                              b"Connection: close\r\n"
                              b"Content-Length: 3\r\n\r\n{x}")
            assert bad.startswith(b"HTTP/1.1 500")
        finally:
            await server.close()

    run(go())


def test_http_client_disconnect_cancels_the_handler(run):
    async def go():
        started, cancelled = asyncio.Event(), asyncio.Event()

        async def slow(request: Request) -> Response:
            started.set()
            try:
                await asyncio.sleep(3600)
            except asyncio.CancelledError:
                cancelled.set()
                raise
            return Response("late")

        server = HttpServer({("GET", "/slow"): slow}, "127.0.0.1", 0)
        await server.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           server.port)
            writer.write(b"GET /slow HTTP/1.1\r\n\r\n")
            await writer.drain()
            await asyncio.wait_for(started.wait(), W)
            writer.close()
            await asyncio.wait_for(cancelled.wait(), W)
        finally:
            await server.close()

    run(go())


def test_status_server_health_live_metrics(run):
    async def go():
        status = SystemStatusServer(0, host="127.0.0.1")
        await status.start()
        try:
            healthy = {"ok": True}
            status.register_health("ns/c/e", lambda: healthy["ok"])
            out = {}
            for path in ("/health", "/live", "/metrics"):
                out[path] = await _http(
                    status.port, b"GET %s HTTP/1.1\r\nConnection: close"
                                 b"\r\n\r\n" % path.encode())
            healthy["ok"] = False
            out["sick"] = await _http(
                status.port, b"GET /health HTTP/1.1\r\nConnection: close"
                             b"\r\n\r\n")
            return out
        finally:
            await status.close()

    out = run(go())
    head, body = out["/health"].split(b"\r\n\r\n", 1)
    assert head.startswith(b"HTTP/1.1 200") and json.loads(body) == {
        "status": "healthy", "endpoints": {"ns/c/e": True}}
    assert json.loads(out["/live"].split(b"\r\n\r\n", 1)[1]) == {
        "status": "live"}
    assert b"# TYPE dynamo_requests_total counter" in out["/metrics"]
    assert out["sick"].startswith(b"HTTP/1.1 503")


# -- closing a stream closes the streams it wraps, at once -------------------


def _tracked_stream(closed: list):
    async def stream(*_args, **_kwargs):
        try:
            for i in range(100):
                yield {"t": [i]}
        finally:
            closed.append(True)

    return stream


def test_closing_a_served_stream_closes_the_handler_at_once(run):
    """A cancel that lands while the request plane writes a frame closes the
    served generator at its yield; the handler's own finally (the worker's
    sequence release) must run inside that close, not at garbage
    collection."""
    from dynamo_tpu_torch.runtime.component import Namespace, ServedEndpoint

    async def go():
        closed = []
        endpoint = Namespace(None, "ns").component("c").endpoint("e")
        served = ServedEndpoint(endpoint, 1, _tracked_stream(closed))
        gen = served._wrapped({}, rp.RequestContext(1, {}, "s"))
        assert await gen.__anext__() == {"t": [0]}
        await gen.aclose()
        return list(closed), served._inflight  # before the loop's shutdown

    assert run(go()) == ([True], 0)


def test_closing_the_engine_stream_closes_the_request_stream_at_once(run):
    """RouterEngine -> PushRouter -> the request-plane call: closing the
    outermost stream (the HTTP handler's, when its client goes away while a
    chunk is written) closes the call, which sends the `cancel` frame."""
    from dynamo_tpu_torch.llm.engine import RouterEngine
    from dynamo_tpu_torch.llm.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    async def go():
        closed = []
        client = _StubClient(IDS)
        client.direct = _tracked_stream(closed)
        engine = RouterEngine(push_router.PushRouter(client))
        stream = engine.generate(PreprocessedRequest(
            request_id="r", token_ids=[1], sampling=SamplingOptions(),
            stop=StopConditions()))
        first = await stream.__anext__()
        await stream.aclose()
        return first.token_ids, list(closed)  # before the loop's shutdown

    assert run(go()) == ([0], [True])
