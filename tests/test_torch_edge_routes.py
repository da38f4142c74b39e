"""The port frontend's /v1/messages, /v1/responses, /busy_threshold,
/clear_kv_blocks, /openapi.json and /docs against the reference frontend's,
over real HTTP and TCP.

Messages and responses go through test_torch_serving's four pairings (a
port frontend -> TorchWorker, b reference frontend -> TorchWorker, c
reference frontend -> TpuWorker, d port frontend -> TpuWorker; tiny-test
f32, the same weights), in the order a, c, b, d, so each worker sees the
same history through both of its frontends. Greedy, so a equals c and b
equals d: the same text, bodies equal but for ids and timestamps, and the
same SSE event names in the same order. `DeltaGenerator.stop_sequence_hit`
is held against the reference's on the same outputs. /clear_kv_blocks fans
out over two port workers in a tree of their own, with both live and with
one whose request plane is gone (its discovery record left behind), and
answers as the reference frontend does on the same tree. Binds 127.0.0.1
only, spawns no subprocess.
"""

import asyncio
import copy
import json

import pytest

from dynamo_tpu.frontend import Frontend as RefFrontend
from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
from dynamo_tpu.llm.preprocessor import DeltaGenerator as RefDeltaGenerator
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as RefPreprocessor
from dynamo_tpu.llm.protocols import EngineOutput as RefOutput
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.frontend import Frontend
from dynamo_tpu_torch.llm.http_service import ROUTES
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import (
    DeltaGenerator,
    OpenAIPreprocessor,
)
from dynamo_tpu_torch.llm.protocols import EngineOutput
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime import DistributedRuntime
from test_torch_serving import (  # noqa: F401 — `stacks` is a fixture
    CFG,
    MODEL,
    RUNNER,
    _LoopThread,
    _port_config,
    _ref_config,
    _request,
    _wait_listed,
    stacks,
)

# volatile fields: ids and timestamps
_VOLATILE = {"id", "created_at"}


def _scrub(value):
    if isinstance(value, dict):
        return {k: _scrub(v) for k, v in value.items() if k not in _VOLATILE}
    if isinstance(value, (list, tuple)):
        return type(value)(_scrub(v) for v in value)
    return value


def _events(text: str) -> list:
    """An SSE body -> [(event name, data)]; every event is named."""
    out = []
    for block in text.split("\n\n"):
        if not block.strip():
            continue
        name, data = block.split("\n", 1)
        assert name.startswith("event: ") and data.startswith("data: ")
        out.append((name[len("event: "):], json.loads(data[len("data: "):])))
    return out


def _answer(port: int, path: str, body: dict):
    status, headers, text = _request(port, "POST", path, body)
    assert status == 200, text
    if body.get("stream"):
        assert headers["Content-Type"] == "text/event-stream"
        return _scrub(_events(text))
    return _scrub(json.loads(text))


REQUESTS = {
    "messages": ("/v1/messages", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6}),
    "messages-stream-system-blocks": ("/v1/messages", {
        "system": [{"type": "text", "text": "be "},
                   {"type": "text", "text": "brief"}],
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "héllo"},
            {"type": "image", "source": {}}]}],
        "max_tokens": 7, "stream": True}),
    "messages-top-k-priority": ("/v1/messages", {
        "messages": [{"role": "user", "content": "x"},
                     {"role": "assistant", "content": "y"},
                     {"role": "user", "content": "z"}],
        "max_tokens": 5, "top_k": 1, "priority": "batch"}),
    "responses": ("/v1/responses", {
        "input": "The quick brown fox", "max_output_tokens": 6}),
    "responses-stream-items": ("/v1/responses", {
        "instructions": "answer", "stream": True, "max_output_tokens": 8,
        "input": [{"role": "user", "content": [
            {"type": "input_text", "text": "a"},
            {"type": "output_text", "text": "b"},
            {"type": "input_image", "image_url": "x"}]},
            {"role": "assistant", "content": "c"}]}),
}

MESSAGES_EVENTS = ["message_start", "content_block_start",
                   "content_block_delta", "content_block_stop",
                   "message_delta", "message_stop"]
RESPONSES_EVENTS = ["response.created", "response.output_text.delta",
                    "response.output_text.done", "response.completed"]


def _dedupe(names: list) -> list:
    return [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n]


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_messages_and_responses_match_the_reference(stacks, name):
    path, body = REQUESTS[name]
    full = {"model": MODEL, "temperature": 0.0, **body}
    got = {w: _answer(stacks["ports"][w], path, copy.deepcopy(full))
           for w in "acbd"}
    assert got["a"] == got["c"], "port stack != reference stack"
    assert got["b"] == got["d"], "cross-package pairings disagree"
    answer = got["a"]
    if full.get("stream"):
        names = _dedupe([n for n, _ in answer])
        assert names == (MESSAGES_EVENTS if path == "/v1/messages"
                         else RESPONSES_EVENTS)
        return
    if path == "/v1/messages":
        assert answer["stop_reason"] == "max_tokens"
        assert answer["usage"]["output_tokens"] == full["max_tokens"]
    else:
        assert answer["status"] == "completed"
        assert answer["usage"]["total_tokens"] == (
            answer["usage"]["input_tokens"] + answer["usage"]["output_tokens"])


def test_stop_sequences_report_stop_sequence(stacks):
    """A stop sequence that fires: stop_reason "stop_sequence" and the
    string, aggregated and streamed, from both stacks."""
    base = {"model": MODEL, "temperature": 0.0, "max_tokens": 12,
            "messages": [{"role": "user", "content": "lazy dog"}]}
    text = _answer(stacks["ports"]["c"], "/v1/messages",
                   base)["content"][0]["text"]
    assert len(text) > 4
    stop = text[2:4]
    for stream in (False, True):
        body = {**base, "stop_sequences": [stop, "\x00never"],
                "stream": stream}
        port = _answer(stacks["ports"]["a"], "/v1/messages", body)
        ref = _answer(stacks["ports"]["c"], "/v1/messages", body)
        assert port == ref
        if stream:
            (delta,) = [d for n, d in port if n == "message_delta"]
            reason = delta["delta"]
        else:
            reason = port
            assert port["content"][0]["text"] == text[:text.index(stop)]
        assert (reason["stop_reason"], reason["stop_sequence"]) == (
            "stop_sequence", stop)


def test_stop_sequence_hit_matches_the_reference():
    """DeltaGenerator records the stop string that fired, as the
    reference's does: of several that complete in one output, the one
    whose match starts first; fed a token at a time, the first to
    complete."""
    card = {"name": "m"}
    port_pre = OpenAIPreprocessor(ModelDeploymentCard(**card))
    ref_pre = RefPreprocessor(RefCard(**card))
    request = {"model": "m", "prompt": "x", "max_tokens": 20,
               "stop": ["cd", "bcde", "zz"]}
    for stream, chunk, want in (("abcdef", 6, "bcde"), ("abcdef", 1, "cd"),
                                ("xxcdx", 2, "cd"), ("abz", 1, None)):
        ids = port_pre.tokenizer.encode(stream)
        assert ids == ref_pre.tokenizer.encode(stream)
        outs = []
        for pre, gen_cls, out_cls in (
                (port_pre, DeltaGenerator, EngineOutput),
                (ref_pre, RefDeltaGenerator, RefOutput)):
            gen = gen_cls(pre, pre.preprocess_completions(dict(request)),
                          kind="completions")
            for i in range(0, len(ids), chunk):
                gen.on_output(out_cls(
                    token_ids=ids[i:i + chunk], finish_reason=(
                        "length" if i + chunk >= len(ids) else None)))
            outs.append((gen.stop_sequence_hit, gen.full_text,
                         gen.finish_reason))
        assert outs[0] == outs[1]
        assert outs[0][0] == want


ERRORS = {
    "messages-no-max-tokens": ("/v1/messages", {
        "model": MODEL, "messages": [{"role": "user", "content": "x"}]}),
    "messages-no-messages": ("/v1/messages", {"model": MODEL,
                                              "max_tokens": 3}),
    "messages-unknown-model": ("/v1/messages", {
        "model": "missing", "max_tokens": 3,
        "messages": [{"role": "user", "content": "x"}]}),
    "messages-bad-temperature": ("/v1/messages", {
        "model": MODEL, "max_tokens": 3, "temperature": 3,
        "messages": [{"role": "user", "content": "x"}]}),
    "responses-no-input": ("/v1/responses", {"model": MODEL}),
    "responses-bad-input": ("/v1/responses", {"model": MODEL, "input": 5}),
    "responses-bad-item": ("/v1/responses", {"model": MODEL,
                                             "input": ["x"]}),
    "responses-too-long": ("/v1/responses", {"model": MODEL,
                                             "input": "x" * 300}),
    "responses-invalid-json": ("/v1/responses", None),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_bodies_match_the_reference(stacks, name):
    path, body = ERRORS[name]
    raw = b"{not json" if body is None else None
    port = _request(stacks["ports"]["a"], "POST", path, body, raw)
    ref = _request(stacks["ports"]["c"], "POST", path, body, raw)
    assert port[0] == ref[0] and port[0] in (400, 404)
    assert json.loads(port[2]) == json.loads(ref[2])


def test_post_only_routes_answer_405(stacks):
    for path in ("/v1/messages", "/v1/responses", "/clear_kv_blocks"):
        port = _request(stacks["ports"]["a"], "GET", path)
        ref = _request(stacks["ports"]["c"], "GET", path)
        assert port[0] == ref[0] == 405
        assert port[2] == ref[2]


def test_busy_threshold_routes(stacks):
    """The get-or-set contract and its validation, as the reference
    answers it, and a 0.0 threshold sheds the model's next request with
    the busy 503 once its worker's load is published; resetting serves
    again."""
    ports = stacks["ports"]
    chat = {"model": MODEL, "max_tokens": 2,
            "messages": [{"role": "user", "content": "x"}]}
    cases = [("GET", None), ("POST", {"model": MODEL}),
             ("POST", {"model": MODEL, "active_decode_blocks_threshold": 2}),
             ("POST", {"model": MODEL, "busy_threshold": "x"}),
             ("POST", {"active_decode_blocks_threshold": 0.5}),
             ("POST", {"model": "missing", "busy_threshold": 0.5}),
             ("POST", {"model": MODEL, "busy_threshold": 0.75}),
             ("GET", None),
             ("POST", {"model": MODEL}),
             ("POST", {"model": MODEL, "active_decode_blocks_threshold": 1})]
    for method, body in cases:
        port = _request(ports["a"], method, "/busy_threshold", body)
        ref = _request(ports["c"], method, "/busy_threshold", body)
        assert port[0] == ref[0], (method, body)
        assert json.loads(port[2]) == json.loads(ref[2]), (method, body)
    assert _request(ports["a"], "POST", "/busy_threshold",
                    raw=b"{")[0] == 400
    entry = stacks["frontends"]["a"].manager.get(MODEL)
    for _ in range(100):  # the worker publishes its load every few steps
        if entry.worker_usage:
            break
        _request(ports["a"], "POST", "/v1/chat/completions", chat)
    assert entry.worker_usage
    try:
        assert _request(ports["a"], "POST", "/busy_threshold", {
            "model": MODEL, "busy_threshold": 0.0})[0] == 200
        for path, body in (("/v1/chat/completions", chat),
                           ("/v1/messages", chat),
                           ("/v1/responses", {"model": MODEL,
                                              "input": "x"}),
                           ("/v1/embeddings", {"model": MODEL,
                                               "input": "x"})):
            status, headers, text = _request(ports["a"], "POST", path, body)
            assert status == 503, path
            assert json.loads(text)["error"]["type"] == "overloaded"
            assert int(headers["Retry-After"]) >= 1
    finally:
        _request(ports["a"], "POST", "/busy_threshold", {
            "model": MODEL, "busy_threshold": 1.0})
    assert _request(ports["a"], "POST", "/v1/chat/completions",
                    chat)[0] == 200


def test_openapi_and_docs_list_the_registered_routes(stacks):
    """The reference's route set less what is not ported (images, videos)
    and less the opt-in /debug/* routes (off here); /docs lists the
    same."""
    def routes(which):
        status, _, text = _request(stacks["ports"][which], "GET",
                                   "/openapi.json")
        assert status == 200
        doc = json.loads(text)
        assert doc["openapi"] == "3.0.3"
        return {(m, p) for p, ms in doc["paths"].items() for m in ms}

    port, ref = routes("a"), routes("c")
    assert port == ref - {("post", "/v1/images/generations"),
                          ("post", "/v1/videos")}
    assert port == {(m, p) for m, p, _, _ in ROUTES
                    if not p.startswith("/debug/")}
    status, headers, page = _request(stacks["ports"]["a"], "GET", "/docs")
    assert status == 200 and headers["Content-Type"].startswith("text/html")
    for method, path in port:
        assert f"<code>{method.upper()}</code></td><td><code>{path}</code>" \
            in page
        # every advertised route is routed (a 404 here is a handler's)
        assert _request(stacks["ports"]["a"], method.upper(), path,
                        {} if method == "post" else None)[2] \
            != "404: Not Found"


@pytest.fixture(scope="module")
def pair(stacks, tmp_path_factory):
    """Two TorchWorkers (each on a runtime of its own) in tree Q, with a
    port frontend and a reference frontend over them."""
    root = tmp_path_factory.mktemp("clear")
    lt = _LoopThread()
    state: dict = {"runtimes": [], "workers": []}

    async def up():
        for _ in range(2):
            rt = await DistributedRuntime(_port_config(root)).start()
            state["runtimes"].append(rt)
            worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                                 params=stacks["worker"].runner.model)
            worker.start()
            await worker.serve(rt)
            state["workers"].append(worker)
        port_rt = await DistributedRuntime(_port_config(root)).start()
        ref_rt = await RefRuntime(_ref_config(root)).start()
        state["runtimes"] += [port_rt, ref_rt]
        state["frontends"] = {
            "port": Frontend(port_rt, host="127.0.0.1", port=0),
            "ref": RefFrontend(ref_rt, host="127.0.0.1", port=0)}
        for fe in state["frontends"].values():
            await fe.start()
            await _wait_listed(fe.manager)
            while len(fe.manager.get(MODEL).router.client
                      .instance_ids()) < 2:
                await asyncio.sleep(0.05)

    async def down():
        for fe in state.get("frontends", {}).values():
            await fe.close()
        for worker in state["workers"]:
            await worker.shutdown()
        for rt in state["runtimes"]:
            await rt.shutdown()

    try:
        lt.run(up(), timeout=60.0)
        state["ports"] = {k: fe.port for k, fe in state["frontends"].items()}
        state["loop"] = lt
        yield state
    finally:
        try:
            lt.run(down(), timeout=60.0)
        finally:
            lt.close()


def _clear(port: int) -> dict:
    status, _, text = _request(port, "POST", "/clear_kv_blocks")
    assert status == 200
    return json.loads(text)


def test_clear_kv_blocks_over_two_workers(pair):
    """Both workers cleared, one record each with the worker's own
    answer, and their prefix caches empty; then with the second worker's
    request plane gone, one cleared and one failed record, from both
    frontends alike."""
    ports = pair["ports"]
    ids = sorted(w.instance_id for w in pair["workers"])
    for worker in pair["workers"]:  # leave some cached pages behind
        for port in ports.values():
            _request(port, "POST", "/v1/completions", {
                "model": MODEL, "prompt": list(range(1, 20)),
                "max_tokens": 2})
    assert sum(w.scheduler.pool.cached_count()
               for w in pair["workers"]) > 0
    port, ref = _clear(ports["port"]), _clear(ports["ref"])
    assert port["failed_workers"] == ref["failed_workers"] == []
    for answer in (port, ref):
        assert sorted(r["instance"] for r in answer["cleared_workers"]) == ids
        for rec in answer["cleared_workers"]:
            assert rec["status"] == "cleared" and rec["name"] == MODEL
            assert rec["endpoint"] == "dynamo/backend/clear_kv_blocks"
            assert set(rec["response"]) == {"cleared_blocks"}
    assert all(w.scheduler.pool.cached_count() == 0
               for w in pair["workers"])
    gone = pair["workers"][1].instance_id
    pair["loop"].run(pair["runtimes"][1].request_server.close())
    port, ref = _clear(ports["port"]), _clear(ports["ref"])
    for answer in (port, ref):
        assert [r["instance"] for r in answer["cleared_workers"]] == [
            pair["workers"][0].instance_id]
        (failed,) = answer["failed_workers"]
        assert failed["instance"] == gone and failed["status"] == "failed"
        assert failed["error"]
    assert [sorted(r) for r in port["failed_workers"]] == [
        sorted(r) for r in ref["failed_workers"]]


def test_clear_kv_blocks_without_workers(run, tmp_path):
    """No model registered: the reference's message."""

    async def go(port_side: bool):
        root = tmp_path / ("port" if port_side else "ref")
        rt = (await DistributedRuntime(_port_config(root)).start()
              if port_side else
              await RefRuntime(_ref_config(root)).start())
        fe = (Frontend if port_side else RefFrontend)(
            rt, host="127.0.0.1", port=0)
        try:
            await fe.start()
            return await asyncio.to_thread(_clear, fe.port)
        finally:
            await fe.close()
            await rt.shutdown()

    assert run(go(True)) == run(go(False)) == {
        "message": "No active worker groups found"}
