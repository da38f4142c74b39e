"""The port's serving edge against the JAX package's, over real HTTP and TCP.

One process hosts four frontend -> worker pairings on an event loop thread,
on tiny-test (float32) with the same weights in both workers:

  a  port frontend      -> TorchWorker      (discovery tree P)
  b  reference frontend -> TorchWorker      (discovery tree P)
  c  reference frontend -> TpuWorker        (discovery tree R)
  d  port frontend      -> TpuWorker        (discovery tree R)

Every greedy request goes a, c, b, d in that order, so each worker sees the
same request history through both of its frontends (the same prefix-cache
state): a must equal c (port stack == reference stack) and b must equal d
(the two cross-package pairings). Text, finish_reason and usage are
compared. Also: the chat template against jinja2, error bodies, /metrics,
a client disconnect freeing the sequence's pages, and the two CLIs started
and stopped in-process. Binds 127.0.0.1 only, spawns no subprocess.
"""

import asyncio
import contextlib
import dataclasses
import http.client
import io
import json
import logging
import socket
import threading
import time

import jax
import jinja2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.worker import TpuWorker
from dynamo_tpu.frontend import Frontend as RefFrontend
from dynamo_tpu.llm import preprocessor as ref_preprocessor
from dynamo_tpu.llm.http_service import _error_body as ref_error_body
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.frontend import Frontend
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.chat_template import ChatTemplate
from dynamo_tpu_torch.llm.preprocessor import DEFAULT_CHAT_TEMPLATE
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.discovery import FileDiscovery

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=128, max_batch=4, max_pages_per_seq=32,
              prefill_buckets=(8, 16, 32))
MODEL = "tiny-test"
STEP = 30.0  # bound on any one await of the setup and of each request


class _LoopThread:
    """An event loop on a thread of its own, hosting the servers while the
    test body talks to them over sockets."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = STEP):
        fut = asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(coro, timeout), self.loop)
        return fut.result(timeout + 5)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def _port_config(root) -> RuntimeConfig:
    return RuntimeConfig(discovery_backend="file", discovery_path=str(root),
                         tcp_host="127.0.0.1", lease_ttl_secs=10.0,
                         system_enabled=False)


def _ref_config(root) -> RefRuntimeConfig:
    return RefRuntimeConfig.from_env(
        discovery_backend="file", discovery_path=str(root),
        request_plane="tcp", tcp_host="127.0.0.1", event_plane="mem",
        system_enabled=False)


async def _wait_listed(manager) -> None:
    while not any(c.name == MODEL for c in manager.list_models()):
        await asyncio.sleep(0.05)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    params = jax.device_get(j_init(jax.random.PRNGKey(0), CFG))
    root = tmp_path_factory.mktemp("serving")
    lt = _LoopThread()
    state: dict = {}

    async def up():
        port_p = await DistributedRuntime(_port_config(root / "P")).start()
        ref_p = await RefRuntime(_ref_config(root / "P")).start()
        ref_r = await RefRuntime(_ref_config(root / "R")).start()
        port_r = await DistributedRuntime(_port_config(root / "R")).start()
        state["runtimes"] = [port_p, ref_p, ref_r, port_r]
        worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                             params=params_from_numpy(params, CFG,
                                                      device="cpu"))
        worker.start()
        await worker.serve(port_p)
        state["worker"] = worker
        ref_worker = TpuWorker(ref_r, model_name=MODEL,
                               runner_config=JRunnerConfig(**RUNNER))
        ref_worker.model_config = CFG

        async def shared_params():
            return params, None

        ref_worker._resolve_params = shared_params
        await ref_worker.start()
        state["ref_worker"] = ref_worker
        fes = {"a": Frontend(port_p, host="127.0.0.1", port=0),
               "b": RefFrontend(ref_p, host="127.0.0.1", port=0),
               "c": RefFrontend(ref_r, host="127.0.0.1", port=0),
               "d": Frontend(port_r, host="127.0.0.1", port=0)}
        state["frontends"] = fes
        for fe in fes.values():
            await fe.start()
        for fe in fes.values():
            await _wait_listed(fe.manager)

    async def down():
        for fe in state.get("frontends", {}).values():
            await fe.close()
        if "worker" in state:
            await state["worker"].shutdown()
        if "ref_worker" in state:
            await state["ref_worker"].close()
        for rt in state.get("runtimes", []):
            await rt.shutdown()

    try:
        lt.run(up(), timeout=120.0)
        state["ports"] = {k: fe.port for k, fe in state["frontends"].items()}
        state["loop"] = lt
        yield state
    finally:
        try:
            lt.run(down(), timeout=60.0)
        finally:
            lt.close()


def _request(port: int, method: str, path: str, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=STEP)
    try:
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


def _outcome(kind: str, body: dict, status: int, text: str):
    """(text, finish_reason, usage) of a completion, streamed or not."""
    assert status == 200, text
    if not body.get("stream"):
        data = json.loads(text)
        choice = data["choices"][0]
        out = (choice["message"]["content"] if kind == "chat"
               else choice["text"])
        return out, choice["finish_reason"], data["usage"]
    events = [line[len("data: "):] for line in text.split("\n\n")
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    pieces, finish, usage = [], None, None
    for chunk in chunks:
        if chunk.get("usage"):
            usage = chunk["usage"]
        for choice in chunk["choices"]:
            pieces.append(choice["delta"].get("content", "")
                          if kind == "chat" else choice["text"])
            finish = choice["finish_reason"] or finish
    return "".join(pieces), finish, usage


_rng = np.random.default_rng(3)
_STREAM = {"stream": True, "stream_options": {"include_usage": True}}
REQUESTS = {
    "completions-tokens": ("completions", {
        "prompt": _rng.integers(1, 256, 11).tolist(), "max_tokens": 8}),
    "completions-tokens-stream": ("completions", {
        "prompt": _rng.integers(1, 256, 23).tolist(), "max_tokens": 10,
        **_STREAM}),
    "completions-text": ("completions", {
        "prompt": "The quick brown fox", "max_tokens": 6}),
    "completions-text-stream-ignore-eos": ("completions", {
        "prompt": "jumps over", "max_tokens": 12, "ignore_eos": True,
        **_STREAM}),
    "completions-stop-string": ("completions", {
        "prompt": "lazy dog", "max_tokens": 12, "stop": ["<unk:4"]}),
    "completions-logprobs": ("completions", {
        "prompt": _rng.integers(1, 256, 7).tolist(), "max_tokens": 5,
        "logprobs": 2}),
    "chat": ("chat", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6}),
    "chat-stream": ("chat", {
        "messages": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "héllo"}],
        "max_tokens": 7, **_STREAM}),
    # served by the workers' logits processors (guided decoding, penalties)
    "chat-json-schema": ("chat", {
        "messages": [{"role": "user", "content": "json"}], "max_tokens": 40,
        "response_format": {"type": "json_schema", "json_schema": {
            "name": "s", "schema": {
                "type": "object",
                "properties": {"ok": {"type": "boolean"},
                               "color": {"enum": ["red", "green", "blue"]}},
                "required": ["ok", "color"]}}}}),
    "completions-penalty-stream": ("completions", {
        "prompt": [5, 6, 7, 5, 6, 7, 5, 6], "max_tokens": 12,
        "repetition_penalty": 1.3, "frequency_penalty": 0.5,
        "presence_penalty": 0.25, "min_tokens": 4, **_STREAM}),
}


def _send(stacks, which: str, kind: str, body: dict):
    path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
    full = {"model": MODEL, "temperature": 0.0, **body}
    status, _, text = _request(stacks["ports"][which], "POST", path, full)
    return _outcome(kind, full, status, text)


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_completion_matches_across_packages(stacks, name):
    kind, body = REQUESTS[name]
    a = _send(stacks, "a", kind, body)
    c = _send(stacks, "c", kind, body)
    b = _send(stacks, "b", kind, body)
    d = _send(stacks, "d", kind, body)
    assert a == c, "port frontend -> TorchWorker != reference stack"
    assert b == d, "cross-package pairings disagree"
    text, finish, usage = a
    assert finish in ("stop", "length")
    assert usage["completion_tokens"] <= body["max_tokens"]
    assert usage["total_tokens"] == (usage["prompt_tokens"]
                                     + usage["completion_tokens"])


ERRORS = {
    "unknown-model": ("/v1/completions",
                      {"model": "missing", "prompt": "x"}),
    "unsupported-parameter": ("/v1/completions",
                              {"model": MODEL, "prompt": "x", "bogus": 1}),
    "temperature-range": ("/v1/chat/completions", {
        "model": MODEL, "temperature": 3,
        "messages": [{"role": "user", "content": "x"}]}),
    "no-messages": ("/v1/chat/completions", {"model": MODEL}),
    "n-above-one": ("/v1/completions",
                    {"model": MODEL, "prompt": "x", "n": 2}),
    "tool-choice-forcing": ("/v1/chat/completions", {
        "model": MODEL, "tool_choice": "required",
        "tools": [{"type": "function", "function": {"name": "f"}}],
        "messages": [{"role": "user", "content": "x"}]}),
    "prompt-too-long": ("/v1/completions",
                        {"model": MODEL, "prompt": [5] * 200}),
    "invalid-json": ("/v1/completions", None),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_bodies_match_the_reference(stacks, name):
    path, body = ERRORS[name]
    raw = b"{not json" if body is None else None
    port = _request(stacks["ports"]["a"], "POST", path, body, raw)
    ref = _request(stacks["ports"]["c"], "POST", path, body, raw)
    assert port[0] == ref[0] and port[0] in (400, 404)
    assert json.loads(port[2]) == json.loads(ref[2])


def test_no_instance_answers_503(stacks, run, tmp_path):
    """A model whose card is listed but whose instances are all gone gets
    the reference's migration outcome from both frontends: Migration
    retries NoInstancesAvailable DYNT_MIGRATION_LIMIT times, then the
    in-band "migration limit exceeded" error answers 502."""

    async def go(port_side: bool):
        root = tmp_path / ("port" if port_side else "ref")
        if port_side:
            rt = await DistributedRuntime(_port_config(root)).start()
            fe = Frontend(rt, host="127.0.0.1", port=0)
        else:
            rt = await RefRuntime(_ref_config(root)).start()
            fe = RefFrontend(rt, host="127.0.0.1", port=0)
        try:
            await fe.start()
            card = ModelDeploymentCard(name="ghost")
            await rt.put_leased(card.card_key(1), card.to_wire())
            await asyncio.wait_for(_wait_for(fe.manager, "ghost"), STEP)
            return await asyncio.wait_for(asyncio.to_thread(
                _request, fe.port, "POST", "/v1/completions",
                {"model": "ghost", "prompt": "x", "max_tokens": 2}), STEP)
        finally:
            await fe.close()
            await rt.shutdown()

    port_status, _, port_text = run(go(True))
    ref_status, _, ref_text = run(go(False))
    assert port_status == ref_status == 502
    assert json.loads(port_text) == json.loads(ref_text) == ref_error_body(
        502, "migration limit exceeded: dynamo/backend/generate",
        "engine_error")


def test_no_instance_streams_the_migration_error(stacks, run, tmp_path):
    """Streamed, the same outcome is in-band: both frontends answer 200
    and end the stream with a finish_reason "error" chunk, then [DONE]."""

    async def go(port_side: bool):
        root = tmp_path / ("port" if port_side else "ref")
        if port_side:
            rt = await DistributedRuntime(_port_config(root)).start()
            fe = Frontend(rt, host="127.0.0.1", port=0)
        else:
            rt = await RefRuntime(_ref_config(root)).start()
            fe = RefFrontend(rt, host="127.0.0.1", port=0)
        try:
            await fe.start()
            card = ModelDeploymentCard(name="ghost")
            await rt.put_leased(card.card_key(1), card.to_wire())
            await asyncio.wait_for(_wait_for(fe.manager, "ghost"), STEP)
            return await asyncio.wait_for(asyncio.to_thread(
                _request, fe.port, "POST", "/v1/completions",
                {"model": "ghost", "prompt": "x", "max_tokens": 2,
                 "stream": True}), STEP)
        finally:
            await fe.close()
            await rt.shutdown()

    def events(text):
        return [json.loads(line[6:]) for line in text.splitlines()
                if line.startswith("data: ") and line != "data: [DONE]"]

    port_status, _, port_text = run(go(True))
    ref_status, _, ref_text = run(go(False))
    assert port_status == ref_status == 200
    assert port_text.rstrip().endswith("data: [DONE]")
    mine, theirs = events(port_text), events(ref_text)
    assert [c["choices"][0]["finish_reason"] for c in mine] == [
        c["choices"][0]["finish_reason"] for c in theirs] == ["error"]


async def _wait_for(manager, name: str) -> None:
    while manager.get(name) is None:
        await asyncio.sleep(0.05)


def test_routes(stacks):
    port = stacks["ports"]["a"]
    status, _, text = _request(port, "GET", "/v1/models")
    assert status == 200
    assert [m["id"] for m in json.loads(text)["data"]] == [MODEL]
    for path in ("/health", "/live"):
        status, _, text = _request(port, "GET", path)
        assert status == 200
        assert json.loads(text) == {"status": "healthy", "models": [MODEL]}
    # embeddings are served (POST only); images are not ported
    assert _request(port, "GET", "/v1/embeddings")[:1] == (405,)
    assert _request(port, "POST", "/v1/images/generations",
                    {"model": MODEL, "prompt": "x"})[:1] == (404,)
    assert _request(port, "GET", "/nowhere")[2] == "404: Not Found"
    assert _request(port, "GET", "/v1/completions")[0] == 405


def _frontend_requests(port: int) -> float:
    _, _, text = _request(port, "GET", "/metrics")
    for family in text_string_to_metric_families(text):
        if family.name == "dynamo_requests":
            return sum(s.value for s in family.samples
                       if s.name == "dynamo_requests_total"
                       and s.labels["component"] == "frontend"
                       and s.labels["endpoint"] == MODEL)
    return 0.0


def test_metrics_count_the_requests_sent(stacks):
    port = stacks["ports"]["a"]
    before = _frontend_requests(port)
    for name in ("completions-tokens", "chat-stream"):
        kind, body = REQUESTS[name]
        _send(stacks, "a", kind, body)
    _, headers, text = _request(port, "GET", "/metrics")
    assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
    names = {f.name for f in text_string_to_metric_families(text)}
    assert {"dynamo_requests", "dynamo_request_duration_seconds",
            "dynamo_time_to_first_token_seconds",
            "dynamo_inter_token_latency_seconds",
            "dynamo_input_sequence_tokens",
            "dynamo_output_sequence_tokens"} <= names
    assert _frontend_requests(port) - before == 2


def _reclaimable(pool) -> int:
    """Free pages plus prefix-cache pages no sequence pins."""
    return pool.free_count() + sum(1 for h in pool._cached
                                   if pool._refcount.get(h, 0) == 0)


def test_client_disconnect_frees_the_sequence(stacks):
    worker = stacks["worker"]
    sched = worker.scheduler
    before = _reclaimable(sched.pool)
    body = json.dumps({"model": MODEL, "prompt": [7] * 20, "max_tokens": 90,
                       "temperature": 0.0, "ignore_eos": True,
                       "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", stacks["ports"]["a"]),
                                    timeout=STEP)
    try:
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        got = b""
        while b"data: " not in got:
            got += sock.recv(4096)
        assert got.startswith(b"HTTP/1.1 200")
    finally:
        sock.close()
    deadline = time.monotonic() + STEP
    while (sched._waiting or any(s is not None for s in sched._slots)
           or _reclaimable(sched.pool) != before):
        assert time.monotonic() < deadline, "the sequence was not released"
        time.sleep(0.01)
    # the stream stopped early: the scheduler generated fewer than 90 tokens
    assert sched.pool.free_count() + sched.pool.cached_count() \
        == sched.pool.num_pages - 1


messages = st.lists(st.fixed_dictionaries(
    {"role": st.sampled_from(["system", "user", "assistant"])},
    optional={"content": st.one_of(st.text(max_size=20), st.none(),
                                   st.integers())}), min_size=1, max_size=4)


@settings(max_examples=60, deadline=None)
@given(messages, st.booleans())
def test_chat_template_renders_as_jinja2(msgs, add_generation_prompt):
    expected = jinja2.Environment().from_string(
        ref_preprocessor.DEFAULT_CHAT_TEMPLATE).render(
            messages=msgs, add_generation_prompt=add_generation_prompt)
    assert ChatTemplate(DEFAULT_CHAT_TEMPLATE).render(
        messages=msgs, add_generation_prompt=add_generation_prompt) \
        == expected
    assert DEFAULT_CHAT_TEMPLATE == ref_preprocessor.DEFAULT_CHAT_TEMPLATE


def test_custom_chat_template_is_refused(stacks):
    """A template outside the renderer's grammar: chat answers 400 (the
    preprocessor refused it when it was built); completions still serve."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.validate import RequestError

    pre = OpenAIPreprocessor(ModelDeploymentCard(
        name="m", chat_template="{% include 'chat.jinja' %}"))
    with pytest.raises(RequestError, match="outside the renderer's grammar"):
        pre.preprocess_chat({"messages": [{"role": "user", "content": "x"}]})
    # completions do not render the template
    assert pre.preprocess_completions({"prompt": "x"}).token_ids == [120]


def test_custom_chat_template_renders(stacks):
    """A custom template inside the grammar renders as jinja2 renders it
    through the reference's preprocessor."""
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor

    template = ("{{ messages }}{% for m in messages %}<{{ m.role }}>"
                "{{ m.content|trim }}{% endfor %}")
    msgs = [{"role": "user", "content": " x "}, {"role": "assistant"}]
    pre = OpenAIPreprocessor(ModelDeploymentCard(name="m",
                                                 chat_template=template))
    ref = ref_preprocessor.OpenAIPreprocessor(
        RefCard(name="m", chat_template=template))
    assert pre.render_chat([dict(m) for m in msgs]) == ref.render_chat(
        [dict(m) for m in msgs])
    got = pre.preprocess_chat({"messages": msgs})
    want = ref.preprocess_chat({"messages": msgs})
    assert got.token_ids == want.token_ids


class _PortLog(logging.Handler):
    def __init__(self) -> None:
        super().__init__()
        self.port = None

    def emit(self, record) -> None:
        if record.getMessage().startswith("frontend ready on port"):
            self.port = record.args[0]


def test_worker_and_frontend_mains_start_and_stop(run, tmp_path,
                                                  monkeypatch):
    from dynamo_tpu_torch.engine.worker import main as worker_main
    from dynamo_tpu_torch.frontend.service import main as frontend_main
    from dynamo_tpu_torch.runtime.signals import request_shutdown

    for key, val in {"DYNT_DISCOVERY_PATH": str(tmp_path),
                     "DYNT_DISCOVERY_BACKEND": "file",
                     "DYNT_TCP_HOST": "127.0.0.1",
                     "DYNT_SYSTEM_ENABLED": "0"}.items():
        monkeypatch.setenv(key, val)
    handler = _PortLog()
    logger = logging.getLogger("dynamo_tpu_torch.frontend")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)

    async def go():
        disc = FileDiscovery(str(tmp_path))
        worker = asyncio.ensure_future(worker_main([
            "--model", MODEL, "--device", "cpu", "--page-size", "4",
            "--num-pages", "64", "--max-batch", "2",
            "--max-pages-per-seq", "16"]))
        front = asyncio.ensure_future(frontend_main(
            ["--host", "127.0.0.1", "--port", "0"]))
        try:
            while not await disc.get_prefix("v1/mdc/"):
                assert not worker.done(), worker.exception()
                await asyncio.sleep(0.05)
            while handler.port is None:
                assert not front.done(), front.exception()
                await asyncio.sleep(0.05)
            listed = []
            while MODEL not in listed:
                _, _, text = await asyncio.to_thread(
                    _request, handler.port, "GET", "/v1/models")
                listed = [m["id"] for m in json.loads(text)["data"]]
            status, _, text = await asyncio.to_thread(
                _request, handler.port, "POST", "/v1/completions",
                {"model": MODEL, "prompt": "ab", "max_tokens": 3})
            assert status == 200, text
            assert json.loads(text)["usage"]["completion_tokens"] == 3
        finally:
            request_shutdown("test")
            await asyncio.wait_for(asyncio.gather(worker, front), STEP)
        return await disc.get_prefix("v1/")

    try:
        left = run(go(), timeout=90.0)
    finally:
        logger.removeHandler(handler)
    assert left == {}  # the card and the instance records were withdrawn


def test_cli_refuses_what_is_not_ported():
    from dynamo_tpu_torch.engine.worker import build_arg_parser as worker_cli
    from dynamo_tpu_torch.engine.worker import main as worker_main
    from dynamo_tpu_torch.frontend.service import build_arg_parser

    for argv in (["--router-mode", "least_loaded"], ["--namespace", "g"],
                 ["--audit-sinks", "log"], ["--kserve-grpc-port", "1"]):
        with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
            build_arg_parser().parse_args(argv)
    for argv in (["--mode", "gang"],
                 ["--tp", "2"], ["--kv-dtype", "fp8"],
                 ["--model-ref", "ns/model"]):
        with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
            worker_cli().parse_args(argv)
    # --mode comesh is served (engine/ici_transfer.py); --dp only parses:
    # data parallelism is refused when the worker starts
    assert worker_cli().parse_args(["--mode", "comesh"]).mode == "comesh"
    # multi-LoRA is served (llm/lora.py): its flags parse
    assert worker_cli().parse_args(["--max-loras", "2"]).max_loras == 2
    with pytest.raises(SystemExit, match="--dp > 1 is not ported"):
        asyncio.run(worker_main(["--dp", "2", "--device", "cpu"]))
    assert worker_cli().parse_args([]).device == "cuda"
    args = worker_cli().parse_args(["--model-path", "/ckpt",
                                    "--served-model-name", "m"])
    assert (args.model_path, args.served_model_name) == ("/ckpt", "m")


# -- one HF checkpoint directory (weights, tokenizer.json, chat template),
#    served by a worker of each package behind a frontend of each ---------------

CKPT_TEMPLATE = (
    "{{- bos_token }}{% for m in messages %}"
    "{% if m['role'] not in ['system', 'user', 'assistant'] %}"
    "{{ raise_exception('unknown role ' + m['role']) }}{% endif %}"
    "{{- '<|start_header_id|>' + m['role'] + '<|end_header_id|>\\n\\n' "
    "+ m['content'] | trim + '<|eot_id|>' }}{% endfor %}"
    "{% if add_generation_prompt %}"
    "{{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}{% endif %}")
CKPT_SPECIALS = ["<|begin_of_text|>", "<|eot_id|>", "<|start_header_id|>",
                 "<|end_header_id|>"]


def _checkpoint_dir(path, params) -> str:
    """tiny-test's weights, a Llama-3-form byte-level BPE of under 512 ids
    and the config files a checkpoint ships."""
    from tokenizers import Regex, Tokenizer, decoders, models
    from tokenizers import pre_tokenizers, trainers

    from dynamo_tpu.models.checkpoint import save_params as ref_save

    ref_save(params, CFG, str(path))
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(
            r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
            r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
            r"|\s+"), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(
        ["The quick brown fox jumps over the lazy dog.", "héllo wörld 123",
         "be brief, json and 'quotes'", "{\"ok\": true, \"color\": \"red\"}"]
        * 20, trainers.BpeTrainer(
            vocab_size=480, special_tokens=CKPT_SPECIALS, show_progress=False,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    assert tok.get_vocab_size() <= CFG.vocab_size
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": CKPT_TEMPLATE, "eos_token": "<|eot_id|>"}))
    (path / "generation_config.json").write_text(json.dumps(
        {"eos_token_id": tok.token_to_id("<|eot_id|>")}))
    return str(path)


@pytest.fixture(scope="module")
def ckpt_stacks(tmp_path_factory):
    """The a / b / c / d pairings of `stacks`, both workers started from
    one checkpoint directory (float32 weights), the frontends loading its
    tokenizer and template from the card."""
    params = jax.device_get(j_init(jax.random.PRNGKey(4), CFG))
    root = tmp_path_factory.mktemp("ckpt_serving")
    ckpt_dir = root / "tiny-ckpt"
    ckpt_dir.mkdir()
    path = _checkpoint_dir(ckpt_dir, params)
    lt = _LoopThread()
    state: dict = {"model": "tiny-ckpt", "path": path}

    async def up():
        port_p = await DistributedRuntime(_port_config(root / "P")).start()
        ref_p = await RefRuntime(_ref_config(root / "P")).start()
        ref_r = await RefRuntime(_ref_config(root / "R")).start()
        port_r = await DistributedRuntime(_port_config(root / "R")).start()
        state["runtimes"] = [port_p, ref_p, ref_r, port_r]
        worker = TorchWorker(model_path=path, dtype="float32", device="cpu",
                             runner_config=RunnerConfig(**RUNNER))
        worker.start()
        await worker.serve(port_p)
        state["worker"] = worker
        ref_worker = TpuWorker(ref_r, model_path=path,
                               runner_config=JRunnerConfig(**RUNNER))
        ref_worker.model_config = dataclasses.replace(
            ref_worker.model_config, dtype="float32")
        await ref_worker.start()
        state["ref_worker"] = ref_worker
        fes = {"a": Frontend(port_p, host="127.0.0.1", port=0),
               "b": RefFrontend(ref_p, host="127.0.0.1", port=0),
               "c": RefFrontend(ref_r, host="127.0.0.1", port=0),
               "d": Frontend(port_r, host="127.0.0.1", port=0)}
        state["frontends"] = fes
        for fe in fes.values():
            await fe.start()
        for fe in fes.values():
            await _wait_for(fe.manager, state["model"])

    async def down():
        for fe in state.get("frontends", {}).values():
            await fe.close()
        if "worker" in state:
            await state["worker"].shutdown()
        if "ref_worker" in state:
            await state["ref_worker"].close()
        for rt in state.get("runtimes", []):
            await rt.shutdown()

    try:
        lt.run(up(), timeout=120.0)
        state["ports"] = {k: fe.port for k, fe in state["frontends"].items()}
        yield state
    finally:
        try:
            lt.run(down(), timeout=60.0)
        finally:
            lt.close()


CKPT_REQUESTS = {
    "chat": ("chat", {"messages": [{"role": "user", "content": "héllo"}],
                      "max_tokens": 8}),
    "chat-stream": ("chat", {
        "messages": [{"role": "system", "content": " be brief "},
                     {"role": "user", "content": "The quick fox"}],
        "max_tokens": 9, **_STREAM}),
    "completions-text": ("completions", {"prompt": "jumps over the",
                                         "max_tokens": 6}),
    "chat-json-schema": ("chat", {
        "messages": [{"role": "user", "content": "json"}], "max_tokens": 40,
        "response_format": {"type": "json_schema", "json_schema": {
            "name": "s", "schema": {
                "type": "object",
                "properties": {"ok": {"type": "boolean"},
                               "color": {"enum": ["red", "green", "blue"]}},
                "required": ["ok", "color"]}}}}),
}


@pytest.mark.parametrize("name", sorted(CKPT_REQUESTS))
def test_checkpoint_directory_serves_across_packages(ckpt_stacks, name):
    kind, body = CKPT_REQUESTS[name]
    path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
    full = {"model": ckpt_stacks["model"], "temperature": 0.0, **body}
    got = {}
    for which in "acbd":  # each worker sees the same history per frontend
        status, _, text = _request(ckpt_stacks["ports"][which], "POST",
                                   path, full)
        got[which] = _outcome(kind, full, status, text)
    assert got["a"] == got["c"], "port stack != reference stack"
    assert got["b"] == got["d"], "cross-package pairings disagree"
    text, finish, usage = got["a"]
    assert usage["prompt_tokens"] == got["b"][2]["prompt_tokens"]
    if name == "chat-json-schema":
        assert set(json.loads(text)) == {"ok", "color"}


def test_checkpoint_template_error_answers_as_the_reference(ckpt_stacks):
    """The template's raise_exception branch: both frontends answer the
    reference server's 500 for an uncaught template error."""
    from dynamo_tpu_torch.llm.http_service import TEMPLATE_ERROR_BODY

    body = {"model": ckpt_stacks["model"], "max_tokens": 2,
            "messages": [{"role": "tool", "content": "x"}]}
    port = _request(ckpt_stacks["ports"]["a"], "POST",
                    "/v1/chat/completions", body)
    ref = _request(ckpt_stacks["ports"]["c"], "POST",
                   "/v1/chat/completions", body)
    assert port[0] == ref[0] == 500
    assert port[2] == ref[2] == TEMPLATE_ERROR_BODY
