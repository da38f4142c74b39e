"""The port's guided decoding (`llm/guided.py`) against the JAX package's, on
the CPU, and structured outputs served end to end by the port.

Held equal to the reference: the DFA tables and accepting sets of
`compile_regex` over the patterns of tests/test_guided.py and the grammars
built from its schemas; `schema_to_regex`, `json_object_regex` and
`tool_call_regex` strings and their refusals; `token_bytes_for` over the
byte tokenizer and over a fake byte-level-BPE vocab (multi-byte UTF-8 split
across tokens, the case the port's tokenizer lacked `vocab_size` and
`token_text` for); and the TokenGuide masks of every reachable DFA state.

Served end to end on tiny-test (float32, random weights, greedy) through the
port's frontend and worker in one process: `response_format` json_schema
and json_object, `nvext.guided_decoding` choice and regex, and `tool_choice`
forcing on a card with the hermes tool parser (a `tool_calls` entry and
finish_reason `tool_calls`); an EBNF grammar and a forcing request to a
parser that cannot force answer 400. Binds 127.0.0.1 only.
"""

import asyncio
import dataclasses
import http.client
import json
import re
import threading

import jax
import numpy as np
import pytest

from dynamo_tpu.llm import guided as ref_guided
from dynamo_tpu.llm.tokenizer import ByteTokenizer as RefByteTokenizer
from dynamo_tpu.llm.tokenizer import Tokenizer as RefTokenizer
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.frontend import Frontend
from dynamo_tpu_torch.llm import guided
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, Tokenizer
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

PATTERNS = [
    r"-?(0|[1-9][0-9]*)",
    r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?",
    r"(true|false)",
    r"a{2,4}b+c?",
    r"[a-cx-z]*q",
    r"[^0-9]+",
    r"\d{3}-\d{4}",
    r'"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"',
    r"(ab|cd)*ef",
    r"\w+@\w+\.(com|org)",
    "héllo",
    r"(?:x|y)\s*\S\W.",
]
SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"},
                                      "ok": {"type": "boolean"}}},
    {"type": "object", "properties": {
        "kind": {"enum": ["a", "b"]}, "v": {"const": 7},
        "tags": {"type": "array", "items": {"type": "string"},
                 "minItems": 1, "maxItems": 2},
        "sub": {"type": "object", "properties": {"x": {"type": "number"}}}}},
    {"type": "array", "items": {"type": "integer"}, "maxItems": 0},
    {"type": "array", "items": {"type": "null"}, "minItems": 2},
    {"type": ["string", "integer"]},
    {"anyOf": [{"type": "boolean"}, {"const": "x\ty"}]},
    {"type": "object"},
    {},
    {"type": "object", "properties": {
        "ok": {"type": "boolean"},
        "color": {"enum": ["red", "green", "blue"]}},
     "required": ["ok", "color"]},
]
BAD_SCHEMAS = [{"$ref": "#/x"}, {"type": "array", "minItems": 3,
                                 "maxItems": 1}, {"type": "frob"}, [1]]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}},
    {"type": "function", "function": {"name": "noop"}}]


def _dfa_pair(pattern):
    return guided.compile_regex(pattern), ref_guided.compile_regex(pattern)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dfa_tables_equal_the_reference(pattern):
    mine, theirs = _dfa_pair(pattern)
    np.testing.assert_array_equal(mine.table, theirs.table)
    np.testing.assert_array_equal(mine.accepting, theirs.accepting)
    for s in ("", "aab", "12-4567", '"hi"', "a@b.com", "héllo", "x \x01!z"):
        assert mine.fullmatch(s.encode()) == bool(
            re.fullmatch(pattern, s)) == theirs.fullmatch(s.encode())


@pytest.mark.parametrize("pattern", [r"(", r"a)", r"[z-a]", r"*a",
                                     r"a{999999}"])
def test_bad_patterns_are_refused_as_the_reference_refuses_them(pattern):
    with pytest.raises(guided.RegexError) as mine:
        guided.compile_regex(pattern)
    with pytest.raises(ref_guided.RegexError) as theirs:
        ref_guided.compile_regex(pattern)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_grammars_equal_the_reference(i):
    mine = guided.schema_to_regex(SCHEMAS[i])
    assert mine == ref_guided.schema_to_regex(SCHEMAS[i])
    a, b = _dfa_pair(mine)
    np.testing.assert_array_equal(a.table, b.table)
    np.testing.assert_array_equal(a.accepting, b.accepting)


@pytest.mark.parametrize("i", range(len(BAD_SCHEMAS)))
def test_bad_schemas_are_refused_as_the_reference_refuses_them(i):
    with pytest.raises(guided.RegexError) as mine:
        guided.schema_to_regex(BAD_SCHEMAS[i])
    with pytest.raises(ref_guided.RegexError) as theirs:
        ref_guided.schema_to_regex(BAD_SCHEMAS[i])
    assert str(mine.value) == str(theirs.value)


def test_json_value_grammars_equal_the_reference():
    assert guided.json_object_regex() == ref_guided.json_object_regex()
    for depth in (1, 2, 4):
        assert (guided.json_value_regex(depth)
                == ref_guided.json_value_regex(depth))


@pytest.mark.parametrize("fmt", ["hermes", "qwen", "llama3_json", "mistral",
                                 "pythonic"])
@pytest.mark.parametrize("name", [None, "get_weather", "missing"])
def test_tool_call_grammars_equal_the_reference(fmt, name):
    def build(mod):
        try:
            return mod.tool_call_regex(fmt, TOOLS, name)
        except mod.RegexError as exc:
            return f"refused: {exc}"

    mine = build(guided)
    assert mine == build(ref_guided)
    assert mine.startswith("refused") == (fmt == "pythonic"
                                          or name == "missing")


def _fake_byte_level_bpe(base):
    """tests/test_guided.py's fake byte-level-BPE vocab on `base`: 'Ã' + '©'
    spell é's two UTF-8 bytes as two tokens whose decode() is U+FFFD; id 5
    is a chat-control token with an ASCII spelling and an empty decode; 'Ġa'
    marks the vocab as byte-level."""

    class FakeByteLevelBPE(base):
        def __init__(self):
            self.vocab = ['"', "\xc3", "\xa9", "a", "</s>", "<|im_start|>",
                          "Ġa"]
            self.eos_token_ids = [4]
            self.vocab_size = 7
            self.stable_window = 0

        def token_text(self, token_id):
            return self.vocab[token_id] if token_id != 4 else None

        def decode(self, token_ids):
            out = []
            for t in token_ids:
                if t in (1, 2):
                    out.append("�")
                elif t in (4, 5):
                    out.append("")
                elif t == 6:
                    out.append(" a")
                else:
                    out.append(self.vocab[t])
            return "".join(out)

    return FakeByteLevelBPE()


@pytest.mark.parametrize("vocab", ["byte", "byte_level_bpe"])
def test_token_bytes_equal_the_reference(vocab):
    if vocab == "byte":
        mine, theirs = ByteTokenizer(), RefByteTokenizer()
        assert mine.vocab_size == theirs.vocab_size == 512
        assert mine.token_text(65) is theirs.token_text(65) is None
    else:
        mine = _fake_byte_level_bpe(Tokenizer)
        theirs = _fake_byte_level_bpe(RefTokenizer)
    got = guided.token_bytes_for(mine)
    assert got == ref_guided.token_bytes_for(theirs)
    if vocab == "byte_level_bpe":
        assert got == [b'"', b"\xc3", b"\xa9", b"a", None, None, b" a"]


def test_multibyte_utf8_walks_across_two_tokens():
    """Guided '"é"' over the fake byte-level vocab: the DFA walks é's two
    bytes across tokens 1 and 2, then only EOS is legal, as in the
    reference."""
    outs = []
    for mod, base in ((guided, Tokenizer), (ref_guided, RefTokenizer)):
        tok = _fake_byte_level_bpe(base)
        proc = mod.GuidedProcessor(mod.TokenGuide(
            mod.compile_regex('"é"'), mod.token_bytes_for(tok),
            tok.eos_token_ids))
        out, masks = [], []
        for _ in range(5):
            row = np.zeros(tok.vocab_size, np.float32)
            proc(out, row)
            masks.append(np.isfinite(row))
            nxt = int(np.argmax(row))
            if nxt in tok.eos_token_ids:
                break
            out.append(nxt)
        outs.append((out, [m.tolist() for m in masks]))
    assert outs[0] == outs[1]
    assert outs[0][0] == [0, 1, 2, 0]


@pytest.mark.parametrize("pattern", PATTERNS[:6] + [
    guided.schema_to_regex(SCHEMAS[-1]),
    guided.tool_call_regex("hermes", TOOLS, "get_weather")])
def test_token_masks_equal_the_reference(pattern):
    """Every DFA state reachable within a few tokens: the allowed masks,
    the EOS verdicts and the token transitions are the reference's."""
    mine = guided.TokenGuide(guided.compile_regex(pattern),
                             guided.token_bytes_for(ByteTokenizer()),
                             ByteTokenizer().eos_token_ids)
    theirs = ref_guided.TokenGuide(
        ref_guided.compile_regex(pattern),
        ref_guided.token_bytes_for(RefByteTokenizer()),
        RefByteTokenizer().eos_token_ids)
    frontier, seen = [0], {0}
    for _ in range(6):
        nxt = []
        for state in frontier:
            allowed = mine.allowed(state)
            np.testing.assert_array_equal(allowed, theirs.allowed(state))
            assert mine.eos_allowed(state) == theirs.eos_allowed(state)
            for tok in np.flatnonzero(allowed)[:24]:
                s = mine.advance(state, int(tok))
                assert s == theirs.advance(state, int(tok))
                if s >= 0 and s not in seen:
                    seen.add(s)
                    nxt.append(s)
        frontier = nxt
    assert len(seen) > 1


# -- served end to end -------------------------------------------------------------

CFG = dataclasses.replace(get_config("tiny-test"), dtype="float32")
RUNNER = dict(page_size=4, num_pages=256, max_batch=2, max_pages_per_seq=64,
              prefill_buckets=(16, 64))
MODEL = "tiny-test"


@pytest.fixture(scope="module")
def frontend_port(tmp_path_factory):
    """The port's worker (hermes tool parser on its card) and frontend on a
    loop thread of their own; yields the frontend's port."""
    params = jax.device_get(j_init(jax.random.PRNGKey(0), CFG))
    root = tmp_path_factory.mktemp("guided")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro, timeout=60.0):
        return asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(coro, timeout), loop).result(timeout + 5)

    state = {}

    async def up():
        rt = await DistributedRuntime(RuntimeConfig(
            discovery_backend="file", discovery_path=str(root),
            tcp_host="127.0.0.1", system_enabled=False)).start()
        state["rt"] = rt
        worker = TorchWorker(CFG, RunnerConfig(**RUNNER), device="cpu",
                             params=params_from_numpy(params, CFG,
                                                      device="cpu"),
                             tool_parser="hermes")
        worker.start()
        state["worker"] = worker
        await worker.serve(rt)
        fe = Frontend(rt, host="127.0.0.1", port=0)
        state["fe"] = fe
        await fe.start()
        while fe.manager.get(MODEL) is None:
            await asyncio.sleep(0.05)
        return fe.port

    async def down():
        if "fe" in state:
            await state["fe"].close()
        if "worker" in state:
            await state["worker"].shutdown()
        if "rt" in state:
            await state["rt"].shutdown()

    try:
        yield run(up())
    finally:
        try:
            run(down())
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(10)
            loop.close()


def _post(port, route, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", f"/v1/{route}", body=json.dumps(
            {"model": MODEL, "temperature": 0, **body}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


_CHAT = {"messages": [{"role": "user", "content": "go"}]}
_SCHEMA = SCHEMAS[-1]


def _check_schema(text):
    value = json.loads(text)
    assert set(value) == {"ok", "color"}
    assert isinstance(value["ok"], bool)
    assert value["color"] in ("red", "green", "blue")


def _check_json_object(text):
    assert isinstance(json.loads(text), dict)


SERVED = {
    "response_format-json_schema": ("chat/completions", {
        **_CHAT, "max_tokens": 64, "response_format": {
            "type": "json_schema",
            "json_schema": {"name": "s", "schema": _SCHEMA}}},
        _check_schema),
    "response_format-json_object": ("chat/completions", {
        **_CHAT, "max_tokens": 64, "logit_bias": {"125": 6},
        "response_format": {"type": "json_object"}}, _check_json_object),
    "guided-choice": ("completions", {
        "prompt": "x", "max_tokens": 16,
        "nvext": {"guided_decoding": {"choice": ["alpha", "beta",
                                                 "gamma"]}}},
        lambda text: text in ("alpha", "beta", "gamma")),
    "guided-regex": ("completions", {
        "prompt": "x", "max_tokens": 16,
        "nvext": {"guided_decoding": {"regex": r"\d{3}-[a-c]{2}"}}},
        lambda text: re.fullmatch(r"\d{3}-[a-c]{2}", text)),
}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_structured_outputs_are_served(frontend_port, name):
    route, body, check = SERVED[name]
    status, data = _post(frontend_port, route, body)
    assert status == 200, data
    choice = data["choices"][0]
    assert choice["finish_reason"] == "stop", data
    text = (choice["message"]["content"] if route.startswith("chat")
            else choice["text"])
    assert check(text) is not False, text


@pytest.mark.parametrize("tool_choice", [
    "required", {"type": "function", "function": {"name": "get_weather"}}],
    ids=["required", "named"])
def test_tool_choice_forcing_is_served(frontend_port, tool_choice):
    """The forced grammar makes the output a hermes tool call; the hermes
    parser turns it into `tool_calls`. A bias on '"' keeps the random
    model's free string short."""
    status, data = _post(frontend_port, "chat/completions", {
        **_CHAT, "max_tokens": 100, "tools": TOOLS[:1],
        "tool_choice": tool_choice, "logit_bias": {"34": 8}})
    assert status == 200, data
    choice = data["choices"][0]
    assert choice["finish_reason"] == "tool_calls", data
    calls = choice["message"]["tool_calls"]
    assert len(calls) == 1
    fn = calls[0]["function"]
    assert fn["name"] == "get_weather"
    assert isinstance(json.loads(fn["arguments"]), dict)
    assert choice["message"]["content"] is None


@pytest.mark.parametrize("body", [
    {"nvext": {"guided_decoding": {"grammar": "root ::= 'a'"}}},
    {"nvext": {"guided_decoding": {"regex": "a", "choice": ["a"]}}},
    {"response_format": {"type": "json_object"},
     "nvext": {"guided_decoding": {"regex": "a"}}},
], ids=["grammar", "two-kinds", "two-sources"])
def test_ungrammatical_requests_answer_400(frontend_port, body):
    status, data = _post(frontend_port, "chat/completions",
                         {**_CHAT, "max_tokens": 4, **body})
    assert status == 400, data
    assert "guided_decoding" in data["error"]["message"]
