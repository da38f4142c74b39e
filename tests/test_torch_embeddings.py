"""Embeddings in the port: `forward_embed`, `ModelRunner.embed`, the worker's
`emb` frame and `/v1/embeddings`, against the JAX package's.

`forward_embed` runs on the same numpy inputs and `params_from_numpy`
weights in both packages, with padded and unpadded `valid` rows.
Tolerances on the unit vectors (max |difference| of a component): float32
1e-5 (XLA's and PyTorch's CPU kernels sum in different orders); bfloat16
1e-2 (the two frameworks round intermediate products to bf16 at different
points; components are ~0.06 at H = 256); W4A16 2e-4 (the port's quantized
leaves handed to JAX, f32 activations). MLA is refused as the reference
asserts; gpt-oss, on which the reference's loop fails, is refused with a
message naming the family. The HTTP tests use test_torch_serving's four
frontend -> worker pairings (port or reference frontend over a TorchWorker
or a TpuWorker, tiny-test f32): the port stack's vectors equal the
reference stack's within 1e-5, base64 decodes to the float answer bit for
bit, and every refusal answers the reference's status and body. Binds
127.0.0.1 only, spawns no subprocess.
"""

import asyncio
import base64
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models.transformer import forward_embed as j_forward_embed
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.frontend import Frontend as RefFrontend
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig
from dynamo_tpu_torch.engine.model_runner import table_widths
from dynamo_tpu_torch.frontend import Frontend
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import forward_embed, params_from_numpy
from dynamo_tpu_torch.models import quantize as tquant
from dynamo_tpu_torch.ops import Q4Weight
from dynamo_tpu_torch.runtime import DistributedRuntime
from test_torch_serving import (  # noqa: F401 — `stacks` is a fixture
    CFG,
    MODEL,
    RUNNER,
    STEP,
    _port_config,
    _ref_config,
    _request,
    _wait_for,
    stacks,
)

_TINY = get_config("tiny-test")
_MOE = get_config("tiny-moe-test")
# name -> (config, tolerance, whether the port quantizes to W4A16)
CONFIGS = {
    "dense-f32": (dataclasses.replace(_TINY, dtype="float32"), 1e-5, False),
    "dense-bf16": (_TINY, 1e-2, False),
    # test_torch_quantized_engine.py's int4-able shape of tiny-test
    "dense-w4a16": (dataclasses.replace(
        _TINY, dtype="float32", hidden=512, mlp_hidden=1024, n_layers=1,
        vocab_size=512, n_q_heads=4, n_kv_heads=2, head_dim=128,
        tie_embeddings=False), 2e-4, True),
    "moe-f32": (dataclasses.replace(_MOE, dtype="float32"), 1e-5, False),
    "moe-bf16": (_MOE, 1e-2, False),
}
B, T = 3, 16
# unpadded, padded, one valid token
LENGTHS = (16, 5, 1)


def _params(name):
    """(JAX params, the port's model); the W4A16 model quantized by the
    port's quantizer and its leaves handed to JAX."""
    cfg, _, quantize = CONFIGS[name]
    params = jax.device_get(j_init(jax.random.PRNGKey(0), cfg))
    model = params_from_numpy(params, cfg, device="cpu")
    if quantize:
        tquant.quantize_params_int4(model)
        for lp, layer in zip(params["layers"], model.layers):
            for key in layer.keys():
                if isinstance(layer[key], Q4Weight):
                    lp[key] = {k: v.numpy()
                               for k, v in layer[key].leaf().items()}
    return params, model


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    valid = np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]
    return tokens, valid


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_embed_matches_jax(name):
    cfg, tol, _ = CONFIGS[name]
    params, model = _params(name)
    tokens, valid = _inputs(cfg)
    want = np.asarray(jax.jit(functools.partial(
        j_forward_embed, config=cfg))(params, tokens=jnp.asarray(tokens),
                                      valid=jnp.asarray(valid)), np.float32)
    got = forward_embed(model, torch.from_numpy(tokens).long(),
                        torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (B, cfg.hidden)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    # padding reaches neither the attention nor the pool: the padded row
    # is the unpadded forward of its valid prefix
    n = LENGTHS[1]
    alone = forward_embed(model, torch.from_numpy(tokens[1:2, :n]).long(),
                          torch.ones((1, n), dtype=torch.bool))
    if not cfg.n_experts:  # (a MoE row's capacity follows its padded T)
        np.testing.assert_allclose(alone.numpy()[0], got.numpy()[1],
                                   atol=tol, rtol=0)


def test_mla_and_gptoss_are_refused():
    """The reference asserts on MLA ("embedding path supports
    standard-attention models") and fails inside its loop on gpt-oss (its
    layers hold no dense MLP); the port raises ValueError for both."""
    for preset, ref_error, match in (
            ("tiny-mla-test", AssertionError,
             "embedding path supports standard-attention models"),
            ("tiny-gptoss-test", KeyError, "gpt-oss")):
        cfg = dataclasses.replace(get_config(preset), dtype="float32",
                                  n_layers=1)
        params = jax.device_get(jax.jit(j_init, static_argnums=1)(
            jax.random.PRNGKey(0), cfg))
        tokens, valid = _inputs(cfg)
        with pytest.raises(ref_error):
            jax.jit(functools.partial(j_forward_embed, config=cfg))(
                params, tokens=jnp.asarray(tokens), valid=jnp.asarray(valid))
        model = params_from_numpy(params, cfg, device="cpu")
        with pytest.raises(ValueError, match=match):
            forward_embed(model, torch.from_numpy(tokens).long(),
                          torch.from_numpy(valid))


@pytest.fixture(scope="module")
def runners():
    params = jax.device_get(j_init(jax.random.PRNGKey(0), CFG))
    port = ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu",
                       params=params_from_numpy(params, CFG, device="cpu"))
    ref = JRunner(CFG, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                  params=params)
    return port, ref


def test_runner_embed_pads_to_the_bucket_as_the_reference(runners):
    port, ref = runners
    rng = np.random.default_rng(5)
    for n in (1, 8, 9, 32):
        tokens = rng.integers(1, CFG.vocab_size, n).astype(np.int32)
        got, want = port.embed(tokens), ref.embed(tokens)
        assert got.dtype == np.float32 and got.shape == (CFG.hidden,)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        bucket = port._bucket_for(n)
        tok = np.zeros((1, bucket), np.int64)
        tok[0, :n] = tokens
        at_bucket = forward_embed(port.model, torch.from_numpy(tok),
                                  torch.arange(bucket)[None] < n)[0]
        np.testing.assert_array_equal(got, at_bucket.numpy())
    for runner in (port, ref):
        with pytest.raises(ValueError) as info:
            runner.embed(np.ones(33, np.int32))
        assert str(info.value) == ("embedding input of 33 tokens exceeds "
                                   "the engine's max sequence bucket (32)")


def test_embed_captures_no_graph_and_prewarm_keys_stay(monkeypatch):
    """prewarm's keys are test_torch_graphs' (block 1, no speculation):
    embedding runs eagerly afterwards, captures nothing, replays nothing
    and runs no prefill step."""
    monkeypatch.setenv("DYNT_DECODE_BLOCK", "1")
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "0")
    params = jax.device_get(j_init(jax.random.PRNGKey(0), CFG))
    runner = ModelRunner(CFG, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params, CFG, device="cpu"))
    runner.prewarm()
    b, pages = RUNNER["max_batch"], RUNNER["max_pages_per_seq"]
    widths = table_widths(pages)
    want = {("decode", b, w, lp) for w in widths for lp in (False, True)}
    want |= {("decode_logits", b, w, None) for w in widths}
    want |= {("prefill", rows, pages, bucket)
             for rows, bucket in runner.prefill_keys()}
    keys = set(runner.step_graphs)
    assert {key[:4] for key in keys} == want
    counts = (runner.graph_captures, runner.graph_replays,
              runner.prefill_steps, runner.decode_steps)
    for n in (3, 17, 32):
        runner.embed(np.arange(1, n + 1, dtype=np.int32))
    assert set(runner.step_graphs) == keys
    assert (runner.graph_captures, runner.graph_replays,
            runner.prefill_steps, runner.decode_steps) == counts
    assert runner.embed_calls == 3


def test_worker_emb_frame_matches_the_jax_worker(stacks):
    """The same embed wire dict through a TorchWorker and a TpuWorker: one
    `stop` frame each, with the prompt count and vectors within 1e-5; an
    input past the largest bucket errors in band with the same text."""
    lt = stacks["loop"]

    def frames(worker, tokens):
        body = PreprocessedRequest(
            request_id="e", token_ids=tokens,
            sampling=SamplingOptions(max_tokens=1, temperature=0.0),
            stop=StopConditions(), model=MODEL,
            annotations={"embed": True}).to_wire()

        async def collect():
            return [f async for f in worker.generate(body)]
        return lt.run(collect())

    tokens = list(range(3, 23))
    port = frames(stacks["worker"], tokens)
    ref = frames(stacks["ref_worker"], tokens)
    assert len(port) == len(ref) == 1
    assert {k: v for k, v in port[0].items() if k != "emb"} == \
        {k: v for k, v in ref[0].items() if k != "emb"} == {
            "t": [], "f": "stop", "p": 20}
    np.testing.assert_allclose(port[0]["emb"], ref[0]["emb"], atol=1e-5)
    port, ref = (frames(w, [5] * 40) for w in (stacks["worker"],
                                                stacks["ref_worker"]))
    assert port == ref and port[-1]["f"] == "error"
    assert "exceeds the engine's max sequence bucket (32)" in port[-1]["err"]


_RNG = np.random.default_rng(11)
EMBED_REQUESTS = {
    "string": {"input": "The quick brown fox"},
    "strings": {"input": ["a", "jumps over", "the lazy dog"]},
    "tokens": {"input": _RNG.integers(1, 256, 9).tolist()},
    "token-lists": {"input": [_RNG.integers(1, 256, 30).tolist(),
                              _RNG.integers(1, 256, 4).tolist()]},
    "string-base64": {"input": "héllo", "encoding_format": "base64"},
    "token-lists-base64": {"input": [[7, 8, 9], [10]],
                           "encoding_format": "base64"},
}


def _vectors(data: dict) -> list:
    out = []
    for item in data["data"]:
        emb = item["embedding"]
        out.append(np.frombuffer(base64.b64decode(emb), "<f4")
                   if isinstance(emb, str) else np.asarray(emb, np.float32))
    return out


@pytest.mark.parametrize("name", sorted(EMBED_REQUESTS))
def test_embeddings_route_matches_the_reference(stacks, name):
    """Each input form through the four pairings: the same body but for
    the vectors, which agree within 1e-5 (the same worker's bit for bit
    through both frontends); base64 is the float answer's f32 bytes."""
    body = {"model": MODEL, **EMBED_REQUESTS[name]}
    answers = {}
    for which in "acbd":
        status, headers, text = _request(stacks["ports"][which], "POST",
                                         "/v1/embeddings", body)
        assert status == 200, text
        assert headers["Content-Type"].startswith("application/json")
        answers[which] = json.loads(text)
    shape = {k: v for k, v in answers["c"].items() if k != "data"}
    for which, data in answers.items():
        assert {k: v for k, v in data.items() if k != "data"} == shape
        assert [(d["object"], d["index"]) for d in data["data"]] == [
            ("embedding", i) for i in range(len(data["data"]))]
    vecs = {w: _vectors(d) for w, d in answers.items()}
    for torch_side, jax_side in (("a", "c"), ("b", "d")):
        for x, y in zip(vecs[torch_side], vecs[jax_side]):
            np.testing.assert_allclose(x, y, atol=1e-5)
    for x, y in zip(vecs["a"], vecs["b"]):  # the TorchWorker twice
        np.testing.assert_array_equal(x, y)
    for v in vecs["a"]:
        assert abs(np.linalg.norm(v) - 1.0) < 1e-5
    if body.get("encoding_format") == "base64":
        floats = json.loads(_request(stacks["ports"]["a"], "POST",
                                     "/v1/embeddings", {
                                         **body, "encoding_format": "float"
                                     })[2])
        for x, y in zip(vecs["a"], _vectors(floats)):
            assert x.tobytes() == y.tobytes()


EMBED_ERRORS = {
    "unknown-model": {"model": "missing", "input": "x"},
    "no-input": {"model": MODEL},
    "empty-list": {"model": MODEL, "input": []},
    "mixed-list": {"model": MODEL, "input": ["a", 1]},
    "dict-input": {"model": MODEL, "input": {"a": 1}},
    "bad-encoding": {"model": MODEL, "input": "x",
                     "encoding_format": "hex"},
    "over-context": {"model": MODEL, "input": [5] * 200},
    "over-bucket": {"model": MODEL, "input": [5] * 40},
    "invalid-json": None,
    "adapter": {"model": "adapter-x", "input": "x"},
}


@pytest.mark.parametrize("name", sorted(EMBED_ERRORS))
def test_embeddings_refusals_match_the_reference(stacks, name):
    """Status and body of every refusal, port frontend over a TorchWorker
    against the reference stack: 400 (input, encoding, context length, a
    LoRA adapter's name), 404, and the worker's in-band error as 502."""
    body = EMBED_ERRORS[name]
    raw = b"{not json" if body is None else None
    entries = []
    if name == "adapter":
        # as a card advertising the adapter would register it
        for which in "ac":
            entry = stacks["frontends"][which].manager.get(MODEL)
            entry.instance_loras[-1] = ["adapter-x"]
            entries.append(entry)
    try:
        port = _request(stacks["ports"]["a"], "POST", "/v1/embeddings",
                        body, raw)
        ref = _request(stacks["ports"]["c"], "POST", "/v1/embeddings",
                       body, raw)
    finally:
        for entry in entries:
            entry.instance_loras.pop(-1)
    assert port[0] == ref[0] and port[0] in (400, 404, 502)
    assert json.loads(port[2]) == json.loads(ref[2])


def test_embeddings_with_no_instance_answer_as_the_reference(run, tmp_path):
    """A listed model whose instances are gone: the migration layer's
    in-band error, 502 from both frontends with the same body."""

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
                _request, fe.port, "POST", "/v1/embeddings",
                {"model": "ghost", "input": "x"}), STEP)
        finally:
            await fe.close()
            await rt.shutdown()

    port, ref = run(go(True)), run(go(False))
    assert port[0] == ref[0] == 502
    assert json.loads(port[2]) == json.loads(ref[2])
