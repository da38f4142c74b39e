"""Mixture-of-experts decoders in the port (models/moe.py, the MoE branches
of init_params, params_from_numpy, the checkpoint loader and writer, and the
runner's prefill padding) against the JAX package, on tiny-moe-test and
`dataclasses.replace` variants of it, on the CPU.

Tolerances: routing indices equal and weights within 1e-6 (f32); the
capacity dispatch's slots equal the reference's one-hot dispatch exactly;
`moe` within 1e-5 of the JAX `_moe` in f32, and within one bf16 ulp of the
output's largest magnitude in bf16 (the two sum the expert products in
other orders); engine streams token for token. The forwards are held
in test_torch_transformer.py (its "moe-*" cases).

Both schedulers are pumped step by step on the test's thread, so arrivals
land at the same step in each package and the prefill work lists, which
decide each row's padded length and so its expert capacity, are the same.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.models import checkpoint as ref_ckpt
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models import transformer as jt
from dynamo_tpu.models.quantize import check_quantizable as ref_quantizable
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig, TorchWorker
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import checkpoint as port_ckpt
from dynamo_tpu_torch.models import get_config as t_get_config
from dynamo_tpu_torch.models import init_params, moe, params_from_numpy
from dynamo_tpu_torch.models.quantize import check_quantizable
from dynamo_tpu_torch.models.transformer import check_supported

_MOE = get_config("tiny-moe-test")
F32 = dataclasses.replace(_MOE, dtype="float32")
RUNNER = dict(page_size=4, num_pages=128, max_batch=4, max_pages_per_seq=32,
              prefill_buckets=(8, 16, 32))
# The three routings: Mixtral / Qwen3-MoE (softmax, renormalized top-k),
# DeepSeek-V2 (softmax, raw top-k scores times a scale) and DeepSeek-V3
# (sigmoid scores, a selection bias, 2 of 4 groups, renormalized, scaled).
ROUTINGS = {
    "softmax-norm": F32,
    "softmax-scaled": dataclasses.replace(
        F32, n_experts=8, n_experts_active=3, moe_norm_topk=False,
        moe_routed_scale=2.5),
    "sigmoid-grouped": dataclasses.replace(
        F32, n_experts=8, n_experts_active=3, moe_scoring="sigmoid",
        moe_n_group=4, moe_topk_group=2, moe_routed_scale=2.5),
}


# The reference's MoE functions, jitted (the config is static)
J_ROUTE = jax.jit(jt._routing_weights, static_argnums=2)
J_MOE = jax.jit(jt._moe, static_argnums=2)
J_MOE_DENSE = jax.jit(jt._moe_dense, static_argnums=2)


def _layer(cfg, seed=0, shared=False):
    """(JAX layer params, the port's layer) of the first MoE layer, with a
    nonzero selection bias for sigmoid scoring."""
    if shared:
        cfg = dataclasses.replace(cfg, n_shared_experts=1)
    params = jax.device_get(j_init(jax.random.PRNGKey(seed), cfg))
    lp = params["layers"][0]
    if "e_bias" in lp:
        lp["e_bias"] = (np.random.default_rng(seed + 1)
                        .normal(size=lp["e_bias"].shape) * 0.1
                        ).astype(np.float32)
    model = params_from_numpy(params, cfg, device="cpu")
    return cfg, lp, model.layers[0]


def _x(cfg, b, t, seed, pads=0):
    """Hidden states [b, t, h] in cfg.dtype, as (jax, torch) with equal
    values; the last `pads` rows of each row repeat one vector, as bucket
    padding's identical tokens do."""
    x = np.random.default_rng(seed).normal(size=(b, t, cfg.hidden))
    if pads:
        x[:, t - pads:] = x[:, t - pads:t - pads + 1]
    xj = jnp.asarray(x, jnp.dtype(cfg.dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, cfg.dtype))
    return xj, xt


# -- routing -------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ROUTINGS))
def test_routing_weights_match_jax(name):
    cfg, lp, layer = _layer(ROUTINGS[name])
    for t in (1, 5, 32):
        xj, xt = _x(cfg, 3, t, seed=t)
        j_w, j_i = J_ROUTE(xj, lp, cfg)
        w, i = moe.routing_weights(xt, layer, cfg)
        np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))
        np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-6,
                                   atol=1e-6)


def test_tied_scores_pick_the_lower_expert_first():
    """Duplicate router columns give exactly equal scores: the picks and
    their order (which decides who wins a slot) are jax.lax.top_k's."""
    cfg = dataclasses.replace(F32, n_experts=8, n_experts_active=3)
    cfg, lp, layer = _layer(cfg)
    router = np.asarray(lp["router"]).copy()
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    router[:, 6] = router[:, 1]
    lp["router"] = router
    layer["router"] = torch.from_numpy(router)
    xj, xt = _x(cfg, 2, 16, seed=4)
    _, j_i = J_ROUTE(xj, lp, cfg)
    _, i = moe.routing_weights(xt, layer, cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_i))


# -- the capacity dispatch -----------------------------------------------------


def _ref_dispatch(topi, cfg, t):
    """The reference's dispatch tensor [b, t, k, e, cap] from its own
    formulation (`_moe` lines: k-major one-hot cumsum)."""
    b, _, k = topi.shape
    e = cfg.n_experts
    cap = moe.capacity(cfg, t)
    sel = jax.nn.one_hot(topi, e, dtype=jnp.float32)
    sel_flat = sel.transpose(0, 2, 1, 3).reshape(b, k * t, e)
    pos = jnp.cumsum(sel_flat, axis=1) - sel_flat
    keep = sel_flat * (pos < cap)
    slot = jax.nn.one_hot(pos, cap, dtype=jnp.float32)
    return np.asarray((keep[..., None] * slot).reshape(
        b, k, t, e, cap).transpose(0, 2, 1, 3, 4))


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_pick_slots_equal_the_reference_dispatch(cf):
    """Every pick's (expert, slot) and whether it is kept equal the
    reference's one-hot dispatch, padding rows included."""
    cfg = dataclasses.replace(F32, moe_capacity_factor=cf)
    cfg, lp, layer = _layer(cfg)
    t = 16
    xj, xt = _x(cfg, 3, t, seed=9, pads=6)
    _, topi = moe.routing_weights(xt, layer, cfg)
    slot, keep = moe.pick_slots(topi, cfg.n_experts, moe.capacity(cfg, t))
    want = _ref_dispatch(jnp.asarray(topi.numpy()), cfg, t)
    got = np.zeros_like(want)
    b, k, _ = slot.shape
    for r in range(b):
        for j in range(k):
            for tok in range(t):
                if keep[r, j, tok]:
                    got[r, tok, j, topi[r, tok, j], slot[r, j, tok]] = 1
    np.testing.assert_array_equal(got, want)
    assert bool((~keep).any())  # the 6 identical padding rows overflow


MOE_CASES = {
    # (config overrides, tolerance): cf 8 keeps every pick, cf 0.25 drops
    "f32-cf8": (dict(dtype="float32", moe_capacity_factor=8.0), 1e-5),
    "f32-cf0.25": (dict(dtype="float32", moe_capacity_factor=0.25), 1e-5),
    "f32-shared-cf1.25": (dict(dtype="float32", n_shared_experts=1), 1e-5),
    "bf16-cf8": (dict(moe_capacity_factor=8.0), None),
    "bf16-cf0.25": (dict(moe_capacity_factor=0.25), None),
}


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_matches_jax(name):
    """`moe` against the JAX `_moe` at t = 1 (decode), t = 5 (a
    verification chunk) and a 32-token bucket with 12 padding rows; at
    capacity factor 8 nothing drops and both also equal `_moe_dense`."""
    overrides, tol = MOE_CASES[name]
    cfg, lp, layer = _layer(dataclasses.replace(_MOE, **overrides))
    for t, pads in ((1, 0), (5, 0), (32, 12)):
        xj, xt = _x(cfg, 3, t, seed=t, pads=pads)
        want = np.asarray(J_MOE(xj, lp, cfg).astype(jnp.float32))
        got = moe.moe(xt, layer, cfg).float().numpy()
        atol = tol or _bf16_ulp(float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        if cfg.moe_capacity_factor >= 8:
            dense = moe.moe_dense(xt, layer, cfg).float().numpy()
            np.testing.assert_allclose(got, dense, rtol=0, atol=atol)
            np.testing.assert_allclose(
                dense, np.asarray(J_MOE_DENSE(xj, lp, cfg).astype(
                    jnp.float32)), rtol=0, atol=atol)


def test_shared_expert_and_dense_oracle_match_jax():
    cfg, lp, layer = _layer(ROUTINGS["sigmoid-grouped"], shared=True)
    xj, xt = _x(cfg, 2, 7, seed=3)
    np.testing.assert_allclose(
        moe.shared_expert(xt, layer).numpy(),
        np.asarray(jt._shared_expert(xj, lp)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        moe.moe_dense(xt, layer, cfg).numpy(),
        np.asarray(J_MOE_DENSE(xj, lp, cfg)), rtol=1e-5, atol=1e-5)


def test_decode_and_verification_never_drop():
    """cap' = min(cap, t): at t = 1 and t = K + 1 every pick is kept, and
    the expert buffer has t rows per (expert, batch row)."""
    cfg = t_get_config("qwen3-30b-a3b")
    for t in (1, 5):
        cap = moe.capacity(cfg, t)
        assert cap == 8 and min(cap, t) == t
        topi = torch.stack([torch.randperm(128)[:8] for _ in range(16 * t)]
                           ).view(16, t, 8)
        _, keep = moe.pick_slots(topi, 128, cap)
        assert bool(keep.all())


# -- weights -------------------------------------------------------------------


def test_params_carry_experts_bit_exact_and_drop_dense_leaves():
    cfg = dataclasses.replace(_MOE, n_layers=3, first_k_dense=1,
                              n_shared_experts=1, moe_scoring="sigmoid",
                              moe_n_group=2, moe_topk_group=1)
    params = jax.device_get(j_init(jax.random.PRNGKey(2), cfg))
    model = params_from_numpy(params, cfg, device="cpu")
    assert "w_gate" in model.layers[0] and "router" not in model.layers[0]
    for i in (1, 2):
        layer, ref = model.layers[i], params["layers"][i]
        assert {"w_gate", "w_up", "w_down"} <= set(ref)
        assert set(layer.keys()) == set(ref) - {"w_gate", "w_up", "w_down"}
        for name in layer.keys():
            want = np.asarray(ref[name])
            got = layer[name].detach()
            assert str(got.dtype).split(".")[-1] == want.dtype.name, name
            if want.dtype.name == "bfloat16":
                got, want = got.view(torch.int16).numpy(), want.view(np.int16)
            np.testing.assert_array_equal(np.asarray(got), want, name)
    assert model.layers[1]["e_bias"].dtype == torch.float32


def test_init_params_builds_moe_layers():
    cfg = dataclasses.replace(_MOE, n_layers=3, first_k_dense=1,
                              n_shared_experts=2, moe_scoring="sigmoid",
                              moe_n_group=2, moe_topk_group=1)
    model = init_params(cfg, device="cpu")
    ref = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), cfg))
    for i, layer in enumerate(model.layers):
        want = {k: v for k, v in ref["layers"][i].items()
                if i == 0 or k not in ("w_gate", "w_up", "w_down")}
        assert set(layer.keys()) == set(want)
        for name, spec in want.items():
            assert tuple(layer[name].shape) == spec.shape, name
            assert str(layer[name].dtype).split(".")[-1] == spec.dtype.name
    assert not model.layers[1]["e_bias"].any()


@pytest.mark.parametrize("name", ["qwen3-30b-a3b", "mixtral-8x7b",
                                  "tiny-moe-test"])
def test_moe_presets_are_supported_and_refuse_quantization(name):
    cfg = t_get_config(name)
    check_supported(cfg)
    for dtype in ("int8", "int4"):
        with pytest.raises(ValueError) as info:
            check_quantizable(cfg, dtype)
        with pytest.raises(ValueError) as ref_info:
            ref_quantizable(get_config(name), dtype=dtype)
        assert str(info.value) == str(ref_info.value)
    small = dataclasses.replace(cfg, vocab_size=64, hidden=32, n_layers=1,
                                n_q_heads=2, n_kv_heads=1, head_dim=16,
                                mlp_hidden=32, expert_mlp_hidden=16)
    model = init_params(small, device="cpu")
    assert model.layers[0]["e_gate"].shape == (cfg.n_experts, 32, 16)
    runner = RunnerConfig(num_pages=8, max_pages_per_seq=4)
    worker = TorchWorker(small, runner, device="cpu", params=model)
    assert worker.runner.model is model
    with pytest.raises(ValueError, match="MLA/MoE/gpt-oss"):
        TorchWorker(small, RunnerConfig(weight_dtype="int8", num_pages=8,
                                        max_pages_per_seq=4), device="cpu")


@pytest.mark.parametrize("qk_norm", [True, False], ids=["qwen3moe", "mixtral"])
def test_checkpoint_directories_load_alike_in_both_packages(tmp_path,
                                                            qk_norm):
    """A Qwen3-MoE (qk_norm) and a Mixtral directory written by the port's
    save_params, sharded: both packages read the same tensors, and those
    are the written model's."""
    cfg = dataclasses.replace(_MOE, qk_norm=qk_norm, tie_embeddings=False)
    params = jax.device_get(j_init(jax.random.PRNGKey(0), cfg))
    model = params_from_numpy(params, cfg, device="cpu")
    port_ckpt.save_params(model, cfg, str(tmp_path), max_shard_bytes=200_000)
    with port_ckpt.ShardReader(str(tmp_path)) as reader:
        names = reader.names()
    style = "mlp.experts.3.down_proj" if qk_norm else \
        "block_sparse_moe.experts.3.w2"
    assert f"model.layers.1.{style}.weight" in names
    assert not any("mlp.gate_proj" in n for n in names)
    got = port_ckpt.load_params(
        str(tmp_path), port_ckpt.config_from_checkpoint(str(tmp_path)),
        device="cpu")
    ref = ref_ckpt.load_params(
        str(tmp_path), ref_ckpt.config_from_checkpoint(str(tmp_path)))
    for i, layer in enumerate(got.layers):
        for name in layer.keys():
            mine = layer[name].float().numpy()
            np.testing.assert_array_equal(
                mine, np.asarray(jnp.asarray(ref["layers"][i][name],
                                             jnp.float32)), name)
            np.testing.assert_array_equal(
                mine, model.layers[i][name].float().numpy(), name)
        # the reference zero-fills dense leaves the port does not hold
        assert not np.asarray(ref["layers"][i]["w_gate"]).any()
        assert "w_gate" not in layer


def test_reference_written_directory_serves_in_the_port(tmp_path):
    """A Qwen3-MoE directory written by the reference's save_params: the
    port's worker builds from it (the card named after the directory), its
    leaves bit-equal to params_from_numpy of the written params."""
    cfg = dataclasses.replace(_MOE, qk_norm=True, tie_embeddings=False)
    params = jax.device_get(j_init(jax.random.PRNGKey(3), cfg))
    ckpt = str(tmp_path / "qwen3moe-tiny")
    ref_ckpt.save_params(params, cfg, ckpt)
    worker = TorchWorker(model_path=ckpt, device="cpu",
                         runner_config=RunnerConfig(**RUNNER))
    assert worker.card.name == "qwen3moe-tiny"
    assert worker.model_config.n_experts == cfg.n_experts
    want = params_from_numpy(params, cfg, device="cpu")
    for got_layer, want_layer in zip(worker.runner.model.layers,
                                     want.layers):
        assert sorted(got_layer.keys()) == sorted(want_layer.keys())
        for name in got_layer.keys():
            assert torch.equal(got_layer[name], want_layer[name]), name


def test_unrecognized_expert_names_raise(tmp_path):
    cfg = dataclasses.replace(_MOE, tie_embeddings=False)
    model = params_from_numpy(
        jax.device_get(j_init(jax.random.PRNGKey(0), cfg)), cfg,
        device="cpu")
    port_ckpt.save_params(model, cfg, str(tmp_path))
    with port_ckpt.ShardReader(str(tmp_path)) as reader:
        present = {n.replace("experts.", "expert_") for n in reader.names()}
    with pytest.raises(KeyError) as info:
        port_ckpt._expert_style(present, "model.layers.0.")
    with pytest.raises(KeyError) as ref_info:
        ref_ckpt._expert_style(present, "model.layers.0.")
    assert str(info.value) == str(ref_info.value)


# -- the runner and the engine -------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return {cf: jax.device_get(j_init(
        jax.random.PRNGKey(0),
        dataclasses.replace(F32, moe_capacity_factor=cf)))
        for cf in (1.25, 0.25)}


def _cfg(cf):
    return dataclasses.replace(F32, moe_capacity_factor=cf)


def _runners(params, cf):
    cfg = _cfg(cf)
    port = ModelRunner(cfg, RunnerConfig(**RUNNER), device="cpu",
                       params=params_from_numpy(params[cf], cfg,
                                                device="cpu"))
    ref = JRunner(cfg, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                  params=params[cf])
    return port, ref


def test_prefill_rows_take_the_work_lists_bucket(params):
    """Chunks of 20, 5, 7 and 3 tokens in one work list: the reference pads
    all four to bucket 32 in one dispatch; the port splits them into groups
    (B x 32 within the 32-token largest bucket: one row each) and pads each
    row to 32 too, so every row's token and logprobs equal the reference's
    at capacity factor 0.25, where a row padded to its own bucket drops
    other picks and comes out otherwise."""
    cf = 0.25
    port, ref = _runners(params, cf)
    rng = np.random.default_rng(5)
    lengths = [20, 5, 7, 3]
    rows = [(rng.integers(1, F32.vocab_size, n), 0,
             np.arange(1 + 8 * i, 1 + 8 * i + 32, dtype=np.int32), n,
             (0.0, 1.0, 0, 7 + i)) for i, n in enumerate(lengths)]
    assert port.work_bucket(lengths) == 32
    assert port.prefill_groups(lengths) == [[0], [1], [2], [3]]
    got = port.prefill_chunk_batch(rows, want_samples=True)
    want = ref.prefill_chunk_batch(
        [(t.astype(np.int32), s, tb, kv, samp, 0)
         for t, s, tb, kv, samp in rows], want_samples=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:4])
    assert {key[:4] for key in port.step_graphs} == {("prefill", 1, 32, 32)}
    for mine, theirs in zip(port.last_prefill_samples,
                            ref.last_prefill_samples):
        np.testing.assert_allclose(mine[0], theirs[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(mine[1], theirs[1])
    # alone, a row takes its own bucket: the same for the 20-token row
    # (32), another for the short rows (8), and there the drops differ
    batched = [lp for lp, _, _ in port.last_prefill_samples]
    alone = []
    for row in rows:
        port.prefill_chunk(*row)
        alone.append(port.last_prefill_sample[0])
    assert abs(alone[0] - batched[0]) <= 1e-6
    assert any(abs(a - b) > 1e-3 for a, b in zip(alone[1:], batched[1:]))


PROMPT_LENGTHS = (21, 13, 30, 6)
MAX_TOKENS = 10


class Stream:
    def __init__(self):
        self.tokens: list = []
        self.finish = None

    def emit(self, out) -> None:
        self.tokens += out.token_ids
        if out.finish_reason is not None:
            self.finish = out.finish_reason


def _pump(sched, done, limit=500) -> None:
    """Run the scheduler's loop body on this thread until `done()`."""
    for _ in range(limit):
        if done():
            return
        sched._drain_control()
        sched._drain_incoming()
        if not sched._step():
            sched._drain_gap()
    raise AssertionError("the scheduler stalled")


def _serve(sched, pkg):
    """Four prompts: two at once, a third after the first step, a fourth
    once every stream has tokens (its prefill then runs beside decode)."""
    req, samp, stop = ((PreprocessedRequest, SamplingOptions, StopConditions)
                       if pkg == "port" else (JRequest, JSampling, JStop))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, F32.vocab_size, n).tolist()
               for n in PROMPT_LENGTHS]
    streams = [Stream() for _ in prompts]

    def submit(i):
        sched.submit(req(request_id=f"{pkg}-{i}", token_ids=prompts[i],
                         sampling=samp(max_tokens=MAX_TOKENS,
                                       temperature=0.0, seed=i),
                         stop=stop(ignore_eos=True)), streams[i].emit)

    submit(0)
    submit(1)
    _pump(sched, lambda: sched.stats.steps >= 1)
    submit(2)
    _pump(sched, lambda: all(s.tokens for s in streams[:3]))
    submit(3)
    _pump(sched, lambda: all(s.finish for s in streams))
    return [(s.tokens, s.finish) for s in streams]


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_worker_greedy_streams_equal_the_jax_engine(params, cf):
    """TorchWorker's scheduler and the JAX engine's, pumped alike, emit the
    same greedy tokens at capacity factor 1.25 and at 0.25 (prefill rows
    drop picks, bucket padding among them); the port batched prefill
    chunks of several rows."""
    cfg = _cfg(cf)
    worker = TorchWorker(cfg, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(params[cf], cfg,
                                                  device="cpu"))
    got = _serve(worker.scheduler, "port")
    _, ref = _runners(params, cf)
    want = _serve(JScheduler(ref), "ref")
    assert got == want
    assert all(finish == "length" and len(tokens) == MAX_TOKENS
               for tokens, finish in got)
    assert worker.scheduler.stats.prefill_batched_steps >= 1
    assert worker.runner.eager_forwards == {"decode": 0, "spec": 0,
                                            "prefill": 0}
