"""gpt-oss in the port (the YaRN rope, sink attention with the alternating
sliding window, the biased projections, `moe_gptoss`, the forward branch,
the runner's unified decode, the MXFP4 loader) against the JAX package, on
tiny-gptoss-test and `dataclasses.replace` variants of it, on the CPU.

Tolerances: the rope tables and the rotation 1e-6 (f32); sink attention
1e-5 (f32); `moe_gptoss` 1e-6 of the output's largest magnitude in f32
and one bf16 ulp of the output's
largest magnitude in bf16 (the two frameworks sum the experts' products in
other orders); the whole forward as test_torch_transformer.py holds it
(f32: logits 1e-4, the pool 1e-5); engine streams
token for token; MXFP4 dequantization and the loaded trees bit for bit.
The JAX side runs as tests/test_gptoss.py runs it: plain XLA on the CPU
(its gpt-oss path reaches no Pallas kernel).
"""

import dataclasses
import json
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
from dynamo_tpu.models import forward as j_forward
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models import make_kv_cache as j_make_kv
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
from dynamo_tpu_torch.models import forward, make_kv_cache, params_from_numpy
from dynamo_tpu_torch.models import get_config as t_get_config
from dynamo_tpu_torch.models import init_params
from dynamo_tpu_torch.models import transformer as tt
from dynamo_tpu_torch.models.moe import _top_k, moe_gptoss
from dynamo_tpu_torch.models.quantize import check_quantizable
from dynamo_tpu_torch.models.safetensors import save_file
from dynamo_tpu_torch.models.transformer import check_supported

TINY = get_config("tiny-gptoss-test")
F32 = dataclasses.replace(TINY, dtype="float32")
RUNNER = dict(page_size=4, num_pages=128, max_batch=4, max_pages_per_seq=32,
              prefill_buckets=(8, 16, 32))

J_MOE = jax.jit(jt._moe_gptoss, static_argnums=2)
J_SINKS = jax.jit(jt.paged_attention_sinks_xla, static_argnums=(2, 7))
J_ROPE = jax.jit(jt.rope_gptoss, static_argnums=2)
J_FORWARD = jax.jit(j_forward, static_argnums=1)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def _tol(dtype: str, want: np.ndarray) -> float:
    """`moe_gptoss`'s tolerance: 1e-6 of the output's largest magnitude in
    f32, one bf16 ulp of it in bf16."""
    top = float(np.abs(want).max())
    return 1e-6 * top if dtype == "float32" else _bf16_ulp(top)


def _to_torch(x) -> torch.Tensor:
    """A JAX / numpy array as a torch tensor of the same dtype and bits."""
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _np32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- YaRN rope -----------------------------------------------------------------


def test_yarn_rope_tables_and_rotation_match_jax():
    """tiny-gptoss-test (factor 8 over 64 positions): the tables and the
    rotation at every position of its 256-token context within 1e-6."""
    inv_freq, att = tt.yarn_rope_tables(F32)
    j_inv, j_att = jt.yarn_rope_tables(F32)
    np.testing.assert_allclose(inv_freq.numpy(), np.asarray(j_inv),
                               rtol=1e-6, atol=1e-6)
    assert att == j_att == 0.1 * math.log(8.0) + 1.0
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 128, 3, F32.head_dim)).astype(np.float32)
    pos = np.arange(256, dtype=np.int32).reshape(2, 128)
    got = tt.rope_gptoss(torch.from_numpy(x), torch.from_numpy(pos).long(),
                         F32)
    want = J_ROPE(jnp.asarray(x), jnp.asarray(pos), F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the scaled tables differ from plain rope's
    plain = tt.rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                    F32.rope_theta)
    assert not torch.allclose(got, plain, atol=1e-3)


def test_yarn_rope_at_gpt_oss_20b_geometry():
    """gpt-oss-20b's rope (head_dim 64, theta 150,000, factor 32 over 4,096
    positions): the tables within 1e-6 and one f32 ulp (XLA's and torch's
    f32 `pow` round 2 of the 32 base powers apart); the rotation at
    positions up to 4,096 within what that ulp moves an angle: position x
    the largest ulp of an inverse frequency, times the attention factor
    and the largest |x|, twice (the rotation's two products)."""
    cfg = dataclasses.replace(t_get_config("gpt-oss-20b"), dtype="float32")
    inv_freq, att = tt.yarn_rope_tables(cfg)
    j_inv, j_att = jt.yarn_rope_tables(get_config("gpt-oss-20b"))
    j_inv = np.asarray(j_inv)
    np.testing.assert_allclose(inv_freq.numpy(), j_inv, rtol=1e-6, atol=1e-6)
    assert np.all(np.abs(inv_freq.numpy() - j_inv) <= np.spacing(j_inv))
    assert att == j_att
    x = np.random.default_rng(2).normal(
        size=(1, 4096, 2, cfg.head_dim)).astype(np.float32)
    pos = np.arange(4096, dtype=np.int32)[None]
    got = tt.rope_gptoss(torch.from_numpy(x), torch.from_numpy(pos).long(),
                         cfg).numpy()
    want = np.asarray(J_ROPE(jnp.asarray(x), jnp.asarray(pos), cfg))
    bound = 2 * att * np.abs(x).max() * 4096 * np.spacing(j_inv).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    np.testing.assert_allclose(got[:, :64], want[:, :64], rtol=0, atol=2e-6)


# -- sink attention ------------------------------------------------------------


@pytest.mark.parametrize("layer", [0, 1], ids=["sliding", "full"])
def test_sink_attention_matches_jax(layer):
    """A 40-token prompt over a random pool, past the window of 16: layer 0
    slides, layer 1 attends in full; the sinks are large enough to take a
    share of each row."""
    cfg = F32
    window = cfg.layer_sliding_window(layer)
    assert window == (16 if layer == 0 else 0)
    rng = np.random.default_rng(2)
    b, t, ps, max_pages = 2, 40, 4, 12
    pages = 1 + b * max_pages
    pool = rng.normal(size=(cfg.n_layers, 2, pages, ps, cfg.n_kv_heads,
                            cfg.head_dim)).astype(np.float32)
    q = rng.normal(size=(b, t, cfg.n_q_heads, cfg.head_dim)).astype(
        np.float32)
    tables = (np.arange(b * max_pages).reshape(b, max_pages) + 1).astype(
        np.int32)
    positions = np.stack([np.arange(t), 7 + np.arange(t)]).astype(np.int32)
    kv_lens = np.asarray([t, t + 7], np.int32)
    sinks = (rng.normal(size=cfg.n_q_heads) * 2).astype(np.float32)
    got = tt.paged_attention_sinks_xla(
        torch.from_numpy(q), torch.from_numpy(pool), layer,
        torch.from_numpy(tables), torch.from_numpy(positions).long(),
        torch.from_numpy(kv_lens), torch.from_numpy(sinks), window)
    want = J_SINKS(jnp.asarray(q), jnp.asarray(pool), layer,
                   jnp.asarray(tables), jnp.asarray(positions),
                   jnp.asarray(kv_lens), jnp.asarray(sinks), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the window cuts: the sliding layer differs from full attention
    full = tt.paged_attention_sinks_xla(
        torch.from_numpy(q), torch.from_numpy(pool), layer,
        torch.from_numpy(tables), torch.from_numpy(positions).long(),
        torch.from_numpy(kv_lens), torch.from_numpy(sinks), 0)
    assert torch.equal(full, got) == (window == 0)


# -- the experts ---------------------------------------------------------------


def _gptoss_layer(cfg, seed=0):
    params = jax.device_get(j_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    lp = params["layers"][0]
    dt = lp["router_bias"].dtype
    for name in ("router_bias", "e_gate_up_bias", "e_down_bias"):
        lp[name] = (rng.normal(size=lp[name].shape) * 0.5).astype(dt)
    model = params_from_numpy(params, cfg, device="cpu")
    return params, lp, model.layers[0]


def _x(cfg, b, t, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(size=(b, t, cfg.hidden)) * scale
    xj = jnp.asarray(x, jnp.dtype(cfg.dtype))
    return xj, _to_torch(xj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gptoss_matches_jax(dtype):
    """Nonzero router and expert biases, inputs scaled so the SwiGLU's
    clips (gate <= 7, |up| <= 7) bind; then tied router logits (a zero
    router and a bias with equal entries): the lower expert wins each tie,
    as `jax.lax.top_k` picks it."""
    cfg = dataclasses.replace(TINY, dtype=dtype)
    _, lp, layer = _gptoss_layer(cfg)
    for t, scale in ((1, 1.0), (7, 4.0), (33, 8.0)):
        xj, xt = _x(cfg, 2, t, seed=t, scale=scale)
        want = _np32(J_MOE(xj, lp, cfg))
        got = moe_gptoss(xt, layer, cfg).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=_tol(dtype, want))
    gate_up = torch.einsum("bth,ehm->betm", xt.float(),
                           layer["e_gate_up"].float())
    assert float(gate_up[..., ::2].max()) > cfg.swiglu_limit
    assert float(gate_up[..., 1::2].min()) < -cfg.swiglu_limit
    # tied logits: every token's logits are the bias, experts 0, 1 and 3 tie
    tied = dict(lp, router=np.zeros_like(lp["router"]),
                router_bias=np.asarray([1.0, 1.0, 0.0, 1.0]).astype(
                    lp["router_bias"].dtype))
    layer["router"] = torch.zeros_like(layer["router"])
    layer["router_bias"] = _to_torch(tied["router_bias"])
    xj, xt = _x(cfg, 2, 7, seed=9)  # t = 7: the shape compiled above
    want = _np32(J_MOE(xj, tied, cfg))
    got = moe_gptoss(xt, layer, cfg).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(dtype, want))
    # experts 0 and 1 (the lower two of the three tied) take every token
    logits = np.broadcast_to(np.asarray([1.0, 1.0, 0.0, 1.0], np.float32),
                             (2, 7, 4))
    picks = _top_k(torch.from_numpy(logits.copy()), cfg.n_experts_active)[1]
    assert picks.tolist() == np.asarray(jax.lax.top_k(
        jnp.asarray(logits), cfg.n_experts_active)[1]).tolist()
    assert picks.unique().tolist() == [0, 1]


# -- the forward ---------------------------------------------------------------


def test_prefill_then_unified_decode_match_jax():
    """A 40-token prefill chunk (past the window of 16) into a paged pool,
    then two unified decode steps (write-then-attend `forward` at T = 1,
    one slot inactive), as the reference's runner decodes gpt-oss; f32,
    the JAX forward jitted. (A jitted bf16 forward fuses ops and keeps f32
    between them, and an eager one compiles every op at every shape: the
    bf16 rounding is held in `moe_gptoss`'s case and on the card.)"""
    cfg, logit_tol, pool_tol = F32, 1e-4, 1e-5
    j_fwd = J_FORWARD
    params = jax.device_get(j_init(jax.random.PRNGKey(0), cfg))
    model = params_from_numpy(params, cfg, device="cpu")
    rng = np.random.default_rng(0)
    b, t, ps, pages, max_pages = 3, 40, 4, 48, 14
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    tables = (np.arange(b * max_pages).reshape(b, max_pages) + 1).astype(
        np.int32)
    valid = np.ones((b, t), bool)
    valid[2, 29:] = False  # a shorter row, padded
    lens = np.asarray([t, t, 29], np.int32)
    j_kv, j_logits = j_fwd(params, cfg, jnp.asarray(tokens),
                               jnp.asarray(positions), j_make_kv(cfg, pages,
                                                                 ps),
                               jnp.asarray(tables), jnp.asarray(lens),
                               valid=jnp.asarray(valid))
    kv = make_kv_cache(cfg, pages, ps, device="cpu")
    logits = forward(model, torch.from_numpy(tokens).long(),
                     torch.from_numpy(positions).long(), kv,
                     torch.from_numpy(tables), torch.from_numpy(lens),
                     valid=torch.from_numpy(valid))
    np.testing.assert_allclose(logits.numpy()[valid], np.asarray(
        j_logits)[valid], rtol=logit_tol, atol=logit_tol)
    np.testing.assert_allclose(kv.float().numpy()[:, :, 1:],
                               _np32(j_kv)[:, :, 1:], rtol=pool_tol,
                               atol=pool_tol)
    active = np.asarray([True, False, True])
    pos = lens.copy()
    for step in range(2):
        tok = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
        j_kv, j_dec = j_fwd(
            params, cfg, jnp.asarray(tok[:, None]), jnp.asarray(pos[:, None]),
            j_kv, jnp.asarray(tables), jnp.asarray(pos + 1),
            valid=jnp.asarray(active[:, None]))
        dec = forward(model, torch.from_numpy(tok[:, None]).long(),
                      torch.from_numpy(pos[:, None]).long(), kv,
                      torch.from_numpy(tables), torch.from_numpy(pos + 1),
                      valid=torch.from_numpy(active[:, None]))
        np.testing.assert_allclose(dec.numpy()[active],
                                   np.asarray(j_dec)[active],
                                   rtol=logit_tol, atol=logit_tol)
        np.testing.assert_allclose(kv.float().numpy()[:, :, 1:],
                                   _np32(j_kv)[:, :, 1:], rtol=pool_tol,
                                   atol=pool_tol)
        pos = pos + active
    # the deferred-write paths refuse gpt-oss
    with pytest.raises(NotImplementedError, match="unified forward"):
        tt.forward_decode(model, torch.zeros(b, dtype=torch.long),
                          torch.from_numpy(pos).long(), kv,
                          torch.from_numpy(tables),
                          torch.from_numpy(pos + 1),
                          torch.from_numpy(active))


def test_params_and_init_carry_the_gptoss_leaves():
    """params_from_numpy carries every gpt-oss leaf bit for bit; the port's
    init_params builds the same leaves at the same shapes and dtypes, and
    no dense MLP leaves."""
    params = jax.device_get(j_init(jax.random.PRNGKey(1), TINY))
    model = params_from_numpy(params, TINY, device="cpu")
    built = init_params(TINY, device="cpu")
    for i, lp in enumerate(params["layers"]):
        assert sorted(model.layers[i].keys()) == sorted(lp) \
            == sorted(built.layers[i].keys())
        assert "w_gate" not in lp
        for name, want in lp.items():
            got = model.layers[i][name]
            assert got.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), np.asarray(want).view(
                    np.int16), name)
            assert built.layers[i][name].shape == got.shape, name
            assert built.layers[i][name].dtype == got.dtype, name
    assert not built.layers[0]["router_bias"].any()


# -- the runner and the engine -------------------------------------------------


@pytest.fixture(scope="module")
def f32_params():
    return jax.device_get(j_init(jax.random.PRNGKey(0), F32))


def test_runner_decodes_unified_and_never_speculates(f32_params):
    """The runner holds no decode or spec attention function for gpt-oss,
    refuses speculation, and pads each prefill group to its own bucket: a
    row's result does not depend on the bucket (no capacity), pinned by
    one row run at buckets 8 and 32."""
    port = ModelRunner(F32, RunnerConfig(**RUNNER), device="cpu",
                       params=params_from_numpy(f32_params, F32,
                                                device="cpu"))
    assert port.decode_attention_fn is None
    assert port.spec_attention_fn is None
    assert port.supports_spec is False
    assert port.work_bucket([20, 5, 7]) is None
    row = (np.arange(1, 7, dtype=np.int32), 0,
           np.arange(1, 33, dtype=np.int32), 6, (0.0, 1.0, 0, 3))
    small = port._prefill_group([row], bucket=8)
    large = port._prefill_group([row], bucket=32)
    assert int(small[0][0]) == int(large[0][0])
    np.testing.assert_allclose(small[1][0].numpy(), large[1][0].numpy(),
                               rtol=1e-5, atol=1e-5)
    ref = JRunner(F32, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                  params=f32_params)
    assert ref.supports_spec is False


PROMPT_LENGTHS = (21, 13, 30, 6)
MAX_TOKENS = 26


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


def test_worker_greedy_streams_equal_the_jax_engine(f32_params, monkeypatch):
    """TorchWorker's scheduler and the JAX engine's, pumped alike, emit the
    same 26 greedy tokens per stream: through fused decode blocks of 8 (the
    unified forward in every step) and past the window of 16. With
    DYNT_SPEC_ENABLE=1 neither scheduler speculates."""
    monkeypatch.setenv("DYNT_SPEC_ENABLE", "1")
    worker = TorchWorker(F32, RunnerConfig(**RUNNER), device="cpu",
                         params=params_from_numpy(f32_params, F32,
                                                  device="cpu"))
    assert worker.scheduler.spec_enabled is False
    got = _serve(worker.scheduler, "port")
    ref = JScheduler(JRunner(F32, JRunnerConfig(**RUNNER),
                             make_mesh(MeshConfig()), params=f32_params))
    assert not ref.spec_enabled
    want = _serve(ref, "ref")
    assert got == want
    assert all(finish == "length" and len(tokens) == MAX_TOKENS
               for tokens, finish in got)
    runner = worker.runner
    assert any(key[0] == "decode_multi" for key in runner.step_graphs)
    assert runner.spec_steps == 0
    assert worker.scheduler.stats.spec_steps == 0
    assert runner.eager_forwards == {"decode": 0, "spec": 0, "prefill": 0}


def test_support_and_quantization_gates():
    """check_supported accepts gpt-oss and MLA and still refuses the
    multimodal splice; gpt-oss refuses int8 / int4 weights (as the
    reference's check_quantizable) and int8 KV (head_dim 64, not 128)."""
    for name in ("tiny-gptoss-test", "gpt-oss-20b", "gpt-oss-120b"):
        check_supported(t_get_config(name))
        for dtype in ("int8", "int4"):
            with pytest.raises(ValueError, match="MLA/MoE/gpt-oss"):
                check_quantizable(t_get_config(name), dtype)
            with pytest.raises(ValueError):
                ref_quantizable(get_config(name), dtype=dtype)
    check_supported(t_get_config("tiny-mla-test"))
    with pytest.raises(NotImplementedError, match="multimodal"):
        check_supported(t_get_config("tiny-mm-test"))
    small = dataclasses.replace(t_get_config("gpt-oss-20b"), vocab_size=64,
                                hidden=64, n_layers=2, n_q_heads=2,
                                n_kv_heads=1, mlp_hidden=32,
                                expert_mlp_hidden=32, n_experts=4)
    with pytest.raises(ValueError, match="int8 KV requires head_dim"):
        ModelRunner(small, RunnerConfig(kv_dtype="int8", num_pages=8,
                                        max_pages_per_seq=4), device="cpu")
    with pytest.raises(ValueError, match="MLA/MoE/gpt-oss"):
        ModelRunner(small, RunnerConfig(weight_dtype="int4", num_pages=8,
                                        max_pages_per_seq=4), device="cpu")
    runner = ModelRunner(small, RunnerConfig(num_pages=8, max_pages_per_seq=4),
                         device="cpu")
    assert tuple(runner.kv_cache.shape) == (2, 2, 8, 16, 1, 64)


# -- MXFP4 and checkpoint directories -----------------------------------------


def test_mxfp4_dequant_bit_equal():
    """Every code and every exponent but 254 against the reference's
    dequantization, bit for bit (0 gives the subnormal 2^-127, 255 inf).
    At 254 the port's scale is the exact 2^127 and the reference's is one
    ulp above it (numpy's float32 exp2 there; ROADMAP Queue 3)."""
    rng = np.random.default_rng(4)
    blocks = rng.integers(0, 256, size=(4, 8, 8, 16), dtype=np.uint8)
    scales = np.concatenate([np.arange(254), [255, 0]]).astype(
        np.uint8).reshape(4, 8, 8)
    with np.errstate(over="ignore", invalid="ignore"):
        want = ref_ckpt.mxfp4_dequant(blocks, scales)
    got = port_ckpt.mxfp4_dequant(torch.from_numpy(blocks),
                                  torch.from_numpy(scales)).numpy()
    assert got.shape == want.shape == (4, 8, 256)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    top = np.full((1, 1), 254, np.uint8)
    ones = np.full((1, 1, 16), 0x22, np.uint8)  # code 2 (1.0) in each nibble
    got = port_ckpt.mxfp4_dequant(torch.from_numpy(ones),
                                  torch.from_numpy(top)).numpy()
    assert (got == np.float32(2.0) ** 127).all()
    assert (ref_ckpt.mxfp4_dequant(ones, top).view(np.uint32)
            == (254 << 23) + 1).all()


def _hf_config(cfg) -> dict:
    return {
        "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden,
        "intermediate_size": cfg.expert_mlp_hidden,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_q_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "num_local_experts": cfg.n_experts,
        "num_experts_per_tok": cfg.n_experts_active,
        "sliding_window": cfg.sliding_window,
        "max_position_embeddings": cfg.max_context,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": False, "attention_bias": True,
        "swiglu_limit": cfg.swiglu_limit,
        "layer_types": ["sliding_attention", "full_attention"]
        * (cfg.n_layers // 2),
        "rope_scaling": {"rope_type": "yarn", "factor": cfg.rope_yarn_factor,
                         "beta_fast": 32.0, "beta_slow": 1.0,
                         "truncate": False,
                         "original_max_position_embeddings":
                         cfg.rope_yarn_orig_max},
        "torch_dtype": cfg.dtype,
    }


def _write_gptoss_dir(path, params, cfg, mxfp4_seed=None) -> dict:
    """An HF gpt-oss directory of `params` under HF's names, written by the
    port's safetensors writer: experts as bf16 [e, in, out] stacks, or with
    `mxfp4_seed` as random MXFP4 blocks and scales [e, out, G, (16)] in
    their place. Returns the MXFP4 experts' dequantized [e, in, out]
    values by tensor name (empty for bf16)."""
    h, qh, kh, hd = cfg.hidden, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    t = {"model.embed_tokens.weight": params["embed"],
         "model.norm.weight": params["final_norm"],
         "lm_head.weight": np.asarray(params["lm_head"]).T}
    rng = np.random.default_rng(mxfp4_seed)
    expect = {}
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        a, m = p + "self_attn.", p + "mlp."
        t.update({
            p + "input_layernorm.weight": lp["attn_norm"],
            p + "post_attention_layernorm.weight": lp["mlp_norm"],
            a + "q_proj.weight": np.asarray(lp["wq"]).reshape(h, -1).T,
            a + "k_proj.weight": np.asarray(lp["wk"]).reshape(h, -1).T,
            a + "v_proj.weight": np.asarray(lp["wv"]).reshape(h, -1).T,
            a + "o_proj.weight": np.asarray(lp["wo"]).reshape(-1, h).T,
            a + "q_proj.bias": np.asarray(lp["bq"]).reshape(qh * hd),
            a + "k_proj.bias": np.asarray(lp["bk"]).reshape(kh * hd),
            a + "v_proj.bias": np.asarray(lp["bv"]).reshape(kh * hd),
            a + "o_proj.bias": lp["bo"], a + "sinks": lp["sinks"],
            m + "router.weight": np.asarray(lp["router"]).T,
            m + "router.bias": lp["router_bias"],
            m + "experts.gate_up_proj_bias": lp["e_gate_up_bias"],
            m + "experts.down_proj_bias": lp["e_down_bias"],
        })
        for proj, leaf in (("gate_up_proj", "e_gate_up"),
                           ("down_proj", "e_down")):
            base = m + "experts." + proj
            if mxfp4_seed is None:
                t[base] = lp[leaf]
                continue
            e, n_in, n_out = np.shape(lp[leaf])
            blocks = rng.integers(0, 256, (e, n_out, n_in // 32, 16),
                                  dtype=np.uint8)
            scales = rng.integers(120, 132, (e, n_out, n_in // 32),
                                  dtype=np.uint8)
            t[base + "_blocks"], t[base + "_scales"] = blocks, scales
            expect[base] = np.swapaxes(ref_ckpt.mxfp4_dequant(blocks, scales),
                                       1, 2)
    path.mkdir(parents=True, exist_ok=True)
    save_file({name: _to_torch(np.ascontiguousarray(v))
               for name, v in t.items()}, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(_hf_config(cfg)))
    return expect


@pytest.mark.parametrize("experts", ["bf16", "mxfp4"])
def test_checkpoint_directories_load_like_the_reference(tmp_path, experts):
    """A gpt-oss directory with bf16 experts, and one with MXFP4 experts:
    the port's loader builds the tree the reference's load_params builds,
    bit for bit, from the port's reader of the same files (U8 blocks and
    scales included); bf16 experts are the written params', MXFP4 ones
    the encoded E2M1 x 2^k values, exact in bf16."""
    params = jax.device_get(j_init(jax.random.PRNGKey(2), TINY))
    ckpt = tmp_path / f"gptoss-{experts}"
    expect = _write_gptoss_dir(ckpt, params, TINY,
                               mxfp4_seed=5 if experts == "mxfp4" else None)
    cfg = port_ckpt.config_from_checkpoint(str(ckpt))
    ref_cfg = ref_ckpt.config_from_checkpoint(str(ckpt))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.replace(cfg, name=TINY.name) == dataclasses.replace(
        t_get_config("tiny-gptoss-test"), rms_eps=cfg.rms_eps)
    got = port_ckpt.load_params(str(ckpt), cfg, device="cpu")
    want = ref_ckpt.load_params(str(ckpt), ref_cfg)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(
            getattr(got, name).view(torch.int16).numpy(),
            np.asarray(want[name]).view(np.int16), name)
    for i, layer in enumerate(got.layers):
        assert sorted(layer.keys()) == sorted(want["layers"][i])
        for name in layer.keys():
            assert layer[name].dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                layer[name].view(torch.int16).numpy(),
                np.asarray(want["layers"][i][name]).view(np.int16), name)
        for proj, leaf in (("gate_up_proj", "e_gate_up"),
                           ("down_proj", "e_down")):
            base = f"model.layers.{i}.mlp.experts.{proj}"
            written = (expect[base] if experts == "mxfp4"
                       else _np32(params["layers"][i][leaf]))
            np.testing.assert_array_equal(layer[leaf].float().numpy(),
                                          written)


def test_checkpoint_shape_errors_and_save_refusal(tmp_path):
    """A mis-shaped MXFP4 scale raises naming the file; save_params refuses
    gpt-oss, as the reference has no gpt-oss config.json writer (its
    hf_config_dict, and the port's, describe a Mixtral)."""
    params = jax.device_get(j_init(jax.random.PRNGKey(2), TINY))
    ckpt = tmp_path / "bad"
    _write_gptoss_dir(ckpt, params, TINY, mxfp4_seed=1)
    with port_ckpt.ShardReader(str(ckpt)) as reader:
        tensors = {n: reader.get(n).clone() for n in reader.names()}
    name = "model.layers.1.mlp.experts.down_proj_scales"
    tensors[name] = tensors[name][:, :-1]
    save_file(tensors, str(ckpt / "model.safetensors"))
    with pytest.raises(ValueError, match=f"{name} has shape"):
        port_ckpt.load_params(str(ckpt), TINY, device="cpu")
    model = params_from_numpy(params, TINY, device="cpu")
    with pytest.raises(NotImplementedError, match="gpt-oss"):
        port_ckpt.save_params(model, TINY, str(tmp_path / "out"))
    assert port_ckpt.hf_config_dict(TINY) == ref_ckpt.hf_config_dict(TINY)
    assert ref_ckpt.hf_config_dict(TINY)["architectures"] == [
        "MixtralForCausalLM"]
    assert not (tmp_path / "out").exists()


def test_worker_serves_a_gptoss_directory_with_harmony(tmp_path):
    """`--model-path` on a gpt-oss directory (MXFP4 experts): the worker
    builds from it, its card names the harmony tool and reasoning parsers,
    and a greedy request serves to its length."""
    params = jax.device_get(j_init(jax.random.PRNGKey(3), TINY))
    ckpt = tmp_path / "gptoss-tiny"
    _write_gptoss_dir(ckpt, params, TINY, mxfp4_seed=2)
    worker = TorchWorker(model_path=str(ckpt), device="cpu",
                         tool_parser="harmony", reasoning_parser="harmony",
                         runner_config=RunnerConfig(**RUNNER))
    assert worker.model_config.is_gptoss
    assert worker.card.name == "gptoss-tiny"
    assert worker.card.tool_parser == "harmony"
    assert worker.card.reasoning_parser == "harmony"
    stream = Stream()
    worker.scheduler.submit(
        PreprocessedRequest(request_id="h", token_ids=list(range(1, 13)),
                            sampling=SamplingOptions(max_tokens=3,
                                                     temperature=0.0),
                            stop=StopConditions(ignore_eos=True)),
        stream.emit)
    _pump(worker.scheduler, lambda: stream.finish is not None)
    assert stream.finish == "length" and len(stream.tokens) == 3
