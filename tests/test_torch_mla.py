"""MLA in the port (the latent pool, `write_latent_pages`,
`mla_attention_xla`, the forward's MLA branch, the runner's unified decode
and its gates) against the JAX package, on the CPU.

Three configs: tiny-mla-test (dense, tied), TINY_DS (tests/test_deepseek.py's
shape: a dense layer, then MoE layers with shared experts) and V3 (TINY_DS
with a q LoRA rank and sigmoid grouped routing, a random selection bias),
all in float32; the capacity factors leave every pick in its expert, so a
prompt chunked or whole routes alike.

Tolerances: the latent write bit for bit; the attention block and the
latents it writes 1e-5 in f32 and one bf16 ulp of the largest magnitude in
bf16 (the port keeps the reference's casts in its order); the forward as
test_torch_transformer.py holds it (f32: logits 1e-4, the pool 1e-5);
chunked prefill against one shot 1e-5; pool shapes, `kv_layout` and
refusals exactly (the engine's streams: test_torch_mla_engine.py). The JAX side runs as
tests/test_deepseek.py runs it: plain XLA on the CPU (its MLA path reaches no
Pallas kernel).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.models import forward as j_forward
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models import make_kv_cache as j_make_kv
from dynamo_tpu.models import transformer as jt
from dynamo_tpu.models.config import ModelConfig
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig
from dynamo_tpu_torch.models import forward, make_kv_cache, params_from_numpy
from dynamo_tpu_torch.models import get_config as t_get_config
from dynamo_tpu_torch.models import init_params, make_kv_cache_int8
from dynamo_tpu_torch.models import transformer as tt

TINY_DS = ModelConfig(
    name="tiny-ds", vocab_size=256, hidden=64, n_layers=3,
    n_q_heads=4, n_kv_heads=4, head_dim=24, mlp_hidden=96,
    tie_embeddings=False, dtype="float32",
    n_experts=4, n_experts_active=2, expert_mlp_hidden=48,
    first_k_dense=1, n_shared_experts=2, moe_norm_topk=False,
    moe_routed_scale=1.0, moe_capacity_factor=2.0,
    mla_kv_lora_rank=32, mla_rope_head_dim=8, mla_nope_head_dim=16,
    mla_v_head_dim=16,
)
V3 = dataclasses.replace(
    TINY_DS, name="tiny-v3", n_experts=8, n_shared_experts=1,
    moe_norm_topk=True, moe_routed_scale=2.5, moe_scoring="sigmoid",
    moe_n_group=4, moe_topk_group=2, moe_capacity_factor=4.0,
    mla_q_lora_rank=24)
CONFIGS = {
    "tiny-mla-test": dataclasses.replace(get_config("tiny-mla-test"),
                                         dtype="float32"),
    "tiny-ds": TINY_DS,
    "v3": V3,
}
RUNNER = dict(page_size=4, num_pages=128, max_batch=4, max_pages_per_seq=32,
              prefill_buckets=(8, 16, 32))

J_FORWARD = jax.jit(j_forward, static_argnums=1)
J_BLOCK = jax.jit(jt._mla_attention_block, static_argnums=(2, 4))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def _cast(tree, dtype):
    """The f32 params in `dtype` (the selection bias stays f32): what the
    JAX init gives for that dtype, which rounds its f32 draws."""
    def leaf(path, a):
        keep = path[-1].key == "e_bias"
        return a if keep else np.asarray(jnp.asarray(a, dtype))
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _to_torch(x) -> torch.Tensor:
    """A JAX / numpy array as a torch tensor of the same dtype and bits."""
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _np32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(cfg, seed=0) -> dict:
    """The JAX package's params, with a random selection bias on sigmoid
    routing (its init leaves it zero)."""
    params = jax.device_get(j_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 7)
    for lp in params["layers"]:
        if "e_bias" in lp:
            lp["e_bias"] = (rng.normal(size=lp["e_bias"].shape)
                            * 0.1).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def params():
    return {name: _params(cfg) for name, cfg in CONFIGS.items()}


# -- the latent pool -----------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny-mla-test", "deepseek-v2-lite",
                                  "deepseek-v3"])
def test_pool_geometry_equals_the_reference(name):
    """[L, 1, P, ps, 1, dc + rhd] as the reference's make_kv_cache; int8 is
    refused by both packages."""
    cfg = t_get_config(name)
    pool = make_kv_cache(cfg, 3, 16, device="cpu")
    want = jax.eval_shape(lambda: j_make_kv(get_config(name), 3, 16))
    assert tuple(pool.shape) == want.shape == (
        cfg.n_layers, 1, 3, 16, 1,
        cfg.mla_kv_lora_rank + cfg.mla_rope_head_dim)
    assert pool.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    with pytest.raises(ValueError, match="int8 KV targets standard"):
        make_kv_cache_int8(cfg, 3, 16, device="cpu")
    with pytest.raises(AssertionError, match="int8 KV targets standard"):
        jt.make_kv_cache_int8(get_config(name), 3, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_latent_pages_bit_equal(dtype):
    """Two rows over their own pages, one padded: every latent row lands
    where the reference puts it, padding on scratch page 0 (not compared:
    both packages leave it to whichever padding row writes last)."""
    cfg = dataclasses.replace(TINY_DS, dtype=dtype)
    rng = np.random.default_rng(3)
    b, t, ps, pages = 2, 13, 4, 12
    width = cfg.kv_cache_head_dim
    pool = rng.normal(size=(cfg.n_layers, 1, pages, ps, 1, width))
    latent = rng.normal(size=(b, t, width))
    pool_j = jnp.asarray(pool, jnp.dtype(dtype))
    latent_j = jnp.asarray(latent, jnp.dtype(dtype))
    tables = np.asarray([[3, 1, 7, 2, 0], [5, 9, 11, 0, 0]], np.int32)
    positions = np.stack([np.arange(t), 2 + np.arange(t)]).astype(np.int32)
    valid = np.ones((b, t), bool)
    valid[1, 8:] = False
    want = jt.write_latent_pages(pool_j, 1, latent_j, jnp.asarray(tables),
                                 jnp.asarray(positions), jnp.asarray(valid))
    got = _to_torch(pool_j).clone()
    out = tt.write_latent_pages(got, 1, _to_torch(latent_j),
                                torch.from_numpy(tables),
                                torch.from_numpy(positions).long(),
                                torch.from_numpy(valid))
    assert out is got  # in place
    want = np.asarray(want)
    bits = np.int16 if dtype == "bfloat16" else np.int32
    mine = got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
    np.testing.assert_array_equal(mine.numpy()[:, :, 1:],
                                  want.view(bits)[:, :, 1:])


@pytest.mark.parametrize("name", ["tiny-ds", "v3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_matches_jax(params, name, dtype):
    """`mla_attention_xla` against `_mla_attention_block` on one layer: a
    17-token chunk after 6 cached tokens over a random pool, one row
    padded; the written pool too."""
    cfg = dataclasses.replace(CONFIGS[name], dtype=dtype)
    jdt = jnp.dtype(dtype)
    tree = params[name] if dtype == "float32" else _cast(params[name], jdt)
    lp = tree["layers"][1]
    layer = params_from_numpy(tree, cfg, device="cpu").layers[1]
    rng = np.random.default_rng(5)
    b, t, ps, max_pages, pages = 2, 17, 4, 7, 20
    pool = jnp.asarray(rng.normal(size=(cfg.n_layers, 1, pages, ps, 1,
                                        cfg.kv_cache_head_dim)), jdt)
    x = jnp.asarray(rng.normal(size=(b, t, cfg.hidden)), jdt)
    tables = (np.arange(b * max_pages).reshape(b, max_pages) % 19
              + 1).astype(np.int32)
    positions = (6 + np.arange(t))[None].repeat(b, 0).astype(np.int32)
    valid = np.ones((b, t), bool)
    valid[1, 11:] = False
    lens = np.asarray([6 + t, 6 + 11], np.int32)
    want_kv, want = J_BLOCK(x, lp, cfg, pool, 1, jnp.asarray(tables),
                          jnp.asarray(positions), jnp.asarray(lens),
                          jnp.asarray(valid))
    kv = _to_torch(pool).clone()
    got = tt.mla_attention_xla(
        _to_torch(x), layer, cfg, kv, 1, torch.from_numpy(tables),
        torch.from_numpy(positions).long(), torch.from_numpy(lens),
        torch.from_numpy(valid))
    assert got.dtype == _to_torch(want).dtype
    want, want_kv = _np32(want)[valid], _np32(want_kv)[:, :, 1:]
    for mine, theirs in ((got.float().numpy()[valid], want),
                         (kv.float().numpy()[:, :, 1:], want_kv)):
        tol = (1e-5 if dtype == "float32"
               else _bf16_ulp(float(np.abs(theirs).max())))
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=tol)


# -- the forward ---------------------------------------------------------------


def _j_run(params, cfg, kv, tokens, positions, tables, lens, valid):
    kv, logits = J_FORWARD(params, cfg, jnp.asarray(tokens),
                           jnp.asarray(positions), kv, jnp.asarray(tables),
                           jnp.asarray(lens), valid=jnp.asarray(valid))
    return kv, np.asarray(logits)


def _t_run(model, kv, tokens, positions, tables, lens, valid, **kw):
    return forward(model, torch.from_numpy(tokens).long(),
                   torch.from_numpy(positions).long(), kv,
                   torch.from_numpy(tables), torch.from_numpy(lens),
                   valid=torch.from_numpy(valid), **kw).numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_unified_decode_match_jax(params, name):
    """A 20-token prefill of three rows (one padded) into a paged latent
    pool, then two unified decode steps with one slot inactive, as the
    reference's runner decodes MLA; f32, the JAX forward jitted."""
    cfg, logit_tol, pool_tol = CONFIGS[name], 1e-4, 1e-5
    model = params_from_numpy(params[name], cfg, device="cpu")
    rng = np.random.default_rng(0)
    b, t, ps, pages, max_pages = 3, 20, 4, 40, 10
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    tables = (np.arange(b * max_pages).reshape(b, max_pages) + 1).astype(
        np.int32)
    valid = np.ones((b, t), bool)
    valid[2, 13:] = False
    lens = np.asarray([t, t, 13], np.int32)
    j_kv, j_logits = _j_run(params[name], cfg, j_make_kv(cfg, pages, ps),
                            tokens, positions, tables, lens, valid)
    kv = make_kv_cache(cfg, pages, ps, device="cpu")
    logits = _t_run(model, kv, tokens, positions, tables, lens, valid)
    np.testing.assert_allclose(logits[valid], j_logits[valid],
                               rtol=logit_tol, atol=logit_tol)
    np.testing.assert_allclose(kv.numpy()[:, :, 1:], _np32(j_kv)[:, :, 1:],
                               rtol=pool_tol, atol=pool_tol)
    active = np.asarray([True, False, True])
    pos = lens.copy()
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        j_kv, j_dec = _j_run(params[name], cfg, j_kv, tok, pos[:, None],
                             tables, pos + 1, active[:, None])
        dec = _t_run(model, kv, tok, pos[:, None], tables, pos + 1,
                     active[:, None])
        np.testing.assert_allclose(dec[active], j_dec[active],
                                   rtol=logit_tol, atol=logit_tol)
        np.testing.assert_allclose(kv.numpy()[:, :, 1:],
                                   _np32(j_kv)[:, :, 1:], rtol=pool_tol,
                                   atol=pool_tol)
        pos = pos + active


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chunked_prefill_equals_one_shot(params, name):
    """A 24-token prompt as three 8-token chunks and as one chunk: the
    last chunk's logits and the whole pool agree within 1e-5."""
    cfg = CONFIGS[name]
    model = params_from_numpy(params[name], cfg, device="cpu")
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32)
    tables = np.arange(1, 9, dtype=np.int32)[None]
    one_kv = make_kv_cache(cfg, 10, 4, device="cpu")
    one = _t_run(model, one_kv, tokens, np.arange(24)[None], tables,
                 np.asarray([24], np.int32), np.ones((1, 24), bool))
    kv = make_kv_cache(cfg, 10, 4, device="cpu")
    for start in (0, 8, 16):
        part = _t_run(model, kv, tokens[:, start:start + 8],
                      np.arange(start, start + 8)[None], tables,
                      np.asarray([start + 8], np.int32),
                      np.ones((1, 8), bool))
    np.testing.assert_allclose(part, one[:, 16:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kv.numpy(), one_kv.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_attention_fn_is_ignored_and_deferred_paths_refuse(params):
    """The MLA branch never calls `attention_fn`, as the reference's; the
    deferred-write forward_decode / forward_spec raise, as the reference's
    asserts."""
    cfg = CONFIGS["tiny-ds"]
    model = params_from_numpy(params["tiny-ds"], cfg, device="cpu")

    def refuse(*args):
        raise AssertionError("attention_fn was called")

    args = (np.arange(1, 7, dtype=np.int32)[None], np.arange(6)[None],
            np.arange(1, 4, dtype=np.int32)[None], np.asarray([6], np.int32),
            np.ones((1, 6), bool))
    plain = _t_run(model, make_kv_cache(cfg, 4, 4, device="cpu"), *args)
    given = _t_run(model, make_kv_cache(cfg, 4, 4, device="cpu"), *args,
                   attention_fn=refuse)
    np.testing.assert_array_equal(given, plain)
    kv = make_kv_cache(cfg, 4, 4, device="cpu")
    one = torch.zeros(1, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="MLA decodes through"):
        tt.forward_decode(model, one, one, kv, torch.ones((1, 3), dtype=torch.int32),
                          one.int() + 1, one.bool())
    with pytest.raises(NotImplementedError, match="MLA decodes through"):
        tt.forward_spec(model, one[None], one[None], kv,
                        torch.ones((1, 3), dtype=torch.int32), one.int() + 1,
                        one.bool())


@pytest.mark.parametrize("name", ["tiny-ds", "v3"])
def test_params_and_init_carry_the_mla_leaves(params, name):
    """params_from_numpy carries every MLA leaf bit for bit (bf16, the V2
    and the V3 shape), the dense MLP leaves of MoE layers left behind; the
    port's init_params builds the same leaves at the same shapes and
    dtypes."""
    cfg = dataclasses.replace(CONFIGS[name], dtype="bfloat16")
    params = _cast(params[name], jnp.bfloat16)
    model = params_from_numpy(params, cfg, device="cpu")
    built = init_params(cfg, device="cpu")
    attn = ({"w_dq", "q_a_norm", "w_uq"} if cfg.mla_q_lora_rank
            else {"wq"}) | {"w_dkv", "w_kr", "kv_norm", "w_uk", "w_uv", "wo"}
    for i, lp in enumerate(params["layers"]):
        keys = sorted(model.layers[i].keys())
        assert keys == sorted(k for k in lp if "router" not in lp
                              or k not in ("w_gate", "w_up", "w_down"))
        assert keys == sorted(built.layers[i].keys())
        assert attn <= set(keys) and not {"wk", "wv"} & set(keys)
        assert ("router" in keys) == cfg.layer_is_moe(i)
        assert ("w_gate" in keys) == (not cfg.layer_is_moe(i))
        for leaf in keys:
            got, want = model.layers[i][leaf], np.asarray(lp[leaf])
            if want.dtype == np.float32:  # e_bias
                np.testing.assert_array_equal(got.numpy(), want, leaf)
            else:
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(), want.view(np.int16), leaf)
            assert built.layers[i][leaf].shape == got.shape, leaf
            assert built.layers[i][leaf].dtype == got.dtype, leaf


# -- the runner -----------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_runner_gates_and_layout_equal_the_reference(params, name):
    """The runner holds no decode or spec attention function, never
    speculates, keeps the MoE padding of a DeepSeek stack, describes its
    latent pool as the reference's runner does, and refuses int8 KV with
    the reference's message."""
    cfg = CONFIGS[name]
    port = ModelRunner(cfg, RunnerConfig(**RUNNER), device="cpu",
                       params=params_from_numpy(params[name], cfg,
                                                device="cpu"))
    ref = JRunner(cfg, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                  params=params[name])
    assert port.decode_attention_fn is None
    assert port.spec_attention_fn is None
    assert port.supports_spec is ref.supports_spec is False
    assert port.work_bucket([20, 5]) == (32 if cfg.n_experts else None)
    assert port.kv_layout() == ref.kv_layout()
    assert tuple(port.kv_cache.shape) == (cfg.n_layers, 1, RUNNER["num_pages"],
                                          4, 1, cfg.kv_cache_head_dim)
    small = dict(RUNNER, num_pages=8, kv_dtype="int8")
    with pytest.raises(ValueError) as theirs:
        JRunner(cfg, JRunnerConfig(**small), make_mesh(MeshConfig()),
                params=params[name])
    with pytest.raises(ValueError) as mine:
        ModelRunner(cfg, RunnerConfig(**small), device="cpu")
    assert str(mine.value) == str(theirs.value)
    assert "int8 KV targets standard-attention models" in str(mine.value)
