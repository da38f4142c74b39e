"""The port's transformer (dynamo_tpu_torch.models), dense and MoE, against
the JAX package, with the JAX params carried across by `params_from_numpy`.

Both frameworks run on the CPU here. Tolerances, float32: logits 1e-4; the
pool written by a whole forward 1e-5 (its K/V come out of matmuls and norms
whose f32 summation order differs between XLA's and PyTorch's CPU kernels,
so a few slots differ in the last bits); the write path itself is bit-equal
when both are fed the same K/V. bfloat16: logits 0.08 (4 bf16 ulps at
|logit| ~ 4) and pools 0.02 (one bf16 ulp at |x| < 4), since the two
frameworks round intermediate products to bf16 at different points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import forward as j_forward
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models import make_kv_cache as j_make_kv
from dynamo_tpu.models.transformer import forward_decode as j_forward_decode
from dynamo_tpu.models.transformer import forward_spec as j_forward_spec
from dynamo_tpu.models.transformer import write_kv_pages as j_write_pages
from dynamo_tpu.models.transformer import write_kv_stack as j_write_stack
from dynamo_tpu_torch.models import (
    forward,
    forward_decode,
    forward_spec,
    make_kv_cache,
    params_from_numpy,
)
from dynamo_tpu_torch.models.transformer import write_kv_pages, write_kv_stack
from dynamo_tpu_torch.ops import paged_attention_decode_pool

_TINY = get_config("tiny-test")
_MOE = get_config("tiny-moe-test")
CONFIGS = {
    "f32": (dataclasses.replace(_TINY, dtype="float32"), 1e-4, 1e-5),
    "f32-qknorm-untied": (dataclasses.replace(
        _TINY, dtype="float32", qk_norm=True, tie_embeddings=False),
        1e-4, 1e-5),
    "bf16": (_TINY, 0.08, 0.02),
    # 4 experts, top-2, capacity factor 1.25: at T = 11 a row has 7 slots
    # per expert, so the prefill chunk drops picks
    "moe-f32": (dataclasses.replace(_MOE, dtype="float32"), 1e-4, 1e-5),
    # DeepSeek routing on a mixed stack: layer 0 dense, layer 1 of 8
    # experts with sigmoid scores, 2 of 4 groups, a routed scale and a
    # shared expert
    "moe-f32-deepseek-routing": (dataclasses.replace(
        _MOE, dtype="float32", n_experts=8, first_k_dense=1,
        n_shared_experts=1, moe_scoring="sigmoid", moe_n_group=4,
        moe_topk_group=2, moe_norm_topk=False, moe_routed_scale=2.5),
        1e-4, 1e-5),
    "moe-bf16": (_MOE, 0.08, 0.02),
}

B, T, PS, PAGES, MAX_PAGES = 3, 11, 4, 32, 8


def _pool_np(kv):
    return np.asarray(jnp.asarray(kv, jnp.float32))


def _setup(cfg, seed=0):
    params = jax.device_get(j_init(jax.random.PRNGKey(seed), cfg))
    model = params_from_numpy(params, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    tables = (np.arange(B * MAX_PAGES).reshape(B, MAX_PAGES) + 1).astype(np.int32)
    lens = np.full(B, T, np.int32)
    return params, model, rng, tokens, positions, tables, lens


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_decode_match_jax(name):
    cfg, logit_tol, pool_tol = CONFIGS[name]
    params, model, rng, tokens, positions, tables, lens = _setup(cfg)

    # prefill: the whole prompt as one chunk
    j_kv = j_make_kv(cfg, PAGES, PS)
    j_kv, j_logits = j_forward(params, cfg, jnp.asarray(tokens),
                               jnp.asarray(positions), j_kv,
                               jnp.asarray(tables), jnp.asarray(lens))
    kv = make_kv_cache(cfg, PAGES, PS, device="cpu")
    logits = forward(model, torch.from_numpy(tokens).long(),
                     torch.from_numpy(positions).long(), kv,
                     torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=logit_tol, atol=logit_tol)
    written = _pool_np(j_kv) != 0
    np.testing.assert_array_equal(kv.float().numpy() != 0, written)
    np.testing.assert_allclose(kv.float().numpy(), _pool_np(j_kv),
                               rtol=pool_tol, atol=pool_tol)

    # one decode step (deferred write) from the JAX-written pool, through
    # the plain attention and through the kernel's decode path
    step_tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    pos = np.full(B, T, np.int32)
    kv_lens = np.full(B, T + 1, np.int32)
    active = np.asarray([True, True, False])
    j_kv2, j_dec = j_forward_decode(
        params, cfg, jnp.asarray(step_tok), jnp.asarray(pos), j_kv,
        jnp.asarray(tables), jnp.asarray(kv_lens), jnp.asarray(active))
    for attn_fn in (None, paged_attention_decode_pool):
        kv = torch.from_numpy(np.array(j_kv).view(np.int16)).view(
            torch.bfloat16) if cfg.dtype == "bfloat16" \
            else torch.from_numpy(np.array(j_kv))
        dec = forward_decode(
            model, torch.from_numpy(step_tok).long(),
            torch.from_numpy(pos).long(), kv, torch.from_numpy(tables),
            torch.from_numpy(kv_lens), torch.from_numpy(active),
            decode_attention_fn=attn_fn)
        np.testing.assert_allclose(dec.numpy(), np.asarray(j_dec),
                                   rtol=logit_tol, atol=logit_tol)
        # the deferred write landed in the active slots' pages only
        np.testing.assert_allclose(kv.float().numpy()[:, :, 1:],
                                   _pool_np(j_kv2)[:, :, 1:],
                                   rtol=pool_tol, atol=pool_tol)
        np.testing.assert_array_equal(kv.float().numpy()[:, :, 1:] != 0,
                                      _pool_np(j_kv2)[:, :, 1:] != 0)

    # one 3-position verification chunk (deferred write) from the same pool
    chunk = rng.integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    cpos = (T - 1 + np.arange(3, dtype=np.int32))[None].repeat(B, 0)
    lens_c = np.full(B, T, np.int32)  # committed incl. chunk token 0
    _, j_spec = j_forward_spec(
        params, cfg, jnp.asarray(chunk), jnp.asarray(cpos), j_kv,
        jnp.asarray(tables), jnp.asarray(lens_c), jnp.asarray(active))
    kv = torch.from_numpy(np.array(j_kv).view(np.int16)).view(
        torch.bfloat16) if cfg.dtype == "bfloat16" \
        else torch.from_numpy(np.array(j_kv))
    spec = forward_spec(model, torch.from_numpy(chunk).long(),
                        torch.from_numpy(cpos).long(), kv,
                        torch.from_numpy(tables), torch.from_numpy(lens_c),
                        torch.from_numpy(active))
    np.testing.assert_allclose(spec.numpy(), np.asarray(j_spec),
                               rtol=logit_tol, atol=logit_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_paths_bit_equal(dtype):
    """Fed the same K/V, the in-place scatters write exactly the pool the
    JAX scatters build (padding tokens land on scratch page 0)."""
    cfg = dataclasses.replace(_TINY, dtype=dtype)
    rng = np.random.default_rng(3)
    kh, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    tables = (rng.permutation(PAGES - 1)[: B * MAX_PAGES]
              .reshape(B, MAX_PAGES) + 1).astype(np.int32)
    positions = np.stack([np.arange(5, 5 + T)] * B).astype(np.int32)
    valid = np.ones((B, T), bool)
    valid[2, 7:] = False
    k = rng.normal(size=(L, B, T, kh, hd)).astype(np.float32)
    v = rng.normal(size=(L, B, T, kh, hd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    j_kv = j_write_pages(j_make_kv(cfg, PAGES, PS), 1, jnp.asarray(k[0], jdt),
                         jnp.asarray(v[0], jdt), jnp.asarray(tables),
                         jnp.asarray(positions), jnp.asarray(valid))
    kv = write_kv_pages(make_kv_cache(cfg, PAGES, PS, device="cpu"), 1,
                        torch.from_numpy(k[0]).to(tdt),
                        torch.from_numpy(v[0]).to(tdt),
                        torch.from_numpy(tables),
                        torch.from_numpy(positions).long(),
                        torch.from_numpy(valid))
    np.testing.assert_array_equal(kv.float().numpy()[:, :, 1:],
                                  _pool_np(j_kv)[:, :, 1:])

    j_kv = j_write_stack(j_make_kv(cfg, PAGES, PS), jnp.asarray(k, jdt),
                         jnp.asarray(v, jdt), jnp.asarray(tables),
                         jnp.asarray(positions), jnp.asarray(valid))
    kv = write_kv_stack(make_kv_cache(cfg, PAGES, PS, device="cpu"),
                        torch.from_numpy(k).to(tdt),
                        torch.from_numpy(v).to(tdt),
                        torch.from_numpy(tables),
                        torch.from_numpy(positions).long(),
                        torch.from_numpy(valid))
    np.testing.assert_array_equal(kv.float().numpy()[:, :, 1:],
                                  _pool_np(j_kv)[:, :, 1:])


def test_params_carry_over_bit_exact():
    """bf16 leaves cross as their bits; layouts are the JAX ones."""
    cfg = dataclasses.replace(_TINY, tie_embeddings=False)
    params = jax.device_get(j_init(jax.random.PRNGKey(1), cfg))
    model = params_from_numpy(params, cfg, device="cpu")
    assert model.layers[0]["wq"].dtype == torch.bfloat16
    assert tuple(model.layers[0]["wo"].shape) == (
        cfg.n_q_heads, cfg.head_dim, cfg.hidden)
    np.testing.assert_array_equal(
        model.lm_head.float().numpy(),
        np.asarray(jnp.asarray(params["lm_head"], jnp.float32)))
    np.testing.assert_array_equal(
        model.layers[1]["w_down"].float().numpy(),
        np.asarray(jnp.asarray(params["layers"][1]["w_down"], jnp.float32)))


def test_unported_families_raise():
    """The multimodal splice is what is still refused (gpt-oss is held in
    test_torch_gptoss.py, MLA in test_torch_mla.py)."""
    from dynamo_tpu_torch.models import get_config as t_get_config
    from dynamo_tpu_torch.models import init_params

    with pytest.raises(NotImplementedError,
                       match="multimodal embedding splice not ported"):
        init_params(t_get_config("tiny-mm-test"), device="cpu")
