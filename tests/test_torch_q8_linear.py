"""The port's W8A16 layer (dynamo_tpu_torch.ops.q8_linear) against the JAX
package's (dynamo_tpu.ops.q8_linear).

The CUDA kernel runs only on the card (chip_smoke.py holds it against its
plain version there). Here the quantizer must give the JAX quantizer's bytes
exactly, and the plain matmul, reached through the transformer's `_mm` for
every projection shape it produces, must match JAX's Pallas kernel in
interpret mode and its XLA reference on the same numpy inputs. Tolerance:
1e-5 x max|ref| on f32 inputs (two frameworks' f32 summation orders over
K <= 512 products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import q8_linear as jq8
from dynamo_tpu_torch.models.transformer import _mm
from dynamo_tpu_torch.ops import q8_linear as tq8
from jax_capabilities import requires_pallas_compiler_params

H, QH, KH, HD, MLP, VOCAB = 256, 4, 2, 64, 512, 384
B, T = 2, 3
REL_TOL = 1e-5

# (JAX einsum spec, weight shape, contracted axes, x shape)
PROJECTIONS = {
    "wq": ("bth,hqd->btqd", (H, QH, HD), 1, (B, T, H)),
    "wk": ("bth,hkd->btkd", (H, KH, HD), 1, (B, T, H)),
    "wo": ("btqd,qdh->bth", (QH, HD, H), 2, (B, T, QH, HD)),
    "w_gate": ("bth,hm->btm", (H, MLP), 1, (B, T, H)),
    "w_down": ("btm,mh->bth", (MLP, H), 1, (B, T, MLP)),
    "lm_head": ("bth,hv->btv", (H, VOCAB), 1, (B, T, H)),
}


def _weight(shape, seed):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return w / np.sqrt(shape[0])


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_quantize_weight_bit_identical(name, dtype):
    _, shape, n_contract, _ = PROJECTIONS[name]
    w = _weight(shape, 1)
    w[..., 0] = 0.0  # an all-zero output channel (scale 0, codes 0)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    want = jq8.quantize_weight(jw, n_contract)
    got = tq8.quantize_weight(torch.from_numpy(w).to(getattr(torch, dtype)),
                              n_contract)
    assert got["q8"].dtype == torch.int8 and got["qs"].dtype == torch.float32
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(got["qs"].numpy(), np.asarray(want["qs"]))
    host = tq8.quantize_weight_np(np.asarray(jnp.asarray(jw, jnp.float32)),
                                  n_contract)
    j_host = jq8.quantize_weight_np(np.asarray(jnp.asarray(jw, jnp.float32)),
                                    n_contract)
    np.testing.assert_array_equal(host["q8"], j_host["q8"])
    np.testing.assert_array_equal(host["qs"], j_host["qs"])


@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_mm_matches_jax_einsum(name):
    """`_mm` on a Q8Weight leaf: the q8_einsum reshapes plus the plain
    matmul, against JAX's q8_einsum (its XLA reference on the CPU)."""
    spec, shape, n_contract, x_shape = PROJECTIONS[name]
    leaf = jq8.quantize_weight(jnp.asarray(_weight(shape, 2)), n_contract)
    x = np.random.default_rng(3).normal(size=x_shape).astype(np.float32)
    want = np.asarray(jq8.q8_einsum(spec, jnp.asarray(x), leaf["q8"],
                                    leaf["qs"]))
    w = tq8.Q8Weight(torch.from_numpy(np.array(leaf["q8"])),
                     torch.from_numpy(np.array(leaf["qs"])))
    got = _mm(torch.from_numpy(x), w, k=n_contract).numpy()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= REL_TOL


@requires_pallas_compiler_params
@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_plain_matches_pallas_interpret(name):
    """The plain version on the 2-D product every projection reduces to,
    against the Pallas kernel in interpret mode and the XLA reference."""
    _, shape, n_contract, x_shape = PROJECTIONS[name]
    leaf = jq8.quantize_weight(jnp.asarray(_weight(shape, 4)), n_contract)
    k = int(np.prod(shape[:n_contract]))
    q8 = np.array(leaf["q8"]).reshape(k, -1)
    qs = np.array(leaf["qs"]).reshape(-1)
    x = np.random.default_rng(5).normal(size=(B * T, k)).astype(np.float32)
    kernel = np.asarray(jq8.q8_matmul(jnp.asarray(x), jnp.asarray(q8),
                                      jnp.asarray(qs), interpret=True))
    ref = np.asarray(jq8.q8_matmul_ref(jnp.asarray(x), jnp.asarray(q8),
                                       jnp.asarray(qs)))
    got = tq8.q8_matmul(torch.from_numpy(x), torch.from_numpy(q8),
                        torch.from_numpy(qs)).numpy()
    assert _rel_err(got, kernel) <= REL_TOL
    assert _rel_err(got, ref) <= REL_TOL


def test_bf16_plain_matches_jax_reference():
    """bf16 activations: f32 accumulation, scale, one rounding to bf16 in
    both frameworks (at most one bf16 ulp apart)."""
    leaf = jq8.quantize_weight(jnp.asarray(_weight((H, MLP), 6)), 1)
    x = np.random.default_rng(7).normal(size=(5, H)).astype(np.float32)
    want = np.asarray(jq8.q8_matmul_ref(
        jnp.asarray(x, jnp.bfloat16), leaf["q8"], leaf["qs"]), np.float32)
    got = tq8.q8_matmul_ref(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(np.array(leaf["q8"])),
        torch.from_numpy(np.array(leaf["qs"]))).float().numpy()
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=8e-3)


def test_cpu_tensors_never_count_a_launch():
    tq8.q8_matmul.launches = 0
    leaf = tq8.quantize_weight(torch.from_numpy(_weight((H, H), 8)), 1)
    tq8.q8_matmul(torch.ones((4, H), dtype=torch.bfloat16), leaf["q8"],
                  leaf["qs"])
    assert tq8.q8_matmul.launches == 0


def test_non_cpu_tensors_never_take_the_plain_path():
    x = torch.empty((4, H), dtype=torch.bfloat16, device="meta")
    q8 = torch.empty((H, H), dtype=torch.int8, device="meta")
    qs = torch.empty((H,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tq8.q8_matmul(x, q8, qs)
    with pytest.raises(ValueError, match="CUDA device"):
        tq8.q8_matmul(x, torch.empty((H, H), dtype=torch.int8),
                      torch.empty((H,), dtype=torch.float32))
