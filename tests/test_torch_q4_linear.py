"""The port's W4A16 layer (dynamo_tpu_torch.ops.q4_linear) against the JAX
package's (dynamo_tpu.ops.q4_linear).

The CUDA kernel's two entry points run only on the card (chip_smoke.py holds
them against the plain version there). Here: the quantizer gives the JAX
quantizer's code bytes and scale/zero rows exactly, for both pack layouts;
the numpy repack round-trips bit-exactly and matches JAX's; the knob
policies (`DYNT_Q4_GROUP`, `DYNT_Q4_VARIANT`) agree; the plain matmul
matches JAX's Pallas kernels in interpret mode and its XLA reference.
Tolerance: 1e-5 x max|ref| on f32 inputs (f32 summation orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import q4_linear as jq4
from dynamo_tpu_torch.models.transformer import _mm
from dynamo_tpu_torch.ops import q4_linear as tq4
from jax_capabilities import requires_pallas_compiler_params

REL_TOL = 1e-5


def _weight(shape, seed, edge_groups=False):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    w /= np.sqrt(shape[0])
    if edge_groups:
        flat = w.reshape(-1, w.shape[-1])
        flat[:, 0] = 0.25  # a constant group: raw scale 0, clamped
        flat[:, 1] = np.abs(flat[:, 1]) + 3.0  # one-sided: zero point < 0
    return w


def _np(t):
    return np.array(t)


def _torch_leaf(leaf):
    return tq4.Q4Weight(*(torch.from_numpy(_np(leaf[k]))
                          for k in ("q4", "qs4", "qz4")))


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# (weight shape, contracted axes): every projection layout, incl. wo's two
# contracted axes (flattened to [K // 2, N] by the quantizer)
LEAVES = {
    "wq": ((512, 4, 64), 1),
    "wo": ((4, 128, 256), 2),
    "w_gate": ((512, 256), 1),
    "w_down": ((1024, 256), 1),
    "small_k": ((96, 128), 1),  # K=96: group 32, v1 only under auto
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", [tq4.PACK_V1, tq4.PACK_V2])
@pytest.mark.parametrize("name", list(LEAVES))
def test_quantize_bit_identical(name, version, dtype):
    shape, n_contract = LEAVES[name]
    k = int(np.prod(shape[:n_contract]))
    w = _weight(shape, 1, edge_groups=True)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    if version == tq4.PACK_V2 and k % (2 * tq4._group_for(k)):
        with pytest.raises(ValueError):
            jq4.quantize_weight_q4(jw, n_contract, version=version)
        with pytest.raises(ValueError):
            tq4.quantize_weight_q4(tw, n_contract, version=version)
        return
    want = jq4.quantize_weight_q4(jw, n_contract, version=version)
    got = tq4.quantize_weight_q4(tw, n_contract, version=version)
    assert got["q4"].dtype == (torch.int8 if version == tq4.PACK_V2
                               else torch.uint8)
    assert tuple(got["q4"].shape) == want["q4"].shape
    np.testing.assert_array_equal(got["q4"].numpy(), _np(want["q4"]))
    np.testing.assert_array_equal(got["qs4"].numpy(), _np(want["qs4"]))
    np.testing.assert_array_equal(got["qz4"].numpy(), _np(want["qz4"]))
    np.testing.assert_array_equal(
        tq4.dequantize_q4(got["q4"], got["qs4"], got["qz4"]).numpy(),
        _np(jq4.dequantize_q4(want["q4"], want["qs4"], want["qz4"])))


@pytest.mark.parametrize("name", ["wq", "wo", "w_gate", "w_down"])
def test_repack_round_trip_matches_jax(name):
    shape, n_contract = LEAVES[name]
    v1 = jq4.quantize_weight_q4(jnp.asarray(_weight(shape, 2)), n_contract,
                                version=jq4.PACK_V1)
    v1_np = {k: _np(v) for k, v in v1.items()}
    j_v2 = jq4.repack_q4_leaf(v1_np, jq4.PACK_V2)
    t_leaf = {k: torch.from_numpy(v.copy()) for k, v in v1_np.items()}
    t_v2 = tq4.repack_q4_leaf(t_leaf, tq4.PACK_V2)
    assert t_v2["q4"].dtype == torch.int8
    np.testing.assert_array_equal(t_v2["q4"].numpy(), j_v2["q4"])
    assert t_v2["qs4"] is t_leaf["qs4"] and t_v2["qz4"] is t_leaf["qz4"]
    back = tq4.repack_q4_leaf(t_v2, tq4.PACK_V1)
    np.testing.assert_array_equal(back["q4"].numpy(), v1_np["q4"])
    assert tq4.repack_q4_leaf(back, tq4.PACK_V1) is back  # no-op: same dict


@pytest.mark.parametrize("group", [None, "128", "64"])
@pytest.mark.parametrize("variant", [None, "auto", "v1", "v2", "v3"])
def test_knob_policies_agree_with_jax(monkeypatch, group, variant):
    for name, value in (("DYNT_Q4_GROUP", group),
                        ("DYNT_Q4_VARIANT", variant)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)

    def outcome(fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except ValueError as exc:
            return ("raises", type(exc))

    for k in (6, 64, 96, 256, 512, 1024, 4096, 14336):
        assert outcome(tq4._group_for, k) == outcome(jq4._group_for, k)
        for strict in (True, False):
            assert (outcome(tq4.resolve_pack_version, k, strict=strict)
                    == outcome(jq4.resolve_pack_version, k, strict=strict))
    if variant == "v3":
        with pytest.raises(ValueError, match="unknown DYNT_Q4_VARIANT"):
            tq4.resolve_pack_version(512)


@requires_pallas_compiler_params
@pytest.mark.parametrize("version", [tq4.PACK_V1, tq4.PACK_V2])
def test_plain_matches_pallas_interpret(version):
    m, k, n = 4, 512, 256
    leaf = jq4.quantize_weight_q4(jnp.asarray(_weight((k, n), 3, True)), 1,
                                  version=version)
    x = np.random.default_rng(4).normal(size=(m, k)).astype(np.float32)
    args = [jnp.asarray(x), leaf["q4"], leaf["qs4"], leaf["qz4"]]
    kernel = np.asarray(jq4.q4_matmul(*args, interpret=True))
    ref = np.asarray(jq4.q4_matmul_ref(*args))
    t = _torch_leaf(leaf)
    got = tq4.q4_matmul(torch.from_numpy(x), t.q4, t.qs4, t.qz4).numpy()
    assert _rel_err(got, kernel) <= REL_TOL
    assert _rel_err(got, ref) <= REL_TOL


SPECS = {
    "wq": ("bth,hqd->btqd", (2, 3, 512)),
    "wo": ("btqd,qdh->bth", (2, 3, 4, 128)),
    "w_gate": ("bth,hm->btm", (2, 3, 512)),
    "w_down": ("btm,mh->bth", (2, 3, 1024)),
}


@pytest.mark.parametrize("version", [tq4.PACK_V1, tq4.PACK_V2])
@pytest.mark.parametrize("name", list(SPECS))
def test_mm_matches_jax_einsum(name, version):
    """`_mm` on a Q4Weight leaf (the q4_einsum reshapes, incl. the flat
    wo) against JAX's q4_einsum (its XLA reference on the CPU)."""
    spec, x_shape = SPECS[name]
    shape, n_contract = LEAVES[name]
    leaf = jq4.quantize_weight_q4(jnp.asarray(_weight(shape, 5)), n_contract,
                                  version=version)
    x = np.random.default_rng(6).normal(size=x_shape).astype(np.float32)
    want = np.asarray(jq4.q4_einsum(spec, jnp.asarray(x), leaf["q4"],
                                    leaf["qs4"], leaf["qz4"]))
    got = _mm(torch.from_numpy(x), _torch_leaf(leaf), k=n_contract).numpy()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= REL_TOL


def test_dispatch_by_dtype_and_cpu_never_counts_a_launch():
    tq4.q4_matmul_v1.launches = tq4.q4_matmul_v2.launches = 0
    w = torch.from_numpy(_weight((512, 256), 7))
    x = torch.ones((2, 512), dtype=torch.bfloat16)
    for version in (tq4.PACK_V1, tq4.PACK_V2):
        leaf = tq4.quantize_weight_q4(w, 1, version=version)
        assert tq4.pack_version(leaf["q4"]) == version
        out = tq4.q4_matmul(x, leaf["q4"], leaf["qs4"], leaf["qz4"])
        assert out.dtype == torch.bfloat16 and out.shape == (2, 256)
    assert tq4.q4_matmul_v1.launches == tq4.q4_matmul_v2.launches == 0


@pytest.mark.parametrize("packed", [torch.uint8, torch.int8])
def test_non_cpu_tensors_never_take_the_plain_path(packed):
    x = torch.empty((4, 512), dtype=torch.bfloat16, device="meta")
    q4 = torch.empty((256, 256), dtype=packed, device="meta")
    s = torch.empty((2, 256), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tq4.q4_matmul(x, q4, s, s)
