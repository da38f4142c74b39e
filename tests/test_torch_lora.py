"""Multi-LoRA in the port (`llm/lora.py`: the adapter file and the slot
manager; the forwards' per-row deltas) against the JAX package, on the CPU.
The engine and the serving edge: tests/test_torch_lora_engine.py.

The same adapter files cross: one `.npz` written by the port's
`save_lora_npz` loads bit for bit in both packages. Forwards get the same
numpy weights (`params_from_numpy`) and the same slot factors, a batch
mixing slot 0 (the base model) and two adapters.

Tolerances: arrays read from a file and the managers' refusals exactly;
a delta (`_lora_delta`) bit for bit in bf16; logits in float32 1e-4 as
tests/test_torch_transformer.py holds them; in bfloat16 0.125 absolute at
|logit| < 4 (8 bf16 ulps: the base rows stay within that file's 0.08, but an
adapter row adds bf16 roundings on top of the base forward's, and the port's
`F.silu` rounds otherwise than `jax.nn.silu` on the changed gate values); a
W4A16 base 1e-3 x max |logit| (tests/test_torch_quantized_engine.py's
bound); slot 0 against no pack exactly. The JAX side runs plain XLA on the
CPU (its LoRA deltas are einsums; the W4A16 leaf goes through its
`q4_einsum`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.llm import lora as ref_lora
from dynamo_tpu.models import forward as j_forward
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models import make_kv_cache as j_make_kv
from dynamo_tpu.models import transformer as jt
from dynamo_tpu_torch.llm import lora
from dynamo_tpu_torch.models import (
    forward,
    forward_decode,
    forward_spec,
    make_kv_cache,
    params_from_numpy,
)
from dynamo_tpu_torch.models import quantize as tquant
from dynamo_tpu_torch.models import transformer as tt
from dynamo_tpu_torch.ops import Q4Weight

RANK = 8
_TINY = get_config("tiny-test")
# (config, the adapters' targets, logits tolerance (absolute, or relative
# to max |logit| for W4A16), whether the deferred-write decode runs)
CONFIGS = {
    "dense-bf16": (_TINY, tt.LORA_TARGETS, 0.125, True),
    # tests/test_torch_quantized_engine.py's int4-able shape of tiny-test
    "dense-w4a16": (dataclasses.replace(
        _TINY, dtype="float32", hidden=512, mlp_hidden=1024, n_layers=1,
        vocab_size=512, n_q_heads=4, n_kv_heads=2, head_dim=128,
        tie_embeddings=False), tt.LORA_TARGETS, 1e-3, True),
    "moe-f32": (dataclasses.replace(get_config("tiny-moe-test"),
                                    dtype="float32"),
                ("wq", "wk", "wv", "wo"), 1e-4, True),
    "mla-f32": (dataclasses.replace(get_config("tiny-mla-test"),
                                    dtype="float32"), ("wq", "wo"), 1e-4,
                False),
    # two layers: one sliding, one full
    "gptoss-f32": (dataclasses.replace(get_config("tiny-gptoss-test"),
                                       dtype="float32", n_layers=2), ("wo",),
                   1e-4, False),
}
B, T, PS, PAGES, MAX_PAGES = 3, 11, 4, 32, 8
SLOTS = np.asarray([0, 1, 2], np.int32)  # base, adapter A, adapter B


def _factors(cfg, targets, rank, seed, scale=1.0) -> dict:
    """Seeded per-layer factors at the port's dims: a ~ N(0, 1/din), b ~
    N(0, scale^2 / r), unscaled (the file's alpha scales b)."""
    dims = tt.lora_target_dims(cfg)
    rng = np.random.default_rng(seed)
    return {i: {t: ((rng.standard_normal((dims[t][0], rank))
                     / np.sqrt(dims[t][0])).astype(np.float32),
                    (rng.standard_normal((rank, dims[t][1])) * scale
                     / np.sqrt(rank)).astype(np.float32))
                for t in targets}
            for i in range(cfg.n_layers)}


def _adapter_file(tmp_path, name, cfg, targets, rank, seed, alpha=None,
                  scale=1.0) -> str:
    path = str(tmp_path / f"{name}.npz")
    lora.save_lora_npz(path, _factors(cfg, targets, rank, seed, scale), rank,
                       float(alpha if alpha is not None else rank))
    return path


def _managers(cfg, paths, max_loras=2, rank=RANK):
    """Both packages' managers with the same files loaded in order."""
    port = lora.LoraManager(cfg, max_loras, rank)
    ref = ref_lora.LoraManager(cfg, max_loras, rank)
    for i, path in enumerate(paths):
        port.load(f"a{i}", path)
        ref.load(f"a{i}", path)
    return port, ref


def _port_pack(cfg, adapters, max_loras=2):
    """A port slot pack written as `ModelRunner.set_lora_slot` writes it."""
    pack = tt.init_lora_pack(cfg, max_loras, RANK, device="cpu")
    dtype = tt.torch_dtype(cfg.dtype)
    for ad in adapters:
        for i, layer in enumerate(pack):
            for t, entry in layer.items():
                a, b = ad.layers.get(i, {}).get(t, (None, None))
                if a is not None:
                    entry["a"][ad.slot] = torch.from_numpy(a).to(dtype)
                    entry["b"][ad.slot] = torch.from_numpy(b).to(dtype)
    return pack


def _jax_pack(cfg, adapters, max_loras=2):
    """The reference's pack written as its runner's set_lora_slot does."""
    pack = jt.init_lora_pack(cfg, max_loras, RANK)
    dtype = jnp.dtype(cfg.dtype)
    for ad in adapters:
        for i, layer in enumerate(pack["layers"]):
            for t, entry in layer.items():
                a, b = ad.layers.get(i, {}).get(t, (None, None))
                if a is not None:
                    layer[t] = {"a": entry["a"].at[ad.slot].set(
                                    jnp.asarray(a, dtype)),
                                "b": entry["b"].at[ad.slot].set(
                                    jnp.asarray(b, dtype))}
    return pack


def _to_torch(x) -> torch.Tensor:
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _np32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, rel):
    got, want = np.asarray(got, np.float32), _np32(want)
    bound = tol * float(np.abs(want).max()) if rel else tol
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    return bound


# -- the adapter file and the manager ------------------------------------------


def test_npz_round_trip_and_scaling(tmp_path):
    """One file in both packages: the same arrays, b scaled by alpha / rank
    at load, bit for bit; a file the reference wrote reads the same."""
    cfg = _TINY
    raw = _factors(cfg, tt.LORA_TARGETS, 4, seed=1)
    path = str(tmp_path / "a.npz")
    lora.save_lora_npz(path, raw, 4, 6.0)
    ref_path = str(tmp_path / "ref.npz")
    ref_lora.save_lora_npz(ref_path, raw, 4, 6.0)
    for p in (path, ref_path):
        mine = lora.load_lora_npz("a", p)
        ref = ref_lora.load_lora_npz("a", p)
        assert (mine.rank, mine.alpha) == (ref.rank, ref.alpha) == (4, 6.0)
        assert mine.layers.keys() == ref.layers.keys() == raw.keys()
        for i, targets in mine.layers.items():
            assert targets.keys() == ref.layers[i].keys()
            for t, (a, b) in targets.items():
                ra, rb = ref.layers[i][t]
                assert a.dtype == ra.dtype and b.dtype == rb.dtype
                np.testing.assert_array_equal(a, ra)
                np.testing.assert_array_equal(b, rb)
                np.testing.assert_array_equal(a, raw[i][t][0])
                np.testing.assert_array_equal(b, raw[i][t][1] * (6.0 / 4))
    with pytest.raises(ValueError, match="unknown LoRA target"):
        lora.save_lora_npz(path, {0: {"w_dq": raw[0]["wq"]}}, 4, 4.0)


def _refusal(case, cfg, tmp_path):
    """(the manager's call that must fail, its config)."""
    if case == "rank":
        path = _adapter_file(tmp_path, "big", cfg, ("wq",), 16, 1)
        return [("a", path)], cfg
    if case == "target":
        mla = get_config("tiny-mla-test")
        return [("a", _adapter_file(tmp_path, "wk", _TINY, ("wk",), 4, 1))
                ], mla
    if case == "shape":
        wide = dataclasses.replace(_TINY, hidden=96)
        return [("a", _adapter_file(tmp_path, "wide", wide, ("wq",), 4,
                                    1))], cfg
    if case == "layer":
        deep = dataclasses.replace(_TINY, n_layers=3)
        return [("a", _adapter_file(tmp_path, "deep", deep, ("wo",), 4,
                                    1))], cfg
    path = _adapter_file(tmp_path, "ok", cfg, ("wo",), 4, 1)
    if case == "slots":
        return [("a", path), ("b", path), ("c", path)], cfg
    return [("a", path), ("a", path)], cfg  # double load


@pytest.mark.parametrize("case", ["rank", "target", "shape", "layer", "slots",
                                  "double"])
def test_manager_refusals_match_the_reference(case, tmp_path):
    """Each refusal raises the reference's type and message, and leaves the
    manager as it was (a refused load takes no slot)."""
    loads, cfg = _refusal(case, _TINY, tmp_path)
    errors = []
    for mgr in (lora.LoraManager(cfg, 2, RANK),
                ref_lora.LoraManager(cfg, 2, RANK)):
        for name, path in loads[:-1]:
            mgr.load(name, path)
        with pytest.raises((ValueError, RuntimeError)) as info:
            mgr.load(*loads[-1])
        errors.append((type(info.value), str(info.value)))
        assert len(mgr.names()) == len(loads) - 1
    assert errors[0] == errors[1]


def test_gptoss_refuses_attention_targets_the_reference_drops(tmp_path):
    """ROADMAP Queue 3: the reference's gpt-oss accepts wq / wk / wv factors
    its attention block never applies; the port refuses them at load, and
    takes `wo` as the reference applies it."""
    cfg = get_config("tiny-gptoss-test")
    qkv = _adapter_file(tmp_path, "qkv", cfg, ("wo",), 4, 1)
    raw = lora.load_lora_npz("x", qkv).layers
    dims = jt.lora_target_dims(cfg)
    rng = np.random.default_rng(3)
    for layer in raw.values():
        layer["wq"] = (rng.standard_normal((dims["wq"][0], 4), np.float32),
                       rng.standard_normal((4, dims["wq"][1]), np.float32))
    lora.save_lora_npz(qkv, raw, 4, 4.0)
    ref = ref_lora.LoraManager(cfg, 2, RANK)
    assert ref.load("qkv", qkv).slot == 1  # silently carries dead weights
    with pytest.raises(ValueError, match="targets 'wq', unsupported for "
                       "model family 'tiny-gptoss-test'"):
        lora.LoraManager(cfg, 2, RANK).load("qkv", qkv)
    wo = _adapter_file(tmp_path, "wo", cfg, ("wo",), 4, 2)
    assert lora.LoraManager(cfg, 2, RANK).load("wo", wo).slot == 1
    assert sorted(tt.lora_target_dims(cfg)) == ["wo"]
    assert sorted(jt.lora_target_dims(cfg)) == ["wk", "wo", "wq", "wv"]


def test_manager_slots_padding_and_two_phase_unload(tmp_path):
    """Slots, zero-padding and the two-phase unload as the reference's."""
    cfg = _TINY
    low = _adapter_file(tmp_path, "low", cfg, ("wq", "w_up"), 4, 1)
    full = _adapter_file(tmp_path, "full", cfg, ("wo",), RANK, 2)
    port, ref = _managers(cfg, [low, full])
    for mgr in (port, ref):
        assert mgr.list() == [
            {"name": "a0", "slot": 1, "rank": 4, "alpha": 4.0},
            {"name": "a1", "slot": 2, "rank": RANK, "alpha": float(RANK)}]
        pending = mgr.begin_unload("a0")
        assert mgr.slot_of("a0") is None and mgr.names() == ["a1"]
        mgr.abort_unload(pending)
        assert mgr.slot_of("a0") == 1
        mgr.commit_unload(mgr.begin_unload("a0"))
        assert mgr.load("again", full).slot == 1
    a_port = port._by_name["again"]
    for i in range(cfg.n_layers):
        a, b = a_port.layers[i]["wo"]
        assert a.shape == (cfg.n_q_heads * cfg.head_dim, RANK)
    padded = lora.LoraManager(cfg, 1, RANK).load("p", low)
    a, b = padded.layers[0]["wq"]
    assert a.shape[1] == b.shape[0] == RANK
    assert not a[:, 4:].any() and not b[4:].any()


# -- the forwards: a mixed batch against the JAX package -----------------------


def test_delta_is_bit_equal_to_the_reference_in_bf16():
    """`_lora_delta`: each row's factors gathered by its slot, two batched
    products; bf16 in and out, equal to the reference's einsums bit for
    bit."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 11, 64)), jnp.bfloat16)
    a = jnp.asarray(rng.standard_normal((3, 64, 8)) / 8, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((3, 8, 128)), jnp.bfloat16)
    idx = np.asarray([2, 0, 1], np.int32)
    want = jt._lora_delta(x, {"a": a, "b": b}, jnp.asarray(idx))
    got = tt._lora_delta(_to_torch(x), {"a": _to_torch(a), "b": _to_torch(b)},
                         torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 11, 128)
    np.testing.assert_array_equal(got.float().numpy(), _np32(want))


def _tiny_params(name):
    """(JAX params, the port's model) of a config: the W4A16 one quantized
    by the port's quantizer (bit-equal to the JAX package's,
    tests/test_torch_quantized_engine.py) and its leaves handed to JAX."""
    cfg = CONFIGS[name][0]
    params = jax.device_get(j_init(jax.random.PRNGKey(0), cfg))
    model = params_from_numpy(params, cfg, device="cpu")
    if name == "dense-w4a16":
        tquant.quantize_params_int4(model)
        leaf = lambda w: {k: v.numpy() for k, v in w.leaf().items()}  # noqa
        params["lm_head"] = leaf(model.lm_head)
        for lp, layer in zip(params["layers"], model.layers):
            for key in layer.keys():
                if isinstance(layer[key], Q4Weight):
                    lp[key] = leaf(layer[key])
    return params, model


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forwards_with_a_mixed_batch_match_jax(name, tmp_path):
    """forward (and forward_decode / forward_spec where the family has the
    deferred write) with rows on slot 0, adapter A (rank 8) and adapter B
    (rank 4, padded): the port's logits equal the JAX package's within the
    config's tolerance, and each adapter row moves well past it."""
    cfg, targets, tol, deferred = CONFIGS[name]
    rel = name == "dense-w4a16"
    params, model = _tiny_params(name)
    a_path = _adapter_file(tmp_path, "A", cfg, targets, RANK, 1)
    b_path = _adapter_file(tmp_path, "B", cfg, targets, 4, 2, alpha=8.0)
    port, ref = _managers(cfg, [a_path, b_path])
    pack = _port_pack(cfg, port._by_name.values())
    jpack = _jax_pack(cfg, ref._by_name.values())
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    tables = (np.arange(B * MAX_PAGES).reshape(B, MAX_PAGES)
              + 1).astype(np.int32)
    lens = np.full(B, T, np.int32)
    idx = torch.from_numpy(SLOTS).long()

    # bf16 eagerly, as test_torch_transformer.py: a jitted bf16 forward
    # keeps f32 between fused ops
    jit = jax.jit(j_forward, static_argnums=1) if cfg.dtype == "float32" \
        else j_forward
    j_kv, j_logits = jit(params, cfg, jnp.asarray(tokens),
                         jnp.asarray(positions), j_make_kv(cfg, PAGES, PS),
                         jnp.asarray(tables), jnp.asarray(lens), lora=jpack,
                         lora_idx=jnp.asarray(SLOTS))
    kv = make_kv_cache(cfg, PAGES, PS, device="cpu")
    args = (torch.from_numpy(tokens).long(),
            torch.from_numpy(positions).long())
    with torch.inference_mode():
        logits = forward(model, *args, kv, torch.from_numpy(tables),
                         torch.from_numpy(lens), lora=pack, lora_idx=idx)
        base = forward(model, *args, make_kv_cache(cfg, PAGES, PS,
                                                   device="cpu"),
                       torch.from_numpy(tables), torch.from_numpy(lens))
    bound = _close(logits.float().numpy(), j_logits, tol, rel)
    # slot 0 is the base model bit for bit; each adapter moves its row
    assert torch.equal(logits[0], base[0])
    for row in (1, 2):
        assert float((logits[row] - base[row]).abs().max()) > 10 * bound
    if not deferred:
        with pytest.raises(NotImplementedError):
            forward_decode(model, args[0][:, 0], args[1][:, 0], kv,
                           torch.from_numpy(tables), torch.from_numpy(lens),
                           torch.ones(B, dtype=torch.bool), lora=pack,
                           lora_idx=idx)
        return

    # one decode step and one 3-token verification chunk over the pool the
    # JAX prefill wrote
    step_tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    pos = np.full(B, T, np.int32)
    active = np.asarray([True, True, True])
    j_dec = jax.jit(jt.forward_decode, static_argnums=1)(
        params, cfg, jnp.asarray(step_tok), jnp.asarray(pos), j_kv,
        jnp.asarray(tables), jnp.asarray(lens + 1), jnp.asarray(active),
        lora=jpack, lora_idx=jnp.asarray(SLOTS))[1]
    chunk = rng.integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    cpos = (T - 1 + np.arange(3, dtype=np.int32))[None].repeat(B, 0)
    j_spec = jax.jit(jt.forward_spec, static_argnums=1)(
        params, cfg, jnp.asarray(chunk), jnp.asarray(cpos), j_kv,
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(active),
        lora=jpack, lora_idx=jnp.asarray(SLOTS))[1]
    with torch.inference_mode():
        dec = forward_decode(
            model, torch.from_numpy(step_tok).long(),
            torch.from_numpy(pos).long(), _to_torch(j_kv),
            torch.from_numpy(tables), torch.from_numpy(lens + 1),
            torch.from_numpy(active), lora=pack, lora_idx=idx)
        spec = forward_spec(
            model, torch.from_numpy(chunk).long(),
            torch.from_numpy(cpos).long(), _to_torch(j_kv),
            torch.from_numpy(tables), torch.from_numpy(lens),
            torch.from_numpy(active), lora=pack, lora_idx=idx)
    _close(dec.float().numpy(), j_dec, tol, rel)
    _close(spec.float().numpy(), j_spec, tol, rel)
