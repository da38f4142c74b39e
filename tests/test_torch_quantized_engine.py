"""The port's quantized model runner against the JAX package's.

A small config that takes the quantized paths the way mistral-7b does on the
card: head_dim 128 (the int8 KV gate) and every contracted size a multiple
of 512, so int4 picks the v2 layout; f32 activations, untied head (so the
lm_head is quantized too), 2 layers. Both runners get the same
JAX-quantized tree (through `params_from_numpy` for the port) and an int8
KV pool, prefill one prompt and decode 16 greedy steps. First-step logits
agree within 1e-3 x max|logit| (f32 summation orders over int8/int4
weights and int8 K/V), and the greedy streams are identical. The port's own
quantizer, run on the raw tree, gives the JAX quantizer's leaves.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models import quantize as jquant
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig
from dynamo_tpu_torch.models import params_from_numpy
from dynamo_tpu_torch.models import quantize as tquant
from dynamo_tpu_torch.ops import Q4Weight, Q8Weight

CFG = dataclasses.replace(
    get_config("tiny-test"), dtype="float32", hidden=512, mlp_hidden=1024,
    n_layers=2, vocab_size=512, n_q_heads=4, n_kv_heads=2, head_dim=128,
    tie_embeddings=False)
RUNNER = dict(page_size=4, num_pages=64, max_batch=2, max_pages_per_seq=16,
              prefill_buckets=(8, 16, 32))
PROMPT_LEN, STEPS = 21, 16
LOGIT_REL_TOL = 1e-3
_JAX_QUANTIZE = {"int8": jquant.quantize_params_int8,
                 "int4": jquant.quantize_params_int4}


@pytest.fixture(scope="module")
def raw():
    return jax.device_get(j_init(jax.random.PRNGKey(0), CFG))


def _quantized(raw, weight_dtype):
    return jax.device_get(_JAX_QUANTIZE[weight_dtype](raw, CFG))


def _drive(runner):
    """Prefill the prompt, then STEPS greedy decode steps; returns (first
    decode step's logits, prefill token + decoded tokens)."""
    prompt = np.random.default_rng(1).integers(1, CFG.vocab_size,
                                               PROMPT_LEN).astype(np.int32)
    table = np.zeros(RUNNER["max_pages_per_seq"], np.int32)
    table[:10] = np.arange(1, 11)
    tok = int(runner.prefill_chunk(prompt, 0, table, PROMPT_LEN,
                                   (0.0, 1.0, 0, 0)))
    tokens, logits = [tok], None
    for s in range(STEPS):
        nxt = runner.decode(
            np.asarray([tok], np.int32), np.asarray([PROMPT_LEN + s], np.int32),
            table[None, :], np.asarray([PROMPT_LEN + s + 1], np.int32),
            np.ones(1, bool), np.zeros(1, np.float32), np.ones(1, np.float32),
            np.zeros(1, np.int32), np.zeros(1, np.uint32),
            np.asarray([s], np.int32), want_logits=s == 0)
        if s == 0:
            logits = np.asarray(runner.last_decode_logits[0])
        tok = int(nxt[0])
        tokens.append(tok)
    return logits, tokens


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_runner_matches_jax(raw, weight_dtype):
    tree = _quantized(raw, weight_dtype)
    jcfg = JRunnerConfig(weight_dtype=weight_dtype, kv_dtype="int8", **RUNNER)
    j_logits, j_tokens = _drive(JRunner(CFG, jcfg, make_mesh(MeshConfig()),
                                        params=tree))
    runner = ModelRunner(
        CFG, RunnerConfig(weight_dtype=weight_dtype, kv_dtype="int8",
                          **RUNNER),
        device="cpu", params=params_from_numpy(tree, CFG, device="cpu"))
    assert isinstance(runner.kv_cache, tuple)
    assert runner.kv_cache[0].dtype == torch.int8
    assert tuple(runner.kv_cache[1].shape) == runner.kv_cache[0].shape[:4]
    logits, tokens = _drive(runner)
    scale = float(np.abs(j_logits).max())
    assert float(np.abs(logits - j_logits).max()) <= LOGIT_REL_TOL * scale
    assert tokens == j_tokens
    assert runner.prefill_steps == 1 and runner.decode_steps == STEPS


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_port_quantizer_gives_jax_leaves(raw, weight_dtype):
    want = _quantized(raw, weight_dtype)
    model = params_from_numpy(raw, CFG, device="cpu")
    if weight_dtype == "int4":
        tquant.quantize_params_int4(model)
    else:
        tquant.quantize_params_int8(model)
    kind = Q4Weight if weight_dtype == "int4" else Q8Weight
    assert tquant.quantized_kind(model) == weight_dtype
    leaves = [(model.layers[i], want["layers"][i]) for i in range(CFG.n_layers)]
    for layer, j_layer in leaves:
        assert sorted(layer.keys()) == sorted(j_layer)
        for name, j_leaf in j_layer.items():
            leaf = layer[name]
            if not isinstance(j_leaf, dict):
                assert isinstance(leaf, torch.nn.Parameter)
                continue
            assert isinstance(leaf, kind)
            for key, value in leaf.leaf().items():
                np.testing.assert_array_equal(value.numpy(), j_leaf[key])
    for key, value in model.lm_head.leaf().items():
        np.testing.assert_array_equal(value.numpy(), want["lm_head"][key])


def test_v1_tree_repacks_at_load(raw, monkeypatch):
    """An int4 tree packed v1 loads as v2 under the auto policy, and pinned
    to v1 (DYNT_Q4_VARIANT=v1) it serves the same greedy stream."""
    monkeypatch.setenv("DYNT_Q4_VARIANT", "v1")
    v1_tree = _quantized(raw, "int4")
    assert v1_tree["layers"][0]["wq"]["q4"].dtype == np.uint8
    cfg = RunnerConfig(weight_dtype="int4", kv_dtype="int8", **RUNNER)
    pinned = ModelRunner(CFG, cfg, device="cpu",
                         params=params_from_numpy(v1_tree, CFG, device="cpu"))
    assert pinned.model.layers[0]["wq"].q4.dtype == torch.uint8
    monkeypatch.delenv("DYNT_Q4_VARIANT")
    repacked = ModelRunner(CFG, cfg, device="cpu",
                           params=params_from_numpy(v1_tree, CFG,
                                                    device="cpu"))
    assert repacked.model.layers[0]["wq"].q4.dtype == torch.int8
    assert repacked.model.lm_head.q4.dtype == torch.int8
    assert _drive(pinned)[1] == _drive(repacked)[1]


def test_runner_refuses_what_the_reference_refuses(raw):
    with pytest.raises(ValueError, match="head_dim == 128"):
        ModelRunner(get_config("tiny-test"), RunnerConfig(kv_dtype="int8"),
                    device="cpu")
    with pytest.raises(ValueError, match="unknown weight_dtype"):
        ModelRunner(CFG, RunnerConfig(weight_dtype="int2"), device="cpu")
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        ModelRunner(CFG, RunnerConfig(kv_dtype="fp8"), device="cpu")
    int8_tree = params_from_numpy(_quantized(raw, "int8"), CFG, device="cpu")
    with pytest.raises(ValueError, match="already quantized"):
        ModelRunner(CFG, RunnerConfig(weight_dtype="int4", **RUNNER),
                    device="cpu", params=int8_tree)
    with pytest.raises(ValueError, match="dense"):
        ModelRunner(get_config("tiny-moe-test"),
                    RunnerConfig(weight_dtype="int8"), device="cpu")
