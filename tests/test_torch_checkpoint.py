"""The port's checkpoint loading (dynamo_tpu_torch.models.checkpoint and
models.safetensors) against the JAX package's models/checkpoint.py.

Checkpoints are written in temporary directories by the reference's
`save_params` (tiny-test with tied embeddings, a qk_norm config and an
untied one) and by the port's. Each package loads what the other wrote,
leaf for leaf bit-equal (the port's leaves against `params_from_numpy` of
the reference's), and the port's float32 logits from a reference-written
checkpoint match the JAX forward's to 1e-5. The safetensors reader and
writer are held against the `safetensors` package for every dtype the
reader implements; `config_from_hf` against the reference's on its
TestHfConfig cases and on MoE, MLA and gpt-oss configs; the worker built
from a checkpoint directory against `TpuWorker`'s card, and its greedy
streams against the JAX engine's on the same directory.
"""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file

from dynamo_tpu.engine import InferenceScheduler as JScheduler
from dynamo_tpu.engine import ModelRunner as JRunner
from dynamo_tpu.engine import RunnerConfig as JRunnerConfig
from dynamo_tpu.engine.worker import TpuWorker
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols import SamplingOptions as JSampling
from dynamo_tpu.llm.protocols import StopConditions as JStop
from dynamo_tpu.models import checkpoint as ref
from dynamo_tpu.models import forward as j_forward
from dynamo_tpu.models import get_config
from dynamo_tpu.models import init_params as j_init
from dynamo_tpu.models import make_kv_cache as j_make_kv
from dynamo_tpu.parallel import MeshConfig, make_mesh
from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
from dynamo_tpu_torch.llm.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import checkpoint as port
from dynamo_tpu_torch.models import forward, make_kv_cache, params_from_numpy
from dynamo_tpu_torch.models import safetensors as st
from dynamo_tpu_torch.models.quantize import quantize_params_int4

_TINY = get_config("tiny-test")
CONFIGS = {
    "tied": _TINY,
    "qk_norm": dataclasses.replace(_TINY, qk_norm=True,
                                   tie_embeddings=False),
    "untied": dataclasses.replace(_TINY, tie_embeddings=False, n_layers=3),
}


def _ref_checkpoint(tmp_path, cfg, seed=0):
    params = jax.device_get(j_init(jax.random.PRNGKey(seed), cfg))
    path = str(tmp_path / "ckpt")
    ref.save_params(params, cfg, path)
    return params, path


def _named(model) -> dict:
    return dict(model.named_parameters())


def _assert_models_equal(a, b):
    pa, pb = _named(a), _named(b)
    assert pa.keys() == pb.keys()
    for name, t in pa.items():
        assert t.dtype == pb[name].dtype, name
        assert torch.equal(t, pb[name]), name


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_checkpoint_loads_bit_for_bit(tmp_path, name):
    cfg = CONFIGS[name]
    _, path = _ref_checkpoint(tmp_path, cfg)
    pcfg = port.config_from_checkpoint(path)
    asdict = dataclasses.asdict
    assert asdict(pcfg) == asdict(ref.config_from_checkpoint(path))
    assert asdict(dataclasses.replace(pcfg, name=cfg.name)) == asdict(cfg)
    got = port.load_params(path, pcfg, device="cpu")
    want = params_from_numpy(ref.load_params(path, cfg), pcfg, device="cpu")
    _assert_models_equal(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_checkpoint_loads_in_the_reference(tmp_path, name):
    cfg = CONFIGS[name]
    params, path = _ref_checkpoint(tmp_path, cfg, seed=1)
    model = port.load_params(path, port.config_from_checkpoint(path),
                             device="cpu")
    out = str(tmp_path / "port")
    port.save_params(model, model.config, out)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == ref.hf_config_dict(cfg)
    back = ref.load_params(out, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path_, leaf in flat_a:
        want = flat_b[path_]
        assert leaf.dtype == want.dtype
        np.testing.assert_array_equal(leaf.view(np.uint16),
                                      want.view(np.uint16))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_jax_forward(tmp_path, name):
    """float32: the port's forward over a reference-written checkpoint
    against the JAX forward over the same file, to 1e-5."""
    cfg = dataclasses.replace(CONFIGS[name], dtype="float32")
    params = jax.device_get(j_init(jax.random.PRNGKey(2), cfg))
    path = str(tmp_path / "ckpt")
    ref.save_params(params, cfg, path)
    pcfg = port.config_from_checkpoint(path, dtype="float32")
    model = port.load_params(path, pcfg, device="cpu")
    j_params = ref.load_params(path, cfg)
    rng = np.random.default_rng(0)
    b, t, ps, pages = 2, 9, 4, 16
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    tables = (np.arange(b * 4).reshape(b, 4) + 1).astype(np.int32)
    lens = np.full(b, t, np.int32)
    _, j_logits = j_forward(j_params, cfg, jnp.asarray(tokens),
                            jnp.asarray(positions), j_make_kv(cfg, pages, ps),
                            jnp.asarray(tables), jnp.asarray(lens))
    logits = forward(model, torch.from_numpy(tokens).long(),
                     torch.from_numpy(positions).long(),
                     make_kv_cache(pcfg, pages, ps, device="cpu"),
                     torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)


def test_sharded_index_loads(tmp_path):
    cfg = CONFIGS["untied"]
    _, path = _ref_checkpoint(tmp_path, cfg)
    model = port.load_params(path, port.config_from_checkpoint(path),
                             device="cpu")
    out = str(tmp_path / "sharded")
    port.save_params(model, model.config, out, max_shard_bytes=40_000)
    with open(os.path.join(out, "model.safetensors.index.json")) as f:
        index = json.load(f)
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) > 3 and not os.path.exists(
        os.path.join(out, "model.safetensors"))
    for shard in shards:
        assert os.path.getsize(os.path.join(out, shard)) < 40_000 + 70_000
    _assert_models_equal(port.load_params(out, model.config, device="cpu"),
                         model)
    # the reference reads the same index
    back = params_from_numpy(ref.load_params(out, cfg), model.config,
                             device="cpu")
    _assert_models_equal(back, model)
    # a directory of shards without its index loads too
    os.remove(os.path.join(out, "model.safetensors.index.json"))
    _assert_models_equal(port.load_params(out, model.config, device="cpu"),
                         model)


def _edited(tmp_path, cfg, edit):
    params = jax.device_get(j_init(jax.random.PRNGKey(0), cfg))
    hf = {e.hf_name: e.to_hf(np.asarray(ref._get_path(params, e.path)))
          for e in ref.build_mapping(cfg)}
    edit(hf)
    path = tmp_path / "edited"
    path.mkdir()
    np_save_file(hf, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(ref.hf_config_dict(cfg)))
    return str(path)


@pytest.mark.parametrize("case", ["missing", "misshaped"])
def test_bad_tensors_raise_the_reference_types(tmp_path, case):
    cfg = CONFIGS["untied"]
    name = "model.layers.1.self_attn.k_proj.weight"

    def edit(hf):
        if case == "missing":
            del hf[name]
        else:
            hf[name] = hf[name][:-1]

    path = _edited(tmp_path, cfg, edit)
    exc = KeyError if case == "missing" else ValueError
    with pytest.raises(exc):
        ref.load_params(path, cfg)
    with pytest.raises(exc, match="k_proj") as info:
        port.load_params(path, port.config_from_checkpoint(path),
                         device="cpu")
    if case == "misshaped":
        assert "model.safetensors" in str(info.value)
    else:
        assert path in str(info.value)


def test_misshaped_norm_raises_where_the_reference_loads(tmp_path):
    """The port checks the shape of every tensor; the reference copies the
    embedding and the norms unchecked, so a mis-shaped norm loads there."""
    cfg = CONFIGS["untied"]
    name = "model.layers.0.input_layernorm.weight"
    path = _edited(tmp_path, cfg, lambda hf: hf.update({name: hf[name][:-1]}))
    ref.load_params(path, cfg)
    with pytest.raises(ValueError, match="input_layernorm"):
        port.load_params(path, port.config_from_checkpoint(path),
                         device="cpu")


def test_missing_head_falls_back_to_the_embedding(tmp_path, caplog):
    cfg = CONFIGS["untied"]
    path = _edited(tmp_path, cfg, lambda hf: hf.pop("lm_head.weight"))
    got = port.load_params(path, port.config_from_checkpoint(path),
                           device="cpu")
    want = params_from_numpy(ref.load_params(path, cfg), got.config,
                             device="cpu")
    _assert_models_equal(got, want)
    assert torch.equal(got.lm_head, got.embed.t())

    # and an extra tensor is reported, not loaded
    path2 = tmp_path / "extra"
    path2.mkdir()
    extra = _edited(path2, cfg, lambda hf: hf.update(
        {"model.layers.0.mlp.extra.weight": np.zeros(3, np.float32)}))
    with caplog.at_level("WARNING"):
        port.load_params(extra, port.config_from_checkpoint(extra),
                         device="cpu")
    assert "unused tensors" in caplog.text


def test_bad_files_raise_naming_the_file(tmp_path):
    _, path = _ref_checkpoint(tmp_path, _TINY)
    cfg = port.config_from_checkpoint(path)
    shard = os.path.join(path, "model.safetensors")
    data = open(shard, "rb").read()
    with open(shard, "wb") as f:
        f.write(data[: len(data) // 2])  # truncated
    with pytest.raises(st.SafetensorsError, match="model.safetensors"):
        port.load_params(path, cfg, device="cpu")
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="config.json"):
        port.config_from_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        port.config_from_checkpoint(str(tmp_path / "nowhere"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        port.ShardReader(str(empty))


# -- the safetensors format against the safetensors package --------------------------

DTYPES = {"BF16": (torch.bfloat16, None), "F16": (torch.float16, np.float16),
          "F32": (torch.float32, np.float32),
          "F64": (torch.float64, np.float64), "I8": (torch.int8, np.int8),
          "U8": (torch.uint8, np.uint8), "I16": (torch.int16, np.int16),
          "I32": (torch.int32, np.int32), "I64": (torch.int64, np.int64),
          "BOOL": (torch.bool, np.bool_)}


def _sample(np_dtype, shape, rng):
    if np_dtype is np.bool_:
        return rng.integers(0, 2, shape).astype(bool)
    if np.issubdtype(np_dtype, np.floating):
        return rng.normal(size=shape).astype(np_dtype)
    info = np.iinfo(np_dtype)
    return rng.integers(info.min, info.max, shape, dtype=np_dtype,
                        endpoint=True)


def test_reader_reads_safetensors_files(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(0)
    arrays = {}
    for name, (_, np_dtype) in DTYPES.items():
        if np_dtype is None:  # bf16 through ml_dtypes on this side
            arrays[name] = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
        else:
            arrays[name] = _sample(np_dtype, (3, 5), rng)
    arrays["scalar"] = np.asarray(7, np.int32)
    arrays["empty"] = np.zeros((0, 4), np.float32)
    path = str(tmp_path / "x.safetensors")
    np_save_file(arrays, path, metadata={"k": "v"})
    with st.SafeFile(path) as f:
        assert sorted(f.keys()) == sorted(arrays)
        assert f.metadata == {"k": "v"}
        for name, arr in arrays.items():
            t = f.get(name)
            assert tuple(t.shape) == arr.shape
            if name == "BF16":
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              arr.view(np.int16))
            else:
                assert t.dtype == DTYPES.get(name, (None,))[0] or name in (
                    "scalar", "empty")
                np.testing.assert_array_equal(t.numpy(), arr)
        kept = f.get("F32")
    # a view stays valid after the file closes (it holds its own map)
    np.testing.assert_array_equal(kept.numpy(), arrays["F32"])


def test_writer_is_read_by_safetensors(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {}
    for name, (dtype, np_dtype) in DTYPES.items():
        if np_dtype is None:
            tensors[name] = torch.randn(4, 3).to(torch.bfloat16)
        else:
            tensors[name] = torch.from_numpy(_sample(np_dtype, (4, 3), rng))
    tensors["empty"] = torch.zeros(0, 2)
    path = str(tmp_path / "y.safetensors")
    st.save_file(tensors, path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    assert n % 8 == 0 and header["__metadata__"] == {"format": "pt"}
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        for name, t in tensors.items():
            assert torch.equal(f.get_tensor(name), t), name
    with st.SafeFile(path) as f:
        for name, t in tensors.items():
            back = f.get(name)
            assert back.dtype == t.dtype and torch.equal(back, t)


def test_reader_refuses_an_unknown_dtype(tmp_path):
    path = tmp_path / "z.safetensors"
    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [2],
                               "data_offsets": [0, 2]}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + b"\0\0")
    with pytest.raises(st.SafetensorsError, match="F8_E4M3"):
        st.SafeFile(str(path))


# -- config.json -----------------------------------------------------------------

_BASE = {"architectures": ["LlamaForCausalLM"], "hidden_size": 64,
         "num_attention_heads": 4, "num_hidden_layers": 1,
         "vocab_size": 256, "intermediate_size": 128}
HF_CONFIGS = {
    "qwen3": {"architectures": ["Qwen3ForCausalLM"], "hidden_size": 1024,
              "intermediate_size": 3072, "num_hidden_layers": 28,
              "num_attention_heads": 16, "num_key_value_heads": 8,
              "head_dim": 128, "vocab_size": 151936,
              "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
              "tie_word_embeddings": True, "max_position_embeddings": 40960},
    "llama_default_scaling": {**_BASE,
                              "rope_scaling": {"rope_type": "default"}},
    "rope_scaling": {**_BASE, "rope_scaling": {"rope_type": "llama3",
                                               "factor": 8.0}},
    "sliding_window": {**_BASE, "architectures": ["MistralForCausalLM"],
                       "sliding_window": 4096},
    "sliding_window_off": {**_BASE, "architectures": ["MistralForCausalLM"],
                           "sliding_window": 4096,
                           "use_sliding_window": False},
    "unsupported": {**_BASE, "architectures": ["Qwen2ForCausalLM"]},
    "mixtral": {**_BASE, "architectures": ["MixtralForCausalLM"],
                "num_local_experts": 8, "num_experts_per_tok": 2},
    "qwen3_moe": {**_BASE, "architectures": ["Qwen3MoeForCausalLM"],
                  "num_experts": 16, "num_experts_per_tok": 4,
                  "moe_intermediate_size": 32},
    "deepseek_v2_lite": {**_BASE, "architectures": ["DeepseekV2ForCausalLM"],
                         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                         "kv_lora_rank": 32, "v_head_dim": 16,
                         "n_routed_experts": 8, "num_experts_per_tok": 2,
                         "moe_intermediate_size": 32,
                         "first_k_dense_replace": 1, "n_shared_experts": 1},
    "deepseek_v2_grouped": {**_BASE,
                            "architectures": ["DeepseekV2ForCausalLM"],
                            "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                            "kv_lora_rank": 32, "v_head_dim": 16,
                            "topk_method": "group_limited_greedy"},
    "deepseek_v3": {**_BASE, "architectures": ["DeepseekV3ForCausalLM"],
                    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                    "kv_lora_rank": 32, "q_lora_rank": 48, "v_head_dim": 16,
                    "n_routed_experts": 16, "num_experts_per_tok": 4,
                    "n_group": 4, "topk_group": 2,
                    "routed_scaling_factor": 2.5},
    "gptoss": {**_BASE, "architectures": ["GptOssForCausalLM"],
               "num_local_experts": 4, "num_experts_per_tok": 2,
               "sliding_window": 16,
               "layer_types": ["sliding_attention", "full_attention"],
               "rope_scaling": {"rope_type": "yarn", "factor": 8.0}},
    "gptoss_bad_layers": {**_BASE, "architectures": ["GptOssForCausalLM"],
                          "layer_types": ["full_attention"]},
}


@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_config_from_hf_matches_reference(name):
    cfg = HF_CONFIGS[name]
    try:
        want = ref.config_from_hf(cfg, name="m")
    except ValueError as exc:
        with pytest.raises(ValueError) as info:
            port.config_from_hf(cfg, name="m")
        assert str(info.value) == str(exc)
        return
    got = port.config_from_hf(cfg, name="m")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if not want.is_mla:  # MLA checkpoints are not ported
        assert port.hf_config_dict(got) == ref.hf_config_dict(want)


@pytest.mark.parametrize("name", ["mixtral", "deepseek_v2_lite", "gptoss"])
def test_unported_families_raise_before_any_shard(tmp_path, name):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS[name]))
    cfg = port.config_from_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="not ported"):
        port.load_params(str(tmp_path), cfg, device="cpu")  # no shard here
    with pytest.raises(NotImplementedError, match="not ported"):
        TorchWorker(model_path=str(tmp_path), device="cpu")


# -- the worker ------------------------------------------------------------------

RUNNER = dict(page_size=4, num_pages=64, max_batch=2, max_pages_per_seq=16,
              prefill_buckets=(8, 16))


def test_model_path_sets_the_card_as_the_reference(tmp_path):
    from tokenizers import Tokenizer as HfTok
    from tokenizers.models import WordLevel

    _, ckpt = _ref_checkpoint(tmp_path, _TINY)
    for with_tokenizer in (False, True):
        if with_tokenizer:
            HfTok(WordLevel({"a": 0, "b": 1}, unk_token="a")).save(
                os.path.join(ckpt, "tokenizer.json"))
        ref_worker = TpuWorker(None, model_path=ckpt, warmup=False,
                               runner_config=JRunnerConfig(**RUNNER))
        worker = TorchWorker(model_path=ckpt, device="cpu",
                             runner_config=RunnerConfig(**RUNNER))
        for field in ("name", "tokenizer", "context_length",
                      "kv_block_size", "total_kv_blocks", "model_types"):
            assert getattr(worker.card, field) == getattr(ref_worker.card,
                                                          field), field
        assert worker.card.name == "ckpt"
        assert worker.card.tokenizer == (
            {"kind": "hf", "path": ckpt} if with_tokenizer
            else {"kind": "byte"})
    served = TorchWorker(model_path=ckpt, served_name="served", device="cpu",
                         runner_config=RunnerConfig(**RUNNER))
    assert served.card.name == "served"


def test_model_path_quantizes_after_the_load(tmp_path):
    cfg = dataclasses.replace(_TINY, hidden=128, n_q_heads=2, n_kv_heads=1,
                              head_dim=64, mlp_hidden=512,
                              tie_embeddings=False)
    params, path = _ref_checkpoint(tmp_path, cfg)
    worker = TorchWorker(model_path=path, device="cpu",
                         runner_config=RunnerConfig(weight_dtype="int4",
                                                    **RUNNER))
    want = quantize_params_int4(params_from_numpy(params, cfg, device="cpu"))
    got = worker.runner.model
    for name, t in want.state_dict().items():
        assert torch.equal(got.state_dict()[name], t), name


def _serve(scheduler, requests):
    out = {rid: [] for rid, _ in requests}
    done = threading.Event()
    finished = set()
    lock = threading.Lock()

    def emitter(rid):
        def emit(o):
            with lock:
                out[rid].extend(o.token_ids)
                if o.finish_reason is not None:
                    finished.add(rid)
                    if len(finished) == len(requests):
                        done.set()
        return emit

    scheduler.start()
    try:
        for rid, req in requests:
            scheduler.submit(req, emitter(rid))
        assert done.wait(60.0), "streams did not finish"
    finally:
        scheduler.stop()
    return out


def test_worker_streams_equal_the_jax_engine_on_a_checkpoint(tmp_path):
    """Greedy and seeded streams of a TorchWorker started from a checkpoint
    directory (float32) against the JAX engine over the same directory."""
    cfg = dataclasses.replace(_TINY, tie_embeddings=False)
    _, path = _ref_checkpoint(tmp_path, cfg, seed=5)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 12, 3)]
    temps = [0.0, 0.0, 0.9]

    def requests(make_req, make_samp, make_stop):
        return [(f"r{i}", make_req(
            request_id=f"r{i}", token_ids=p,
            sampling=make_samp(max_tokens=16, temperature=t, seed=i),
            stop=make_stop(ignore_eos=True)))
            for i, (p, t) in enumerate(zip(prompts, temps))]

    worker = TorchWorker(model_path=path, dtype="float32", device="cpu",
                         runner_config=RunnerConfig(**RUNNER))
    got = _serve(worker.scheduler, requests(PreprocessedRequest,
                                            SamplingOptions, StopConditions))
    j_cfg = ref.config_from_checkpoint(path, dtype="float32")
    j_runner = JRunner(j_cfg, JRunnerConfig(**RUNNER), make_mesh(MeshConfig()),
                       params=ref.load_params(path, j_cfg))
    want = _serve(JScheduler(j_runner), requests(JRequest, JSampling, JStop))
    assert all(len(t) == 16 for t in got.values())
    assert got == want
