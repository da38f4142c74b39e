"""HF checkpoint directories: config.json and safetensors shards <-> the
port's `Transformer`.

Port of `dynamo_tpu/models/checkpoint.py`:

  * `config_from_hf(cfg)` / `config_from_checkpoint(dir)` — HF config.json
    -> ModelConfig, field for field as the reference builds it;
  * `build_mapping(config)` — HF tensor names <-> leaves, dense + qk_norm
    (everything but the experts; MLA has a path of its own);
  * the experts of Qwen3-MoE (`mlp.gate`, `mlp.experts.N.gate_proj`) and
    Mixtral (`block_sparse_moe.gate`, `block_sparse_moe.experts.N.w1`)
    checkpoints, the style detected from layer 0's names as the reference
    detects it: each layer's router becomes `router [H, E]` and its experts
    `e_gate / e_up [E, H, M]` and `e_down [E, M, H]`, each expert written
    into its stack on the device as it is read;
  * gpt-oss checkpoints (`GptOssForCausalLM`): the dense mapping's
    attention and norm tensors plus the projection biases, `sinks`, the
    biased router and the fused experts `mlp.experts.gate_up_proj` /
    `down_proj` with their biases, stored in bf16 as [E, in, out] or in
    MXFP4 as `<name>_blocks` [E, out, G, 16] and `<name>_scales`
    [E, out, G] (`mxfp4_dequant`, on the device), transposed to
    [E, in, out];
  * DeepSeek checkpoints (`DeepseekV2ForCausalLM`, `DeepseekV3ForCausalLM`),
    read and written by the reference's `_load_deepseek` / `_save_deepseek`
    mapping: `q_proj` -> `wq` (or `q_a_proj` / `q_a_layernorm` / `q_b_proj`
    -> `w_dq` / `q_a_norm` / `w_uq`), `kv_a_proj_with_mqa` -> `w_dkv` ++
    `w_kr`, `kv_a_layernorm` -> `kv_norm`, `kv_b_proj` -> `w_uk` ++ `w_uv`,
    `o_proj` -> `wo`; the rope rows of the V2 shape permuted from HF's
    interleaved pairs to the half-split rotation (`_rope_perm`, the V3
    shape already rotates halves); `first_k_dense_replace` dense layers,
    then the router (and `e_score_correction_bias`), the experts and the
    shared experts;
  * `ShardReader(dir)` — one file, an index-sharded directory, or a
    directory of shards (`models/safetensors.py` reads the format);
  * `load_params(dir, config)` — the `Transformer`, built on the device
    leaf by leaf: each tensor is mapped, moved to the device, put in the
    reference's layout there and cast to config.dtype, and its map
    dropped, so the process holds one tensor of a 16 GB model in host
    memory at a time;
  * `hf_config_dict(config)` / `save_params(model, config, dir)` — the
    inverse, through the port's writer (one file, or shards with an index);
  * `checkpoint_digest(dir)` — the reference's content fingerprint of the
    weight files (the same windows, header and memo), on the port's XXH64,
    so the weights keys of both packages agree on one directory.

Shape conventions bridged (HF stores Linear as [out, in]; the layouts are
einsum-ready [in, ...out] with explicit head axes):

    q_proj  [qh*hd, H]  ->  wq [H, qh, hd]
    o_proj  [H, qh*hd]  ->  wo [qh, hd, H]
    gate/up [M, H]      ->  w_gate/w_up [H, M]
    down    [H, M]      ->  w_down [M, H]
    router  [E, H]      ->  router [H, E]
    expert gate/up/down ->  row e of e_gate / e_up / e_down, transposed

Errors are the reference's types and name the file: a missing tensor
raises KeyError, a mis-shaped one ValueError, a file that is not
safetensors `SafetensorsError` (a ValueError). Nothing falls back to random
weights. A MoE layer gets no dense MLP leaves (the reference zero-fills
them). gpt-oss directories are read, not written: the reference's
`hf_config_dict` has no gpt-oss branch, so `save_params` refuses them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time as _time
from typing import Callable, Iterator, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..tokens import xxh64_many
from .config import ModelConfig
from .safetensors import SafeFile, save_file, write_shards
from .transformer import Transformer, check_supported, torch_dtype

log = logging.getLogger("dynamo_tpu_torch.models.checkpoint")

# HF tensors that carry no weights we need (buffers, rotary caches).
_IGNORED_SUFFIXES = ("rotary_emb.inv_freq",)


# ---------------------------------------------------------------------------
# HF config.json -> ModelConfig
# ---------------------------------------------------------------------------

# Architectures whose layer layout matches the dense/MoE GQA transformer.
_DENSE_ARCHS = {"LlamaForCausalLM", "MistralForCausalLM",
                "Qwen3ForCausalLM"}
_MOE_ARCHS = {"Qwen3MoeForCausalLM", "MixtralForCausalLM"}
_QK_NORM_ARCHS = {"Qwen3ForCausalLM", "Qwen3MoeForCausalLM"}
_MLA_ARCHS = {"DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM"}
_GPTOSS_ARCHS = {"GptOssForCausalLM"}


def config_from_hf(cfg: dict, name: Optional[str] = None,
                   dtype: str = "bfloat16") -> ModelConfig:
    """Build a ModelConfig from a parsed HF config.json dict."""
    archs = cfg.get("architectures") or []
    arch = archs[0] if archs else ""
    supported = _DENSE_ARCHS | _MOE_ARCHS | _MLA_ARCHS | _GPTOSS_ARCHS
    if arch not in supported:
        raise ValueError(
            f"unsupported architecture {arch!r} (supported: "
            f"{sorted(supported)}); "
            "Qwen2-class models with attention biases are not "
            "representable in this family")
    if arch in _MLA_ARCHS:
        return _config_from_deepseek(cfg, name=name, dtype=dtype)
    if arch in _GPTOSS_ARCHS:
        return _config_from_gptoss(cfg, name=name, dtype=dtype)
    scaling = cfg.get("rope_scaling")
    if scaling and scaling.get("rope_type", scaling.get("type")) != "default":
        raise ValueError(
            f"checkpoint uses rope_scaling={scaling!r}, which the forward "
            "pass does not implement — serving it would produce silently "
            "wrong logits at every position")
    if cfg.get("sliding_window") and cfg.get("use_sliding_window", True):
        raise ValueError(
            "checkpoint uses sliding-window attention, which the forward "
            "pass does not implement (full attention would be silently "
            "wrong)")
    n_q = int(cfg["num_attention_heads"])
    hidden = int(cfg["hidden_size"])
    moe = arch in _MOE_ARCHS
    n_experts = int(cfg.get("num_experts")
                    or cfg.get("num_local_experts") or 0) if moe else 0
    return ModelConfig(
        name=name or cfg.get("model_type", "checkpoint"),
        vocab_size=int(cfg["vocab_size"]),
        hidden=hidden,
        n_layers=int(cfg["num_hidden_layers"]),
        n_q_heads=n_q,
        n_kv_heads=int(cfg.get("num_key_value_heads", n_q)),
        head_dim=int(cfg.get("head_dim") or hidden // n_q),
        mlp_hidden=int(cfg["intermediate_size"]),
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        rms_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        qk_norm=arch in _QK_NORM_ARCHS,
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        max_context=int(cfg.get("max_position_embeddings", 8192)),
        dtype=dtype,
        n_experts=n_experts,
        n_experts_active=int(cfg.get("num_experts_per_tok", 0))
        if moe else 0,
        expert_mlp_hidden=int(cfg.get("moe_intermediate_size")
                              or cfg.get("intermediate_size", 0))
        if moe else 0,
    )


def _config_from_gptoss(cfg: dict, name: Optional[str],
                        dtype: str) -> ModelConfig:
    """gpt-oss family: sink attention, alternating sliding windows, biased
    projections, clipped gated-swiglu MoE, YaRN rope."""
    scaling = cfg.get("rope_scaling") or {}
    rope_type = scaling.get("rope_type", scaling.get("type", "yarn"))
    if scaling and rope_type != "yarn":
        raise ValueError(
            f"gpt-oss rope_type {rope_type!r} is not implemented (yarn "
            "only)")
    layer_types = cfg.get("layer_types") or []
    for i, lt in enumerate(layer_types):
        expect = ("sliding_attention" if i % 2 == 0 else "full_attention")
        if lt != expect:
            raise ValueError(
                "gpt-oss layer_types deviate from the alternating "
                f"sliding/full pattern at layer {i} ({lt!r}) — the "
                "forward hardcodes that pattern")
    n_q = int(cfg["num_attention_heads"])
    hidden = int(cfg["hidden_size"])
    return ModelConfig(
        name=name or cfg.get("model_type", "gpt_oss"),
        vocab_size=int(cfg["vocab_size"]),
        hidden=hidden,
        n_layers=int(cfg["num_hidden_layers"]),
        n_q_heads=n_q,
        n_kv_heads=int(cfg.get("num_key_value_heads", n_q)),
        head_dim=int(cfg.get("head_dim") or hidden // n_q),
        mlp_hidden=int(cfg["intermediate_size"]),
        rope_theta=float(cfg.get("rope_theta", 150000.0)),
        rms_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        max_context=int(cfg.get("max_position_embeddings", 131072)),
        dtype=dtype,
        n_experts=int(cfg.get("num_local_experts", 0)),
        n_experts_active=int(cfg.get("num_experts_per_tok", 0)),
        expert_mlp_hidden=int(cfg["intermediate_size"]),
        attn_sinks=True,
        sliding_window=int(cfg.get("sliding_window") or 0),
        attn_bias=bool(cfg.get("attention_bias", True)),
        swiglu_limit=float(cfg.get("swiglu_limit", 7.0)),
        rope_yarn_factor=float(scaling.get("factor", 32.0)),
        rope_yarn_beta_fast=float(scaling.get("beta_fast", 32.0)),
        rope_yarn_beta_slow=float(scaling.get("beta_slow", 1.0)),
        rope_yarn_orig_max=int(
            scaling.get("original_max_position_embeddings")
            or cfg.get("max_position_embeddings", 4096)),
    )


def _config_from_deepseek(cfg: dict, name: Optional[str],
                          dtype: str) -> ModelConfig:
    """DeepSeek MLA families. V2-Lite shape: direct q_proj, softmax greedy
    routing. V3/R1 shape: q-lora, sigmoid scoring with the
    e_score_correction_bias, node-limited group routing."""
    arch = (cfg.get("architectures") or [""])[0]
    is_v3 = arch == "DeepseekV3ForCausalLM"
    if cfg.get("q_lora_rank") and not is_v3:
        raise ValueError(
            "DeepSeek-V2 checkpoints with q_lora_rank use group-limited "
            "routing this loader does not implement; V2-Lite (direct "
            "q_proj) or V3/R1 only")
    if not is_v3 and cfg.get("topk_method", "greedy") not in (None,
                                                              "greedy"):
        raise ValueError(
            f"DeepSeek-V2 topk_method={cfg.get('topk_method')!r} (grouped "
            "routing) is not implemented — greedy only (V2-Lite)")
    if not is_v3 and cfg.get("scoring_func", "softmax") != "softmax":
        raise ValueError("sigmoid scoring outside V3 is not implemented")
    scaling = cfg.get("rope_scaling")
    if scaling and scaling.get("rope_type", scaling.get("type")) != "default":
        raise ValueError(f"rope_scaling={scaling!r} not implemented")
    nhd = int(cfg["qk_nope_head_dim"])
    rhd = int(cfg["qk_rope_head_dim"])
    n_q = int(cfg["num_attention_heads"])
    return ModelConfig(
        name=name or cfg.get("model_type", "deepseek"),
        vocab_size=int(cfg["vocab_size"]),
        hidden=int(cfg["hidden_size"]),
        n_layers=int(cfg["num_hidden_layers"]),
        n_q_heads=n_q,
        n_kv_heads=int(cfg.get("num_key_value_heads", n_q)),
        head_dim=nhd + rhd,
        mlp_hidden=int(cfg["intermediate_size"]),
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        rms_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        max_context=int(cfg.get("max_position_embeddings", 8192)),
        dtype=dtype,
        n_experts=int(cfg.get("n_routed_experts") or 0),
        n_experts_active=int(cfg.get("num_experts_per_tok") or 0),
        expert_mlp_hidden=int(cfg.get("moe_intermediate_size") or 0),
        first_k_dense=int(cfg.get("first_k_dense_replace") or 0),
        n_shared_experts=int(cfg.get("n_shared_experts") or 0),
        moe_norm_topk=bool(cfg.get("norm_topk_prob", False)),
        moe_routed_scale=float(cfg.get("routed_scaling_factor", 1.0)),
        moe_scoring="sigmoid" if is_v3 else "softmax",
        moe_n_group=int(cfg.get("n_group") or 1) if is_v3 else 1,
        moe_topk_group=int(cfg.get("topk_group") or 1) if is_v3 else 1,
        mla_kv_lora_rank=int(cfg["kv_lora_rank"]),
        mla_q_lora_rank=int(cfg.get("q_lora_rank") or 0),
        mla_rope_head_dim=rhd,
        mla_nope_head_dim=nhd,
        mla_v_head_dim=int(cfg["v_head_dim"]),
    )


def config_from_checkpoint(path: str, name: Optional[str] = None,
                           dtype: str = "bfloat16") -> ModelConfig:
    """ModelConfig from a checkpoint directory's config.json; the name is
    the directory's basename unless given."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"{cfg_path} not found — a model path must be an HF-style "
            "checkpoint directory (config.json + *.safetensors)")
    with open(cfg_path) as f:
        try:
            cfg = json.load(f)
        except ValueError as exc:
            raise ValueError(f"{cfg_path} is not valid JSON: {exc}") from None
    if name is None:
        name = os.path.basename(os.path.normpath(path))
    try:
        return config_from_hf(cfg, name=name, dtype=dtype)
    except (KeyError, TypeError, ValueError) as exc:
        raise type(exc)(f"{cfg_path}: {exc}") from None


# ---------------------------------------------------------------------------
# Name mapping (declarative, invertible)
# ---------------------------------------------------------------------------

Transform = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class _Entry:
    hf_name: str
    path: tuple  # into the param tree, e.g. ("layers", 3, "wq")
    shape: tuple  # the HF tensor's shape
    to_ours: Transform
    to_hf: Transform


def _copy(x: torch.Tensor) -> torch.Tensor:
    return x


def _linear(n_in: int, n_out: int) -> tuple:
    """HF Linear [out, in] <-> ours [in, out]."""
    return ((n_out, n_in), lambda x: x.t().contiguous(),
            lambda x: x.t().contiguous())


def _heads_in(h: int, nh: int, hd: int) -> tuple:
    """q/k/v_proj [nh*hd, H] <-> [H, nh, hd]."""
    return ((nh * hd, h), lambda x: x.t().contiguous().reshape(h, nh, hd),
            lambda x: x.reshape(h, nh * hd).t().contiguous())


def _heads_out(h: int, nh: int, hd: int) -> tuple:
    """o_proj [H, nh*hd] <-> [nh, hd, H]."""
    return ((h, nh * hd), lambda x: x.t().contiguous().reshape(nh, hd, h),
            lambda x: x.reshape(nh * hd, h).t().contiguous())


def build_mapping(config: ModelConfig) -> list[_Entry]:
    """Dense-path entries: every tensor of a dense (or qk_norm) model."""
    if config.is_mla:
        raise ValueError("MLA checkpoints load through the dedicated "
                         "DeepSeek path (_load_deepseek)")
    h, hd = config.hidden, config.head_dim
    qh, kh, m = config.n_q_heads, config.n_kv_heads, config.mlp_hidden
    vec = lambda n: ((n,), _copy, _copy)  # noqa: E731
    entries: list[_Entry] = [
        _Entry("model.embed_tokens.weight", ("embed",), (config.vocab_size, h),
               _copy, _copy),
        _Entry("model.norm.weight", ("final_norm",), *vec(h)),
    ]
    if not config.tie_embeddings:
        entries.append(_Entry("lm_head.weight", ("lm_head",),
                              *_linear(h, config.vocab_size)))
    for i in range(config.n_layers):
        p = f"model.layers.{i}."

        def e(hf: str, key: str, spec: tuple) -> _Entry:
            return _Entry(p + hf, ("layers", i, key), *spec)

        entries += [
            e("input_layernorm.weight", "attn_norm", vec(h)),
            e("self_attn.q_proj.weight", "wq", _heads_in(h, qh, hd)),
            e("self_attn.k_proj.weight", "wk", _heads_in(h, kh, hd)),
            e("self_attn.v_proj.weight", "wv", _heads_in(h, kh, hd)),
            e("self_attn.o_proj.weight", "wo", _heads_out(h, qh, hd)),
            e("post_attention_layernorm.weight", "mlp_norm", vec(h)),
        ]
        if config.qk_norm:
            entries += [
                e("self_attn.q_norm.weight", "q_norm", vec(hd)),
                e("self_attn.k_norm.weight", "k_norm", vec(hd)),
            ]
        if not config.n_experts:
            entries += [
                e("mlp.gate_proj.weight", "w_gate", _linear(h, m)),
                e("mlp.up_proj.weight", "w_up", _linear(h, m)),
                e("mlp.down_proj.weight", "w_down", _linear(m, h)),
            ]
    return entries


def _expert_style(present: set[str], layer0: str) -> str:
    """Detect MoE naming: qwen3moe `mlp.experts.{e}.gate_proj` vs mixtral
    `block_sparse_moe.experts.{e}.w1`."""
    if f"{layer0}mlp.experts.0.gate_proj.weight" in present:
        return "qwen3moe"
    if f"{layer0}block_sparse_moe.experts.0.w1.weight" in present:
        return "mixtral"
    raise KeyError(
        "MoE checkpoint uses an unrecognized expert naming scheme "
        "(expected mlp.experts.N.gate_proj or block_sparse_moe.experts.N.w1)")


def _moe_names(style: str, prefix: str, e: int) -> dict:
    """Per-expert tensor names for gate/up/down + the router."""
    if style == "qwen3moe":
        return {
            "router": f"{prefix}mlp.gate.weight",
            "gate": f"{prefix}mlp.experts.{e}.gate_proj.weight",
            "up": f"{prefix}mlp.experts.{e}.up_proj.weight",
            "down": f"{prefix}mlp.experts.{e}.down_proj.weight",
        }
    return {
        "router": f"{prefix}block_sparse_moe.gate.weight",
        "gate": f"{prefix}block_sparse_moe.experts.{e}.w1.weight",
        "up": f"{prefix}block_sparse_moe.experts.{e}.w3.weight",
        "down": f"{prefix}block_sparse_moe.experts.{e}.w2.weight",
    }


# Our expert stacks by the per-expert HF name they gather: (stack, key)
_EXPERT_STACKS = (("e_gate", "gate"), ("e_up", "up"), ("e_down", "down"))


# ---------------------------------------------------------------------------
# Safetensors shard reader
# ---------------------------------------------------------------------------


class ShardReader:
    """Lazy tensor access across a single-file or index-sharded checkpoint.
    Each tensor is a view over its shard's file map until the caller
    copies it, so a load holds one tensor's copy at a time."""

    def __init__(self, path: str) -> None:
        self.dir = path
        if os.path.isfile(path):
            self.dir = os.path.dirname(path)
            self._weight_map = None
            self._shards = [os.path.basename(path)]
        else:
            index = os.path.join(path, "model.safetensors.index.json")
            if os.path.exists(index):
                with open(index) as f:
                    try:
                        self._weight_map = json.load(f)["weight_map"]
                    except (KeyError, TypeError, ValueError) as exc:
                        raise ValueError(
                            f"{index}: not a safetensors index "
                            f"({exc!r})") from None
                self._shards = sorted(set(self._weight_map.values()))
            else:
                if not os.path.isdir(path):
                    raise FileNotFoundError(f"{path} does not exist")
                shards = sorted(f for f in os.listdir(path)
                                if f.endswith(".safetensors"))
                if not shards:
                    raise FileNotFoundError(
                        f"no *.safetensors files under {path}")
                self._weight_map = None
                self._shards = shards
        self._handles: dict[str, SafeFile] = {}
        self._name_to_shard: Optional[dict[str, str]] = (
            dict(self._weight_map) if self._weight_map else None)

    def _open(self, shard: str) -> SafeFile:
        if shard not in self._handles:
            self._handles[shard] = SafeFile(os.path.join(self.dir, shard))
        return self._handles[shard]

    def names(self) -> set[str]:
        if self._name_to_shard is None:
            self._name_to_shard = {}
            for shard in self._shards:
                for name in self._open(shard).keys():
                    self._name_to_shard[name] = shard
        return set(self._name_to_shard)

    def shard_of(self, name: str) -> str:
        return os.path.join(self.dir, self._name_to_shard[name])

    def get(self, name: str) -> torch.Tensor:
        if name not in self.names():
            raise KeyError(f"checkpoint {self.dir} has no tensor {name!r}")
        shard = self._name_to_shard[name]
        handle = self._open(shard)
        if name not in handle.keys():
            raise KeyError(f"{os.path.join(self.dir, shard)} has no tensor "
                           f"{name!r}, which the index places there")
        return handle.get(name)

    def close(self) -> None:
        for handle in self._handles.values():
            handle.close()
        self._handles.clear()

    def __enter__(self) -> "ShardReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Load / save
# ---------------------------------------------------------------------------


def _set_path(tree: dict, path: tuple, value) -> None:
    node = tree
    for part in path[:-1]:
        node = node[part]
    node[path[-1]] = value


def _get_path(tree, path: tuple):
    node = tree
    for part in path:
        node = node[part]
    return node


def load_params(path: str, config: ModelConfig, *,
                device: DeviceLike = "cuda") -> Transformer:
    """Read an HF safetensors checkpoint into the port's `Transformer` on
    `device`, cast to config.dtype. Raises on missing / mis-shaped tensors
    (naming the file): serving random weights is never acceptable once a
    model path was given."""
    check_supported(config)
    dev = resolve_device(device)
    dtype = torch_dtype(config.dtype)
    tree: dict = {"layers": [{} for _ in range(config.n_layers)]}
    with ShardReader(path) as reader:
        present = reader.names()
        loaded: set[str] = set()

        def read(name: str, shape: tuple) -> torch.Tensor:
            raw = reader.get(name)
            if tuple(raw.shape) != shape:
                raise ValueError(
                    f"{reader.shard_of(name)}: checkpoint tensor {name} has "
                    f"shape {tuple(raw.shape)}, expected {shape}")
            # one copy: the tensor's map -> the device (a copy on the CPU
            # too, so no leaf keeps the map alive; it goes with `raw`)
            return raw.to(dev, copy=True)

        if config.is_mla:
            n_bytes = _load_deepseek(read, config, tree, dev, dtype, loaded)
        else:
            n_bytes = _load_mapped(read, present, config, tree, dtype, loaded)
            if config.is_gptoss:
                n_bytes += _load_gptoss(read, present, config, tree, dtype,
                                        loaded)
            elif config.n_experts:
                n_bytes += _load_experts(read, present, config, tree, dev,
                                         dtype, loaded)
        leftovers = [n for n in present - loaded
                     if not n.endswith(_IGNORED_SUFFIXES)
                     and not (config.tie_embeddings
                              and n == "lm_head.weight")]
        if leftovers:
            log.warning("checkpoint %s has %d unused tensors (first: %s) — "
                        "config/family mismatch?", path, len(leftovers),
                        sorted(leftovers)[:3])
    log.info("loaded checkpoint %s: %.2f GiB as %s on %s", path,
             n_bytes / 2**30, config.dtype, dev)
    return Transformer(config, tree)


def _load_mapped(read, present: set[str], config: ModelConfig, tree: dict,
                 dtype: torch.dtype, loaded: set[str]) -> int:
    """Every tensor of `build_mapping` into `tree`; returns their bytes."""
    n_bytes = 0
    for entry in build_mapping(config):
        if (entry.hf_name == "lm_head.weight"
                and entry.hf_name not in present
                and not config.is_gptoss):
            # Tied-in-practice checkpoint that omits the head: HF falls
            # back to the embedding — mirror that (the reference's gpt-oss
            # loader does not).
            emb = read("model.embed_tokens.weight",
                       (config.vocab_size, config.hidden))
            leaf = emb.t().contiguous().to(dtype)
        else:
            leaf = entry.to_ours(read(entry.hf_name, entry.shape)).to(dtype)
            loaded.add(entry.hf_name)
        n_bytes += leaf.numel() * leaf.element_size()
        _set_path(tree, entry.path, leaf)
    return n_bytes


def _load_experts(read, present: set[str], config: ModelConfig, tree: dict,
                  dev: torch.device, dtype: torch.dtype,
                  loaded: set[str]) -> int:
    """Every layer's router and expert stacks into `tree`, each expert
    copied into its row of a stack allocated on the device; returns their
    bytes."""
    style = _expert_style(present, "model.layers.0.")
    h, e = config.hidden, config.n_experts
    em = config.expert_mlp_hidden or config.mlp_hidden
    shapes = {"gate": (em, h), "up": (em, h), "down": (h, em)}
    n_bytes = 0
    for i in range(config.n_layers):
        prefix = f"model.layers.{i}."
        lp = tree["layers"][i]
        router = _moe_names(style, prefix, 0)["router"]
        lp["router"] = read(router, (e, h)).t().contiguous().to(dtype)
        loaded.add(router)
        for stack, key in _EXPERT_STACKS:
            lp[stack] = torch.empty((e, *shapes[key][::-1]), dtype=dtype,
                                    device=dev)
        for j in range(e):
            names = _moe_names(style, prefix, j)
            for stack, key in _EXPERT_STACKS:
                lp[stack][j] = read(names[key], shapes[key]).t()
            loaded.update(names.values())
        n_bytes += sum(lp[name].numel() * lp[name].element_size()
                       for name in ("router", "e_gate", "e_up", "e_down"))
    return n_bytes


# E2M1 codes -> values (the reference's `_FP4_LUT`)
_FP4_LUT = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
            -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)


def mxfp4_dequant(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """MXFP4 -> f32, as the reference's `mxfp4_dequant` (the format of HF
    gpt-oss checkpoints). blocks: uint8 [..., G, 16], 32 E2M1 values a
    group, the LOW nibble first; scales: uint8 [..., G], one E8M0 exponent a
    group, 2^(s - 127). Returns [..., G * 32] f32 on blocks' device. The
    scale is built from its bits (s << 23; 2^-127 is the subnormal 1 << 22,
    and s = 255 gives inf, as the reference's exp2 does), so every value is
    the exact product."""
    lut = torch.tensor(_FP4_LUT, dtype=torch.float32, device=blocks.device)
    codes = blocks.long()
    vals = torch.stack([lut[codes & 0x0F], lut[codes >> 4]], dim=-1)
    s = scales.to(device=blocks.device, dtype=torch.int32)
    bits = torch.where(s == 0, torch.full_like(s, 1 << 22), s << 23)
    out = vals.reshape(*blocks.shape[:-1], -1) * bits.view(
        torch.float32)[..., None]
    return out.reshape(*out.shape[:-2], -1)


def _gptoss_expert_tensor(read, present: set[str], base: str, shape: tuple,
                          loaded: set[str]) -> torch.Tensor:
    """An expert stack in the forward layout `shape` = [e, in, out] on the
    device: a bf16 checkpoint stores it so under `base`; an MXFP4 one
    stores `<base>_blocks` [e, out, in / 32, 16] and `<base>_scales`
    [e, out, in / 32], dequantized and transposed (as the HF dequant's
    final transpose(1, 2))."""
    if base in present:
        loaded.add(base)
        return read(base, shape)
    e, n_in, n_out = shape
    blocks = read(base + "_blocks", (e, n_out, n_in // 32, 16))
    scales = read(base + "_scales", (e, n_out, n_in // 32))
    loaded.update((base + "_blocks", base + "_scales"))
    return mxfp4_dequant(blocks, scales).transpose(1, 2).contiguous()


def _load_gptoss(read, present: set[str], config: ModelConfig, tree: dict,
                 dtype: torch.dtype, loaded: set[str]) -> int:
    """Every gpt-oss layer's leaves beyond the dense mapping (the reference's
    `_load_gptoss`): the projection biases, `sinks`, the router and its
    bias, and the expert stacks with their biases; returns their bytes."""
    h, hd = config.hidden, config.head_dim
    qh, kh, e = config.n_q_heads, config.n_kv_heads, config.n_experts
    em = config.expert_mlp_hidden or config.mlp_hidden
    n_bytes = 0
    for i in range(config.n_layers):
        p = f"model.layers.{i}."
        a, m = p + "self_attn.", p + "mlp."
        vectors = {  # leaf: (HF name, HF shape, our shape)
            "bq": (a + "q_proj.bias", (qh * hd,), (qh, hd)),
            "bk": (a + "k_proj.bias", (kh * hd,), (kh, hd)),
            "bv": (a + "v_proj.bias", (kh * hd,), (kh, hd)),
            "bo": (a + "o_proj.bias", (h,), (h,)),
            "sinks": (a + "sinks", (qh,), (qh,)),
            "router_bias": (m + "router.bias", (e,), (e,)),
            "e_gate_up_bias": (m + "experts.gate_up_proj_bias", (e, 2 * em),
                               (e, 2 * em)),
            "e_down_bias": (m + "experts.down_proj_bias", (e, h), (e, h)),
        }
        lp = tree["layers"][i]
        for leaf, (name, shape, ours) in vectors.items():
            lp[leaf] = read(name, shape).reshape(ours).to(dtype)
            loaded.add(name)
        lp["router"] = read(m + "router.weight", (e, h)).t().contiguous(
            ).to(dtype)
        loaded.add(m + "router.weight")
        lp["e_gate_up"] = _gptoss_expert_tensor(
            read, present, m + "experts.gate_up_proj", (e, h, 2 * em),
            loaded).to(dtype)
        lp["e_down"] = _gptoss_expert_tensor(
            read, present, m + "experts.down_proj", (e, em, h),
            loaded).to(dtype)
        n_bytes += sum(lp[leaf].numel() * lp[leaf].element_size()
                       for leaf in (*vectors, "router", "e_gate_up",
                                    "e_down"))
    return n_bytes


def _rope_perm(rhd: int) -> torch.Tensor:
    """HF DeepSeek-V2's interleaved rope (pairs 2i, 2i + 1) -> the half-
    split rotation (i, i + rhd/2): the order of the rope rows of the
    projections. q and k permute alike, so their products do not change."""
    return torch.cat([torch.arange(0, rhd, 2), torch.arange(1, rhd, 2)])


def _rope_order(config: ModelConfig, inverse: bool = False) -> torch.Tensor:
    """The rope rows' order between HF and the forward: `_rope_perm` (or
    its inverse) for the V2 shape, the identity for the V3 shape, whose HF
    modeling already rotates halves."""
    rhd = config.mla_rope_head_dim
    if config.moe_scoring == "sigmoid" or config.mla_q_lora_rank > 0:
        return torch.arange(rhd)
    perm = _rope_perm(rhd)
    return torch.argsort(perm) if inverse else perm


def _reorder_rope(w: torch.Tensor, n: int, order: torch.Tensor
                  ) -> torch.Tensor:
    """[..., n + rhd] with its last rhd entries (the rope rows) taken in
    `order`."""
    return torch.cat([w[..., :n], w[..., n:][..., order.to(w.device)]],
                     dim=-1)


def _load_deepseek(read, config: ModelConfig, tree: dict, dev: torch.device,
                   dtype: torch.dtype, loaded: set[str]) -> int:
    """A DeepSeek MLA checkpoint into `tree`, as the reference's
    `_load_deepseek` maps it (see the module docstring), every tensor's
    shape checked; each expert is written into its row of a stack allocated
    on the device as it is read, and a MoE layer gets no dense MLP leaves.
    Returns the leaves' bytes."""
    h, qh, vocab = config.hidden, config.n_q_heads, config.vocab_size
    nhd, rhd = config.mla_nope_head_dim, config.mla_rope_head_dim
    vhd, dc, qr = (config.mla_v_head_dim, config.mla_kv_lora_rank,
                   config.mla_q_lora_rank)
    e, m = config.n_experts, config.mlp_hidden
    em = config.expert_mlp_hidden or m
    order = _rope_order(config)

    def get(name: str, shape: tuple) -> torch.Tensor:
        loaded.add(name)
        return read(name, shape)

    def linear(name: str, n_in: int, n_out: int) -> torch.Tensor:
        """HF Linear [out, in] -> [in, out]."""
        return get(name, (n_out, n_in)).t().contiguous()

    tree["embed"] = get("model.embed_tokens.weight", (vocab, h)).to(dtype)
    tree["final_norm"] = get("model.norm.weight", (h,)).to(dtype)
    if not config.tie_embeddings:
        tree["lm_head"] = linear("lm_head.weight", h, vocab).to(dtype)
    for i in range(config.n_layers):
        p = f"model.layers.{i}."
        a, f = p + "self_attn.", p + "mlp."
        lp = tree["layers"][i]
        if qr:
            lp["w_dq"] = linear(a + "q_a_proj.weight", h, qr).to(dtype)
            lp["q_a_norm"] = get(a + "q_a_layernorm.weight", (qr,)).to(dtype)
            w_uq = linear(a + "q_b_proj.weight", qr, qh * (nhd + rhd))
            lp["w_uq"] = _reorder_rope(w_uq.reshape(qr, qh, nhd + rhd), nhd,
                                       order).to(dtype)
        else:
            wq = linear(a + "q_proj.weight", h, qh * (nhd + rhd))
            lp["wq"] = _reorder_rope(wq.reshape(h, qh, nhd + rhd), nhd,
                                     order).to(dtype)
        kv_a = _reorder_rope(linear(a + "kv_a_proj_with_mqa.weight", h,
                                    dc + rhd), dc, order)
        lp["w_dkv"] = kv_a[:, :dc].contiguous().to(dtype)
        lp["w_kr"] = kv_a[:, dc:].contiguous().to(dtype)
        lp["kv_norm"] = get(a + "kv_a_layernorm.weight", (dc,)).to(dtype)
        kv_b = linear(a + "kv_b_proj.weight", dc, qh * (nhd + vhd)).reshape(
            dc, qh, nhd + vhd)
        lp["w_uk"] = kv_b[..., :nhd].contiguous().to(dtype)
        lp["w_uv"] = kv_b[..., nhd:].contiguous().to(dtype)
        lp["wo"] = linear(a + "o_proj.weight", qh * vhd, h).reshape(
            qh, vhd, h).to(dtype)
        lp["attn_norm"] = get(p + "input_layernorm.weight", (h,)).to(dtype)
        lp["mlp_norm"] = get(p + "post_attention_layernorm.weight",
                             (h,)).to(dtype)
        if not config.layer_is_moe(i):
            lp["w_gate"] = linear(f + "gate_proj.weight", h, m).to(dtype)
            lp["w_up"] = linear(f + "up_proj.weight", h, m).to(dtype)
            lp["w_down"] = linear(f + "down_proj.weight", m, h).to(dtype)
            continue
        lp["router"] = linear(f + "gate.weight", h, e).to(dtype)
        if config.moe_scoring == "sigmoid":
            lp["e_bias"] = get(f + "gate.e_score_correction_bias",
                               (e,)).float()
        shapes = {"gate": (em, h), "up": (em, h), "down": (h, em)}
        for stack, key in _EXPERT_STACKS:
            lp[stack] = torch.empty((e, *shapes[key][::-1]), dtype=dtype,
                                    device=dev)
        for j in range(e):
            for stack, key in _EXPERT_STACKS:
                lp[stack][j] = get(f"{f}experts.{j}.{key}_proj.weight",
                                   shapes[key]).t()
        if config.n_shared_experts:
            sm = config.n_shared_experts * em
            s = f + "shared_experts."
            lp["s_gate"] = linear(s + "gate_proj.weight", h, sm).to(dtype)
            lp["s_up"] = linear(s + "up_proj.weight", h, sm).to(dtype)
            lp["s_down"] = linear(s + "down_proj.weight", sm, h).to(dtype)
    leaves = [tree["embed"], tree["final_norm"], tree.get("lm_head")]
    leaves += [t for lp in tree["layers"] for t in lp.values()]
    return sum(t.numel() * t.element_size() for t in leaves if t is not None)


def _deepseek_hf_tensors(model: Transformer, config: ModelConfig
                         ) -> Iterator[tuple[str, torch.Tensor]]:
    """(HF name, tensor) of an MLA model, the exact inverse of
    `_load_deepseek` (the reference's `_save_deepseek` names and layouts),
    each tensor made when the writer asks for it."""
    h, qh, nhd = config.hidden, config.n_q_heads, config.mla_nope_head_dim
    vhd, dc, qr = (config.mla_v_head_dim, config.mla_kv_lora_rank,
                   config.mla_q_lora_rank)
    inv = _rope_order(config, inverse=True)

    def hf(w: torch.Tensor, n_in: int) -> torch.Tensor:
        """Ours [in, ...out] -> HF Linear [out, in]."""
        return w.detach().reshape(n_in, -1).t().contiguous()

    yield "model.embed_tokens.weight", model.embed.detach()
    yield "model.norm.weight", model.final_norm.detach()
    if not config.tie_embeddings:
        yield "lm_head.weight", hf(model.lm_head, h)
    for i, lp in enumerate(model.layers):
        p = f"model.layers.{i}."
        a, f = p + "self_attn.", p + "mlp."
        if qr:
            yield a + "q_a_proj.weight", hf(lp["w_dq"], h)
            yield a + "q_a_layernorm.weight", lp["q_a_norm"].detach()
            yield a + "q_b_proj.weight", hf(
                _reorder_rope(lp["w_uq"].detach(), nhd, inv), qr)
        else:
            yield a + "q_proj.weight", hf(
                _reorder_rope(lp["wq"].detach(), nhd, inv), h)
        kv_a = torch.cat([lp["w_dkv"].detach(), lp["w_kr"].detach()], dim=1)
        yield a + "kv_a_proj_with_mqa.weight", hf(
            _reorder_rope(kv_a, dc, inv), h)
        yield a + "kv_a_layernorm.weight", lp["kv_norm"].detach()
        yield a + "kv_b_proj.weight", hf(
            torch.cat([lp["w_uk"].detach(), lp["w_uv"].detach()], dim=-1), dc)
        yield a + "o_proj.weight", hf(lp["wo"], qh * vhd)
        yield p + "input_layernorm.weight", lp["attn_norm"].detach()
        yield p + "post_attention_layernorm.weight", lp["mlp_norm"].detach()
        if not config.layer_is_moe(i):
            for key in ("gate", "up", "down"):
                leaf = lp["w_" + key]
                yield f"{f}{key}_proj.weight", hf(leaf, leaf.shape[0])
            continue
        yield f + "gate.weight", hf(lp["router"], h)
        if config.moe_scoring == "sigmoid":
            yield (f + "gate.e_score_correction_bias",
                   lp["e_bias"].detach().float())
        for j in range(config.n_experts):
            for stack, key in _EXPERT_STACKS:
                yield (f"{f}experts.{j}.{key}_proj.weight",
                       lp[stack][j].detach().t().contiguous())
        if config.n_shared_experts:
            for key in ("gate", "up", "down"):
                leaf = lp["s_" + key]
                yield (f"{f}shared_experts.{key}_proj.weight",
                       hf(leaf, leaf.shape[0]))


def hf_config_dict(config: ModelConfig) -> dict:
    """config.json contents for an exported dense, MoE or DeepSeek
    checkpoint (HF-readable). Like the reference's it has no gpt-oss branch
    (a gpt-oss config comes out Mixtral-shaped), so `save_params` refuses
    gpt-oss."""
    if config.is_mla:
        v3 = config.moe_scoring == "sigmoid" or config.mla_q_lora_rank > 0
        return {
            "architectures": ["DeepseekV3ForCausalLM" if v3
                              else "DeepseekV2ForCausalLM"],
            "model_type": "deepseek_v3" if v3 else "deepseek_v2",
            "hidden_size": config.hidden,
            "intermediate_size": config.mlp_hidden,
            "max_position_embeddings": config.max_context,
            "num_attention_heads": config.n_q_heads,
            "num_key_value_heads": config.n_kv_heads,
            "num_hidden_layers": config.n_layers,
            "rms_norm_eps": config.rms_eps,
            "rope_theta": config.rope_theta,
            "tie_word_embeddings": config.tie_embeddings,
            "vocab_size": config.vocab_size,
            "torch_dtype": config.dtype,
            "q_lora_rank": config.mla_q_lora_rank or None,
            "kv_lora_rank": config.mla_kv_lora_rank,
            "qk_nope_head_dim": config.mla_nope_head_dim,
            "qk_rope_head_dim": config.mla_rope_head_dim,
            "v_head_dim": config.mla_v_head_dim,
            "head_dim": config.mla_rope_head_dim,
            "n_routed_experts": config.n_experts or None,
            "num_experts_per_tok": config.n_experts_active or None,
            "moe_intermediate_size": config.expert_mlp_hidden or None,
            "n_shared_experts": config.n_shared_experts or None,
            "first_k_dense_replace": config.first_k_dense,
            "norm_topk_prob": config.moe_norm_topk,
            "routed_scaling_factor": config.moe_routed_scale,
            "topk_method": "noaux_tc" if v3 else "greedy",
            "scoring_func": config.moe_scoring,
            "n_group": config.moe_n_group,
            "topk_group": config.moe_topk_group,
            "num_experts_per_token": config.n_experts_active or None,
            "attention_bias": False,
            "moe_layer_freq": 1,
        }
    moe = config.n_experts > 0
    if moe:
        arch = "Qwen3MoeForCausalLM" if config.qk_norm \
            else "MixtralForCausalLM"
    else:
        arch = "Qwen3ForCausalLM" if config.qk_norm else "LlamaForCausalLM"
    cfg = {
        "architectures": [arch],
        "hidden_size": config.hidden,
        "intermediate_size": config.mlp_hidden,
        "max_position_embeddings": config.max_context,
        "num_attention_heads": config.n_q_heads,
        "num_hidden_layers": config.n_layers,
        "num_key_value_heads": config.n_kv_heads,
        "head_dim": config.head_dim,
        "rms_norm_eps": config.rms_eps,
        "rope_theta": config.rope_theta,
        "tie_word_embeddings": config.tie_embeddings,
        "vocab_size": config.vocab_size,
        "torch_dtype": config.dtype,
        "model_type": "qwen3" if config.qk_norm else "llama",
    }
    if moe:
        cfg["num_experts"] = config.n_experts
        cfg["num_local_experts"] = config.n_experts
        cfg["num_experts_per_tok"] = config.n_experts_active
        cfg["moe_intermediate_size"] = (config.expert_mlp_hidden
                                        or config.mlp_hidden)
        cfg["norm_topk_prob"] = True
        cfg["model_type"] = ("qwen3_moe" if config.qk_norm else "mixtral")
    return cfg


def _hf_tensors(model: Transformer, config: ModelConfig
                ) -> Iterator[tuple[str, torch.Tensor]]:
    if config.is_mla:
        yield from _deepseek_hf_tensors(model, config)
        return
    tree = {"embed": model.embed, "final_norm": model.final_norm,
            "lm_head": model.lm_head, "layers": model.layers}
    for entry in build_mapping(config):
        leaf = _get_path(tree, entry.path)
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"{entry.hf_name}: a {type(leaf).__name__} leaf "
                            "cannot be saved (save the dense model)")
        yield entry.hf_name, entry.to_hf(leaf.detach())
    if config.n_experts:
        style = "qwen3moe" if config.qk_norm else "mixtral"
        for i, lp in enumerate(model.layers):
            prefix = f"model.layers.{i}."
            yield (_moe_names(style, prefix, 0)["router"],
                   lp["router"].detach().t().contiguous())
            for j in range(config.n_experts):
                names = _moe_names(style, prefix, j)
                for stack, key in _EXPERT_STACKS:
                    yield names[key], lp[stack][j].detach().t().contiguous()


def save_params(model: Transformer, config: ModelConfig, path: str, *,
                max_shard_bytes: Optional[int] = None) -> None:
    """Write the model as an HF-style checkpoint directory: config.json,
    and model.safetensors (or, with `max_shard_bytes`, numbered shards and
    model.safetensors.index.json), with HF names; a MoE model's experts
    under the Qwen3-MoE names when it has qk_norm, else Mixtral's, and an
    MLA model under DeepSeek's, as the reference names them. The exact
    inverse of `load_params`. Each tensor
    is copied to the host once, as it is written. gpt-oss raises
    NotImplementedError: `hf_config_dict` cannot describe it."""
    check_supported(config)
    if config.is_gptoss:
        raise NotImplementedError(
            f"{config.name}: gpt-oss checkpoints are read, not written (no "
            "gpt-oss config.json writer, as in the reference)")
    os.makedirs(path, exist_ok=True)
    if max_shard_bytes is None:
        save_file(dict(_hf_tensors(model, config)),
                  os.path.join(path, "model.safetensors"))
    else:
        write_shards(_hf_tensors(model, config), path, max_shard_bytes)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(config), f, indent=2)


_DIGEST_CACHE: dict = {}


def checkpoint_digest(path: str) -> str:
    """Cheap content fingerprint of a checkpoint's weight files, equal to
    the reference's: per safetensors file its name and size, the head
    window, the full header, interior 4 KiB windows at most 16 MiB apart
    (at most 64 a file) and the tail window; config.json whole. The value
    never depends on mtimes (two hosts holding the same bytes agree), but
    it is memoized per directory on a (name, size, mtime) signature of
    files quiet for 2 s, so repeat calls cost a stat() sweep."""
    root_key = os.path.realpath(
        path if os.path.isdir(path) else os.path.dirname(path))
    try:
        stats = [
            (name, os.stat(os.path.join(root_key, name)))
            for name in sorted(os.listdir(root_key))
            if name == "config.json" or name.endswith(".safetensors")]
        sig = tuple((name, st.st_size, st.st_mtime_ns)
                    for name, st in stats)
        newest = max((st.st_mtime for _n, st in stats), default=0.0)
        if abs(_time.time() - newest) < 2.0:
            sig = None
    except OSError:
        sig = None
    if sig is not None:
        cached = _DIGEST_CACHE.get(root_key)
        if cached is not None and cached[0] == sig:
            return cached[1]

    # XXH64 streamed over the pieces equals XXH64 of their concatenation
    pieces: list[bytes] = []
    window = 1 << 16
    stride_window = 1 << 12
    max_stride = 16 << 20
    n_strides = 32
    root = path if os.path.isdir(path) else os.path.dirname(path)
    for fname in sorted(os.listdir(root)):
        fpath = os.path.join(root, fname)
        if fname == "config.json":
            with open(fpath, "rb") as f:
                pieces.append(f.read())
        elif fname.endswith(".safetensors"):
            size = os.path.getsize(fpath)
            pieces.append(f"{fname}:{size}".encode())
            with open(fpath, "rb") as f:
                head = f.read(window)
                pieces.append(head)
                if size >= 8:
                    hlen = int.from_bytes(head[:8], "little")
                    if 0 < hlen <= size - 8 and hlen + 8 > window:
                        f.seek(8)
                        pieces.append(f.read(min(hlen, 1 << 24)))
                if size > 2 * window:
                    span = size - 2 * window
                    step = max(min(max(span // n_strides, stride_window),
                                   max_stride),
                               span // 64)
                    pos = window
                    while pos < size - window:
                        f.seek(pos)
                        pieces.append(f.read(stride_window))
                        pos += step
                    f.seek(size - window)
                    pieces.append(f.read(window))
    digest = f"{xxh64_many([b''.join(pieces)])[0]:016x}"
    if sig is not None:
        _DIGEST_CACHE[root_key] = (sig, digest)
    return digest
