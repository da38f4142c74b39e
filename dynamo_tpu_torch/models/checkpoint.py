"""HF checkpoint directories: config.json and safetensors shards <-> the
port's `Transformer`.

Port of the dense path of `dynamo_tpu/models/checkpoint.py`:

  * `config_from_hf(cfg)` / `config_from_checkpoint(dir)` — HF config.json
    -> ModelConfig, field for field as the reference builds it (MoE, MLA and
    gpt-oss configs parse; `check_supported` then refuses them before any
    shard is read);
  * `build_mapping(config)` — HF tensor names <-> leaves, dense + qk_norm;
  * `ShardReader(dir)` — one file, an index-sharded directory, or a
    directory of shards (`models/safetensors.py` reads the format);
  * `load_params(dir, config)` — the `Transformer`, built on the device
    leaf by leaf: each tensor is mapped, moved to the device, put in the
    reference's layout there and cast to config.dtype, and its map
    dropped, so the process holds one tensor of a 16 GB model in host
    memory at a time;
  * `hf_config_dict(config)` / `save_params(model, config, dir)` — the
    inverse, through the port's writer (one file, or shards with an index).

Shape conventions bridged (HF stores Linear as [out, in]; the layouts are
einsum-ready [in, ...out] with explicit head axes):

    q_proj  [qh*hd, H]  ->  wq [H, qh, hd]
    o_proj  [H, qh*hd]  ->  wo [qh, hd, H]
    gate/up [M, H]      ->  w_gate/w_up [H, M]
    down    [H, M]      ->  w_down [M, H]

Errors are the reference's types and name the file: a missing tensor
raises KeyError, a mis-shaped one ValueError, a file that is not
safetensors `SafetensorsError` (a ValueError). Nothing falls back to random
weights. Not ported yet: the MoE expert stacking, the DeepSeek and gpt-oss
loaders, mxfp4 dequantization and `checkpoint_digest`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Callable, Iterator, Optional

import torch

from ..device import DeviceLike, resolve_device
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
                         "DeepSeek path, which is not ported")
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
    n_bytes = 0
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

        for entry in build_mapping(config):
            if (entry.hf_name == "lm_head.weight"
                    and entry.hf_name not in present):
                # Tied-in-practice checkpoint that omits the head: HF falls
                # back to the embedding — mirror that.
                emb = read("model.embed_tokens.weight",
                           (config.vocab_size, config.hidden))
                leaf = emb.t().contiguous().to(dtype)
            else:
                leaf = entry.to_ours(read(entry.hf_name, entry.shape)
                                     ).to(dtype)
                loaded.add(entry.hf_name)
            n_bytes += leaf.numel() * leaf.element_size()
            _set_path(tree, entry.path, leaf)
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


def hf_config_dict(config: ModelConfig) -> dict:
    """config.json contents for an exported dense checkpoint
    (HF-readable)."""
    if config.is_mla:
        raise NotImplementedError("MLA checkpoints are not ported")
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
    tree = {"embed": model.embed, "final_norm": model.final_norm,
            "lm_head": model.lm_head, "layers": model.layers}
    for entry in build_mapping(config):
        leaf = _get_path(tree, entry.path)
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"{entry.hf_name}: a {type(leaf).__name__} leaf "
                            "cannot be saved (save the dense model)")
        yield entry.hf_name, entry.to_hf(leaf.detach())


def save_params(model: Transformer, config: ModelConfig, path: str, *,
                max_shard_bytes: Optional[int] = None) -> None:
    """Write the model as an HF-style checkpoint directory: config.json,
    and model.safetensors (or, with `max_shard_bytes`, numbered shards and
    model.safetensors.index.json), with HF names. The exact inverse of
    `load_params`. Each tensor is copied to the host once, as it is
    written."""
    check_supported(config)
    os.makedirs(path, exist_ok=True)
    if max_shard_bytes is None:
        save_file(dict(_hf_tensors(model, config)),
                  os.path.join(path, "model.safetensors"))
    else:
        write_shards(_hf_tensors(model, config), path, max_shard_bytes)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(config), f, indent=2)
