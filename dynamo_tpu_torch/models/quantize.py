"""Weight-only quantization of the dense projection stack (W8A16, W4A16).

Port of `dynamo_tpu/models/quantize.py` for one device. The seven
per-layer projections (wq, wk, wv, wo, w_gate, w_up, w_down) and an untied
lm_head become `Q8Weight` ({"q8", "qs"}) or `Q4Weight` ({"q4", "qs4",
"qz4"}) leaves; embeddings and norms stay in the model dtype. The JAX
package returns a new pytree; here the `Transformer` is changed IN PLACE,
leaf by leaf, and each bf16 leaf is released as its quantized form lands
(the analogue of the reference's buffer donation), so a 7B model never
holds two full copies of its weights.
"""

from __future__ import annotations

from typing import Optional

from ..ops.q4_linear import QUANT_LEAVES as Q4_LEAVES
from ..ops.q4_linear import Q4Weight, quantize_weight_q4, repack_q4_leaf
from ..ops.q8_linear import QUANT_LEAVES, Q8Weight, quantize_weight
from .transformer import Transformer


def check_quantizable(config, dtype: str = "int8") -> None:
    if config.is_mla or config.is_gptoss or config.n_experts:
        raise ValueError(
            f"weight_dtype='{dtype}' supports the dense llama/mistral/qwen "
            f"family ({config.name} is MLA/MoE/gpt-oss)")


def quantized_kind(model: Transformer) -> Optional[str]:
    """"int8" or "int4" when the model's projections are quantized leaves,
    None when they are dense."""
    for leaf in model.layers[0].children():
        if isinstance(leaf, Q8Weight):
            return "int8"
        if isinstance(leaf, Q4Weight):
            return "int4"
    return None


def _quantize(model: Transformer, leaves: dict, make_leaf) -> Transformer:
    for layer in model.layers:
        for name in list(layer.keys()):
            if name in leaves:
                w = layer[name]
                layer[name] = make_leaf(w.detach(), leaves[name])
                del w  # the bf16 leaf's last reference
    if model.lm_head is not None:
        w = model.lm_head
        model.set_head(make_leaf(w.detach(), leaves["lm_head"]))
        del w
    return model


def quantize_params_int8(model: Transformer) -> Transformer:
    """Quantize the projections to W8A16 in place; returns the model."""
    check_quantizable(model.config)
    return _quantize(model, QUANT_LEAVES,
                     lambda w, n: Q8Weight(**quantize_weight(w, n)))


def quantize_params_int4(model: Transformer) -> Transformer:
    """Quantize the projections to packed W4A16 in place (layout by
    DYNT_Q4_VARIANT and DYNT_Q4_GROUP); returns the model."""
    check_quantizable(model.config, dtype="int4")
    return _quantize(model, Q4_LEAVES,
                     lambda w, n: Q4Weight(**quantize_weight_q4(w, n)))


def repack_params_q4(model: Transformer,
                     version: Optional[int] = None) -> Transformer:
    """Migrate every int4 leaf whose pack layout differs from the target
    (None = the DYNT_Q4_VARIANT policy) in place; leaves already in the
    target layout stay the same objects. v1 -> v2 -> v1 is bit-exact."""
    def repack(leaf: Q4Weight) -> Q4Weight:
        cur = leaf.leaf()
        new = repack_q4_leaf(cur, version)
        return leaf if new is cur else Q4Weight(**new)

    for layer in model.layers:
        for name in list(layer.keys()):
            leaf = layer[name]
            if isinstance(leaf, Q4Weight):
                new = repack(leaf)
                if new is not leaf:
                    layer[name] = new
    if isinstance(model.lm_head, Q4Weight):
        new = repack(model.lm_head)
        if new is not model.lm_head:
            model.set_head(new)
    return model
