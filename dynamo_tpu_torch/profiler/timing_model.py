"""Analytical roofline model of one model on one device.

Port of `param_count`, `kv_bytes_per_token` and `TimingModel` in
`dynamo_tpu/profiler/timing_model.py` (the rapid sweeps are not ported).
The standard two-roofline picture:

  prefill - compute-bound: ttft = flops / (mfu * peak_flops), flops = 2 *
            params * isl + an attention term 4 * isl^2 * d_model per layer;
            throughput per device = isl / ttft.
  decode  - memory-bound: every step streams all weights plus the active KV
            working set; itl = bytes / (eff * bw); throughput per device =
            batch / itl.

Both use the geometry of `models.config.ModelConfig` and divide weight and
KV bytes by the devices of a replica.
"""

from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig
from .chips import ChipSpec


def param_count(cfg: ModelConfig) -> int:
    h = cfg.hidden
    per_layer = (
        h * cfg.n_q_heads * cfg.head_dim
        + 2 * h * cfg.n_kv_heads * cfg.head_dim
        + cfg.n_q_heads * cfg.head_dim * h
        + 3 * h * cfg.mlp_hidden
        + 2 * h
    )
    total = cfg.vocab_size * h + h + cfg.n_layers * per_layer
    if not cfg.tie_embeddings:
        total += h * cfg.vocab_size
    return total


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * dtype_bytes


@dataclasses.dataclass
class TimingModel:
    model: ModelConfig
    chip: ChipSpec
    num_chips: int = 1  # devices per replica (TP)
    mfu: float = 0.5  # achieved fraction of peak flops in prefill
    hbm_eff: float = 0.75  # achieved fraction of memory bandwidth in decode
    dtype_bytes: int = 2

    def prefill_ttft_ms(self, isl: float) -> float:
        p = param_count(self.model)
        flops = 2.0 * p * isl + (
            4.0 * isl * isl * self.model.n_layers
            * self.model.n_q_heads * self.model.head_dim)
        peak = self.chip.bf16_tflops * 1e12 * self.mfu * self.num_chips
        return flops / peak * 1e3

    def prefill_thpt_per_chip(self, isl: float) -> float:
        ttft_s = self.prefill_ttft_ms(isl) / 1e3
        return isl / ttft_s / self.num_chips if ttft_s > 0 else 0.0

    def decode_itl_ms(self, batch: float, context: float) -> float:
        p_bytes = param_count(self.model) * self.dtype_bytes
        kv = batch * context * kv_bytes_per_token(self.model,
                                                  self.dtype_bytes)
        bw = self.chip.hbm_gbps * 1e9 * self.hbm_eff * self.num_chips
        return (p_bytes + kv) / bw * 1e3

    def decode_thpt_per_chip(self, batch: float, context: float) -> float:
        itl_s = self.decode_itl_ms(batch, context) / 1e3
        return batch / itl_s / self.num_chips if itl_s > 0 else 0.0

    def max_kv_tokens(self, weight_fraction_free: float = 0.9) -> int:
        hbm = self.chip.hbm_gib * (1 << 30) * self.num_chips
        p_bytes = param_count(self.model) * self.dtype_bytes
        free = max(0.0, hbm * weight_fraction_free - p_bytes)
        return int(free // kv_bytes_per_token(self.model, self.dtype_bytes))
