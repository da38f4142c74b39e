"""ModelRunner: prefill and decode steps over the paged KV pool.

Port of `dynamo_tpu/engine/model_runner.py` for one device. The runner owns
the weights (`models.Transformer`) and the paged KV pool, and exposes the
host entry points the scheduler drives:

  * prefill_chunk(...) — one sequence's chunk: writes its KV, samples the
                         next token (meaningful on the final chunk)
  * decode(...)        — one token for every slot
  * decode_multi(...)  — K chained decode steps with no host sync: each
                         step's sampled tokens feed the next step on the
                         device (the JAX package's `lax.scan` block)
  * decode_spec(...)   — one speculative verification step: the last
                         committed token plus k drafts scored in one
                         forward, the targets drawn with sequential
                         decode's (seed, step) keys (`sampler.spec_verify`)

Decode attention goes through `ops.paged_attention_decode_pool` and the
spec step's through `ops.paged_attention_spec_pool` (the same whole-pool
kernel with the chunk folded into the GQA group): on the card the CUDA
flash-decode kernel, always; on the CPU its plain version. Both are
swappable (`decode_attention_fn`, `spec_attention_fn`). A caller that
passes `attention_fn` gets the reference's unified path instead: decode
runs the write-then-attend `forward` with it (the T = 1 kernel for
`ops.paged_attention.paged_attention`), it serves prefill too, and
speculation is off (`supports_spec`).
With `weight_dtype` "int8" or "int4" the projections are quantized at init
(leaf by leaf, on the runner's device) and every projection of every
forward goes through `models.transformer.quant_matmul`, the W8A16 / W4A16
kernels on the card. With `kv_dtype` "int8" the pool is an int8
(values, scales) pair and decode attention takes the int8 kernel.
PyTorch runs eagerly, so there is nothing to compile or bucket; the block
table is still cut to the live context width (`bucket_table_width`) so the
plain paths gather no more pages than they need.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import (
    ModelConfig,
    Transformer,
    init_params,
    make_kv_cache,
    make_kv_cache_int8,
)
from ..models.quantize import (
    check_quantizable,
    quantize_params_int4,
    quantize_params_int8,
    quantized_kind,
    repack_params_q4,
)
from ..models.transformer import (
    KV_SCALE_LANES,
    AttentionFn,
    forward,
    forward_decode,
    forward_spec,
    paged_attention_xla,
    quant_matmul,
)
from ..ops.paged_attention import (
    paged_attention_decode_pool,
    paged_attention_spec_pool,
)
from .sampler import sample, sample_with_logprobs, spec_verify

DEFAULT_PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def bucket_table_width(pages_needed: int, max_pages: int) -> int:
    """Power-of-two block-table width covering `pages_needed` (min 8,
    capped at max_pages)."""
    width = 8
    while width < pages_needed:
        width *= 2
    return min(width, max_pages)


@dataclasses.dataclass
class RunnerConfig:
    page_size: int = 16
    num_pages: int = 2048
    max_batch: int = 16
    max_pages_per_seq: int = 128  # => context cap = page_size * this
    # The largest entry is the prefill chunk budget per scheduler step (the
    # JAX package also pads chunks up to these sizes for its compiler).
    prefill_buckets: tuple[int, ...] = DEFAULT_PREFILL_BUCKETS
    # KV pool storage: "model" (the model dtype) | "int8" (int8 codes plus
    # one bf16 scale per token shared by the kv heads): twice the tokens per
    # byte of bf16, read by the int8 decode kernel.
    kv_dtype: str = "model"
    # Weight storage: "model" | "int8" (W8A16: int8 codes + per-output-
    # channel scales) | "int4" (W4A16: packed codes + per-group scale and
    # zero rows, layout by DYNT_Q4_VARIANT). Quantized at init on the device.
    weight_dtype: str = "model"

    @property
    def max_context(self) -> int:
        return self.page_size * self.max_pages_per_seq


class ModelRunner:
    def __init__(
        self,
        model_config: ModelConfig,
        runner_config: RunnerConfig,
        *,
        device: DeviceLike = "cuda",
        params: Optional[Transformer] = None,
        seed: int = 0,
        attention_fn: Optional[AttentionFn] = None,
    ) -> None:
        """`attention_fn` (q, kv, layer, tables, positions, lens), as in the
        reference: supplied, decode runs the unified `forward` with it
        instead of the deferred-write fast path, prefill uses it too, and
        speculation is unsupported."""
        self.device = resolve_device(device)
        self.model_config = model_config
        self.config = runner_config
        if runner_config.weight_dtype not in ("model", "int8", "int4"):
            raise ValueError(
                f"unknown weight_dtype {runner_config.weight_dtype!r} "
                "(expected 'model', 'int8', or 'int4')")
        weight_quantized = runner_config.weight_dtype != "model"
        if weight_quantized:
            check_quantizable(model_config, runner_config.weight_dtype)
        if runner_config.kv_dtype not in ("model", "int8"):
            raise ValueError(f"unknown kv_dtype {runner_config.kv_dtype!r} "
                             "(expected 'model' or 'int8')")
        kv_quantized = runner_config.kv_dtype == "int8"
        if kv_quantized and model_config.head_dim != KV_SCALE_LANES:
            # As the reference: its int8 kernel covers head_dim 128 only,
            # and the port does not run a plain decode path in its place.
            raise ValueError(
                f"int8 KV requires head_dim == {KV_SCALE_LANES} (model has "
                f"{model_config.head_dim})")
        if params is None:
            params = init_params(model_config, device=self.device, seed=seed)
        elif params.embed.device != self.device:
            raise ValueError(f"params live on {params.embed.device}, runner "
                             f"on {self.device}")
        kind = quantized_kind(params)
        if kind is not None and kind != runner_config.weight_dtype:
            raise ValueError(
                f"params are already quantized as {kind!r} but this runner "
                f"wants weight_dtype={runner_config.weight_dtype!r}")
        if weight_quantized and kind is None:
            # leaf by leaf, each bf16 leaf freed as its quantized form lands
            if runner_config.weight_dtype == "int4":
                quantize_params_int4(params)
            else:
                quantize_params_int8(params)
        elif kind == "int4":
            repack_params_q4(params)  # transparent v1 <-> v2 migration
        self.model = params
        if kv_quantized:
            self.kv_cache = make_kv_cache_int8(
                model_config, runner_config.num_pages,
                runner_config.page_size, device=self.device)
        else:
            self.kv_cache = make_kv_cache(
                model_config, runner_config.num_pages,
                runner_config.page_size, device=self.device)
        # The caller's unified attention (None: the deferred-write decode).
        self.attention_fn = attention_fn
        # The decode and spec attentions and the quantized matmul: the CUDA
        # kernels on the card, their plain versions on the CPU. A caller may
        # swap in other functions with the same signatures (chip_smoke.py's
        # parity phases pass the plain versions and the drop-ins).
        self.decode_attention_fn = paged_attention_decode_pool
        self.spec_attention_fn = paged_attention_spec_pool
        self.matmul_fn = quant_matmul
        # Decode, spec and prefill forwards run: on the card each decode or
        # spec forward launches its attention kernel once per layer, and
        # every forward of a quantized model launches its matmul kernel
        # once per projection.
        self.decode_steps = 0
        self.spec_steps = 0
        self.prefill_steps = 0
        self.last_prefill_sample = None
        self.last_decode_sample = (None, None, None)
        self.last_decode_logits = None
        self.last_spec_logits = None

    # -- helpers -----------------------------------------------------------

    @property
    def max_prefill_chunk(self) -> int:
        return self.config.prefill_buckets[-1]

    @property
    def supports_spec(self) -> bool:
        """Whether this runner runs speculative verification. A caller's
        `attention_fn` turns it off, as in the reference: sequential decode
        then runs the injected attention, and targets drawn from another
        attention would diverge from the non-speculative stream."""
        return self.attention_fn is None

    def _t(self, x, dtype: torch.dtype) -> torch.Tensor:
        """Host array (or device tensor) -> tensor on the runner's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=self.device, dtype=dtype)

    def _sampling(self, temperature, top_p, top_k, seeds):
        return (self._t(np.asarray(temperature, np.float32), torch.float32),
                self._t(np.asarray(top_p, np.float32), torch.float32),
                self._t(np.asarray(top_k, np.int64), torch.int64),
                self._t(np.asarray(seeds, np.int64), torch.int64))

    # -- host API ----------------------------------------------------------

    @torch.inference_mode()
    def prefill_chunk(
        self,
        tokens: np.ndarray,  # [t] chunk token ids
        start_pos: int,  # absolute position of tokens[0]
        block_table: np.ndarray,  # [max_pages_per_seq] int32
        kv_len_after: int,
        sampling: tuple[float, float, int, int],  # (temp, top_p, top_k, seed)
        return_device: bool = False,
    ):
        """Run one prefill chunk; returns the sampled token id (meaningful
        only on the final chunk). `return_device=True` returns the device
        token tensor [1] without a host sync. Otherwise the logprob data
        lands in `last_prefill_sample`."""
        t = len(tokens)
        pages = -(-kv_len_after // self.config.page_size)
        table = self._t(np.asarray(block_table, np.int32)[None, :pages],
                        torch.int32)
        tok = self._t(np.asarray(tokens, np.int64)[None, :], torch.int64)
        pos = torch.arange(start_pos, start_pos + t, device=self.device)[None, :]
        self.prefill_steps += 1
        logits = forward(self.model, tok, pos, self.kv_cache, table,
                         self._t(np.asarray([kv_len_after], np.int32),
                                 torch.int32),
                         attention_fn=self.attention_fn or paged_attention_xla,
                         matmul_fn=self.matmul_fn)
        temp, top_p, top_k, seed = sampling
        token, lp, top_ids, top_lps = sample_with_logprobs(
            logits[:, -1, :], *self._sampling([temp], [top_p], [top_k],
                                              [seed]), 0)
        if return_device:
            self.last_prefill_sample = None
            return token
        self.last_prefill_sample = (float(lp.cpu()[0]), top_ids.cpu().numpy()[0],
                                    top_lps.cpu().numpy()[0])
        return int(token.cpu()[0])

    def _decode_forward(self, toks, pos, tables, lens, act) -> torch.Tensor:
        """One decode forward, logits [B, 1, V]: the deferred-write fast
        path, or the unified write-then-attend `forward` when the caller
        supplied `attention_fn` (inactive slots write to scratch page 0)."""
        if self.attention_fn is not None:
            return forward(self.model, toks[:, None], pos[:, None],
                           self.kv_cache, tables, lens, valid=act[:, None],
                           attention_fn=self.attention_fn,
                           matmul_fn=self.matmul_fn)
        return forward_decode(self.model, toks, pos, self.kv_cache, tables,
                              lens, act,
                              decode_attention_fn=self.decode_attention_fn,
                              matmul_fn=self.matmul_fn)

    def _decode_inputs(self, positions, block_tables, kv_lens, active):
        return (self._t(np.asarray(positions, np.int64), torch.int64),
                self._t(np.asarray(block_tables, np.int32), torch.int32),
                self._t(np.asarray(kv_lens, np.int32), torch.int32),
                self._t(np.asarray(active, bool), torch.bool))

    @torch.inference_mode()
    def decode(
        self,
        tokens: np.ndarray,  # [B] last token per slot
        positions: np.ndarray,  # [B]
        block_tables: np.ndarray,  # [B, width]
        kv_lens: np.ndarray,  # [B] INCLUDING the current token
        active: np.ndarray,  # [B] bool
        temperature: np.ndarray,
        top_p: np.ndarray,
        top_k: np.ndarray,
        seeds: np.ndarray,
        steps: Optional[np.ndarray] = None,  # [B] per-slot token index
        want_logprobs: bool = False,
        want_logits: bool = False,
    ) -> np.ndarray:
        """One decode step for all slots; returns sampled tokens [B] on the
        host. `want_logprobs` fills `last_decode_sample`; `want_logits`
        fills `last_decode_logits` with the raw [B, V] rows."""
        self.decode_steps += 1
        if steps is None:
            steps = np.zeros(len(tokens), np.int32)
        pos, tables, lens, act = self._decode_inputs(positions, block_tables,
                                                     kv_lens, active)
        logits = self._decode_forward(
            self._t(np.asarray(tokens, np.int64), torch.int64), pos, tables,
            lens, act)[:, 0, :]
        samp = self._sampling(temperature, top_p, top_k, seeds)
        step_t = self._t(np.asarray(steps, np.int64), torch.int64)
        if want_logprobs:
            next_tokens, lp, top_ids, top_lps = sample_with_logprobs(
                logits, *samp, step_t)
            self.last_decode_sample = (lp.cpu().numpy(),
                                       top_ids.cpu().numpy(),
                                       top_lps.cpu().numpy())
        else:
            next_tokens = sample(logits, *samp, step_t)
            self.last_decode_sample = (None, None, None)
        self.last_decode_logits = logits.cpu().numpy() if want_logits else None
        return next_tokens.cpu().numpy()

    @torch.inference_mode()
    def decode_multi(
        self,
        tokens,  # [B] last token per slot: host array or device tensor
        positions: np.ndarray,  # [B] position of that token
        block_tables: np.ndarray,
        kv_lens: np.ndarray,  # [B] INCLUDING the current token
        active: np.ndarray,
        temperature: np.ndarray,
        top_p: np.ndarray,
        top_k: np.ndarray,
        seeds: np.ndarray,
        steps: Optional[np.ndarray] = None,
        k: int = 8,
        return_device: bool = False,
    ):
        """K chained decode steps with no host sync; returns tokens [K, B].
        Callers guarantee every active slot has >= k tokens of page budget
        left. `return_device=True` returns the device tensor, so the
        scheduler can feed `toks[-1]` into the next block before reading
        this one back; otherwise the block is copied to the host once."""
        self.decode_steps += k
        if steps is None:
            steps = np.zeros(len(positions), np.int32)
        pos, tables, lens, act = self._decode_inputs(positions, block_tables,
                                                     kv_lens, active)
        samp = self._sampling(temperature, top_p, top_k, seeds)
        toks = self._t(tokens if isinstance(tokens, torch.Tensor)
                       else np.asarray(tokens, np.int64), torch.int64)
        sidx = self._t(np.asarray(steps, np.int64), torch.int64)
        grow = act.to(lens.dtype)  # inactive slots keep zero history
        out = []
        for _ in range(k):
            logits = self._decode_forward(toks, pos, tables, lens, act)
            nxt = sample(logits[:, 0, :], *samp, sidx)
            out.append(nxt)
            toks = nxt.long()
            pos, lens, sidx = pos + 1, lens + grow, sidx + 1
        toks_k = torch.stack(out)  # [K, B] int32
        self.last_decode_sample = (None, None, None)
        if return_device:
            return toks_k
        return toks_k.cpu().numpy()

    @torch.inference_mode()
    def decode_spec(
        self,
        tokens: np.ndarray,  # [B] last committed token per slot
        drafts: np.ndarray,  # [B, K] proposed continuations (0-padded)
        positions: np.ndarray,  # [B] position of the committed token
        block_tables: np.ndarray,
        kv_lens: np.ndarray,  # [B] committed length INCLUDING the token
        active: np.ndarray,
        temperature: np.ndarray,
        top_p: np.ndarray,
        top_k: np.ndarray,
        seeds: np.ndarray,
        steps: Optional[np.ndarray] = None,
        want_logits: bool = False,
        return_device: bool = False,
    ):
        """One speculative verification step. Returns (targets [B, K+1],
        n_accept [B]); callers commit targets[b, : n_accept[b] + 1], the
        tokens K+1 sequential decode steps would sample for the accepted
        prefix. `want_logits` fills `last_spec_logits` with the raw
        [B, K+1, V] rows; `return_device=True` skips the readback (the
        scheduler drains after overlapping prefill and admission)."""
        b, k = np.shape(drafts)
        t = k + 1
        self.spec_steps += 1
        if steps is None:
            steps = np.zeros(b, np.int32)
        pos, tables, lens, act = self._decode_inputs(positions, block_tables,
                                                     kv_lens, active)
        chunk = self._t(np.concatenate(
            [np.asarray(tokens, np.int64)[:, None],
             np.asarray(drafts, np.int64)], axis=1), torch.int64)
        pos2 = pos[:, None] + torch.arange(t, device=self.device)[None, :]
        logits = forward_spec(self.model, chunk, pos2, self.kv_cache, tables,
                              lens, act,
                              spec_attention_fn=self.spec_attention_fn,
                              matmul_fn=self.matmul_fn)
        targets, n_accept = spec_verify(
            logits, chunk[:, 1:], *self._sampling(temperature, top_p, top_k,
                                                  seeds),
            self._t(np.asarray(steps, np.int64), torch.int64))
        self.last_spec_logits = logits.cpu().numpy() if want_logits else None
        if return_device:
            return targets, n_accept
        return targets.cpu().numpy(), n_accept.cpu().numpy()

    def warmup(self) -> None:
        """One decode step and one tiny prefill (on the card this builds the
        decode kernel and initializes the math libraries before traffic)."""
        b = self.config.max_batch
        p = self.config.max_pages_per_seq
        self.decode(
            np.zeros(b, np.int32), np.zeros(b, np.int32),
            np.zeros((b, p), np.int32), np.zeros(b, np.int32),
            np.zeros(b, bool), np.ones(b, np.float32),
            np.ones(b, np.float32), np.zeros(b, np.int32),
            np.zeros(b, np.uint32),
        )
        self.prefill_chunk(
            np.zeros(1, np.int32), 0, np.zeros(p, np.int32), 1,
            (0.0, 1.0, 0, 0),
        )
