"""ModelRunner: prefill and decode steps over the paged KV pool.

Port of `dynamo_tpu/engine/model_runner.py` for one device. The runner owns
the weights (`models.Transformer`) and the paged KV pool, and exposes the
host entry points the scheduler drives:

  * prefill_chunk(...) — one sequence's chunk: writes its KV, samples the
                         next token (meaningful on the final chunk)
  * prefill_chunk_batch(...) — several sequences' chunks in one forward
                         per group that fits the largest bucket
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

Prefill runs as the reference runs it: every chunk is padded to its
`prefill_buckets` size (padding tokens write to scratch page 0), the whole
`max_pages_per_seq` block table is passed, and only each row's last token
goes through the final norm and the head before it is sampled. Several
sequences' chunks share one forward (`prefill_chunk_batch`), the batch
padded to a power of two B; a group runs only where B x bucket <= the
largest bucket, so a longer work list is split into groups in work order
(the reference does not split; the sampler keys on (seed, step), never on
the row, so each row's result is the same under any grouping).

With `RunnerConfig.cuda_graphs` (the default) each `decode`, `decode_multi`,
`decode_spec` and prefill call is one CUDA-graph replay per group
(`engine/step_graphs.py`), keyed as the reference keys its jit calls plus
what a graph bakes in: the batch, the block table's width
(`bucket_table_width`; prefill's is always `max_pages_per_seq`),
`want_logprobs` / k / t / the prefill bucket, and the functions the step
calls. A key is captured at its first use; `prewarm` captures the whole
steady-state key space up front. The logits-processor variants
(`decode(want_logits=True)`, `decode_spec(want_logits=True)`) are keys of
their own ("decode_logits", "decode_spec_logits") with the raw [B, V] /
[B, K+1, V] logits as one more output; only the rows of the slots the
caller names are indexed out on the device and copied to the host, through
pinned memory. With `cuda_graphs` off every step runs the same function op
by op.

Page I/O for KV transfers (disaggregated prefill and drain handoffs,
`llm/kv_transfer.py`): `gather_pages_device` gathers pages into a fresh
bundle on the scheduler thread, on the stream the graphs replay on, and
`bundle_to_host` copies it out on a side stream behind its event, off that
thread; `stage_bundle` uploads a pulled bundle the same way, and
`scatter_pages` waits on it and writes in place (the graphs captured the
pool's storage); `kv_layout` is the reference's wire descriptor.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import env
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
from ..ops.block_copy import (
    gather_kv_blocks,
    gather_kv_blocks_q8,
    scatter_from_host,
    scatter_from_host_q8,
)
from ..ops.paged_attention import (
    paged_attention_decode_pool,
    paged_attention_spec_pool,
)
from .sampler import sample, sample_with_logprobs, spec_verify
from .step_graphs import NUMPY_DTYPES, Step, StepGraph

DEFAULT_PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def bucket_table_width(pages_needed: int, max_pages: int) -> int:
    """Power-of-two block-table width covering `pages_needed` (min 8,
    capped at max_pages)."""
    width = 8
    while width < pages_needed:
        width *= 2
    return min(width, max_pages)


def table_widths(max_pages: int) -> list[int]:
    """Every width `bucket_table_width` gives for a table of `max_pages`."""
    return sorted({bucket_table_width(n, max_pages)
                   for n in range(1, max_pages + 1)})


# The dtype of each input of a step, as the step sees it (prefill's tokens,
# positions and valid are [B, T]; its last_idx [B] is each row's last token).
STEP_INPUTS = {
    "tokens": torch.int64, "positions": torch.int64, "tables": torch.int32,
    "lens": torch.int32, "active": torch.bool, "temperature": torch.float32,
    "top_p": torch.float32, "top_k": torch.int64, "seeds": torch.int64,
    "steps": torch.int64, "drafts": torch.int64, "valid": torch.bool,
    "last_idx": torch.int64,
}


@dataclasses.dataclass
class DeviceBundle:
    """Pages in the universal layout on the runner's device, and the event
    that marks the end of the work that produced them (None on the CPU)."""

    tensor: torch.Tensor
    ready: Optional["torch.cuda.Event"] = None


def _pow2(n: int) -> int:
    """The smallest power of two >= n (n >= 1)."""
    return 1 << max(0, n - 1).bit_length()


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
    # Decode, decode_multi, decode_spec and prefill as one CUDA-graph replay
    # each (captured per key at first use); False runs them op by op.
    cuda_graphs: bool = True

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
        elif params.embed.device != torch.empty(0, device=self.device).device:
            # (compared as placed: a bare "cuda" names the current card)
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
        self._kv_quantized = kv_quantized
        # The side stream of the page I/O's copies (created at first use)
        self._copy_stream = None
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
        # Decode, spec and prefill forwards run (a batched prefill group is
        # one): on the card each decode or spec forward launches its
        # attention kernel once per layer, and every forward of a quantized
        # model launches its matmul kernel once per projection.
        self.decode_steps = 0
        self.spec_steps = 0
        self.prefill_steps = 0
        # The step graphs by key (`_run_step`), sharing one memory pool and
        # one capture stream. Captures, replays and the seconds captures
        # took; the eager forwards a capture ran before capturing (they
        # launch kernels; not in decode_steps / spec_steps); forwards that
        # ran eagerly (cuda_graphs off).
        self.step_graphs: dict[tuple, StepGraph] = {}
        self._graph_pool = None
        self._capture_stream = None
        self.graph_captures = 0
        self.graph_replays = 0
        self.graph_capture_s = 0.0
        self.graph_warm_forwards = {"decode": 0, "spec": 0, "prefill": 0}
        self.eager_forwards = {"decode": 0, "spec": 0, "prefill": 0}
        self.last_prefill_sample = None
        self.last_prefill_samples: list = []
        self.last_prefill_logits = None
        self.last_decode_sample = (None, None, None)
        self.last_decode_logits = None
        self.last_spec_logits = None
        # Logits-processor readbacks: steps that copied logits rows to the
        # host, and the bytes they copied.
        self.logits_reads = 0
        self.logits_bytes_read = 0

    # -- helpers -----------------------------------------------------------

    @property
    def max_prefill_chunk(self) -> int:
        return self.config.prefill_buckets[-1]

    def _bucket_for(self, n: int) -> int:
        """The smallest prefill bucket >= n, else the largest."""
        for b in self.config.prefill_buckets:
            if n <= b:
                return b
        return self.config.prefill_buckets[-1]

    def prefill_groups(self, lengths: Sequence[int]) -> list[list[int]]:
        """Split a prefill work list (chunk lengths, in work order) into
        groups of row indices, each run as one forward: a group grows while
        its padded batch times its bucket stays within the largest bucket,
        which bounds both the key space and the largest step."""
        groups: list[list[int]] = []
        longest = 0
        for i, n in enumerate(lengths):
            if groups and (_pow2(len(groups[-1]) + 1)
                           * self._bucket_for(max(longest, n))
                           <= self.max_prefill_chunk):
                groups[-1].append(i)
                longest = max(longest, n)
            else:
                groups.append([i])
                longest = n
        return groups

    def prefill_keys(self) -> list[tuple[int, int]]:
        """Every (padded batch, bucket) a prefill group can take: batches
        up to max_batch rounded to a power of two, B x bucket within the
        largest bucket."""
        cap = self.max_prefill_chunk
        batches = [1 << i for i in range(
            _pow2(self.config.max_batch).bit_length())]
        return [(b, bucket) for bucket in self.config.prefill_buckets
                for b in batches if b * bucket <= cap]

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

    # -- host API ----------------------------------------------------------

    @torch.inference_mode()
    def prefill_chunk(
        self,
        tokens: np.ndarray,  # [t] chunk token ids
        start_pos: int,  # absolute position of tokens[0]
        block_table: np.ndarray,  # [<= max_pages_per_seq] int32
        kv_len_after: int,
        sampling: tuple[float, float, int, int],  # (temp, top_p, top_k, seed)
        return_device: bool = False,
        want_logits: bool = False,
    ):
        """Run one prefill chunk, padded to its bucket; returns the sampled
        token id (meaningful only on the final chunk). `return_device=True`
        returns the device token tensor [1] without a host sync (a clone, so
        a later replay of the same key leaves it alone). Otherwise the
        logprob data lands in `last_prefill_sample`. `want_logits` also
        fills `last_prefill_logits` with the raw last-row logits [V] (a key
        of its own, "prefill_logits")."""
        outs = self._prefill_group(
            [(tokens, start_pos, block_table, kv_len_after, sampling)],
            want_logits)
        token, lp, top_ids, top_lps = outs[:4]
        self.last_prefill_logits = (outs[4][0].cpu().numpy() if want_logits
                                    else None)
        if return_device:
            self.last_prefill_sample = None
            return token
        self.last_prefill_sample = (float(lp.cpu()[0]),
                                    top_ids.cpu().numpy()[0],
                                    top_lps.cpu().numpy()[0])
        return int(token.cpu()[0])

    @torch.inference_mode()
    def prefill_chunk_batch(self, rows: list, want_samples: bool = False):
        """Several sequences' prefill chunks, rows of (tokens, start_pos,
        block_table, kv_len_after, sampling) as `prefill_chunk` takes them:
        one forward per group of `prefill_groups`. Returns the device tokens
        with row i = rows[i]: one group's [B_padded] tensor as it came out
        of the step, or the groups' rows concatenated. `want_samples=True`
        fills `last_prefill_samples` with each row's (logprob, top_ids,
        top_logprobs), a host sync; otherwise it holds None per row."""
        groups = self.prefill_groups([len(r[0]) for r in rows])
        outs = [self._prefill_group([rows[i] for i in g]) for g in groups]
        if len(groups) == 1:
            tokens = outs[0][0]
        else:
            tokens = torch.cat([o[0][:len(g)] for o, g in zip(outs, groups)])
        if want_samples:
            samples = []
            for o, g in zip(outs, groups):
                lp, ids, lps = (t.cpu().numpy() for t in o[1:4])
                samples += [(float(lp[j]), ids[j], lps[j])
                            for j in range(len(g))]
            self.last_prefill_samples = samples
        else:
            self.last_prefill_samples = [None] * len(rows)
        return tokens

    def _prefill_group(self, rows: list, want_logits: bool = False) -> tuple:
        """One prefill forward over `rows`, padded to (power-of-two B, the
        bucket of the longest chunk) and to the full table width (a shorter
        table is padded with page 0): padding tokens and rows write to
        scratch page 0 (valid False; padding rows have a zero table and
        kv_len 0). Returns the step's cloned outputs (tokens [B], logprob
        [B], top ids and logprobs [B, K], and with `want_logits` the
        last-row logits [B, V])."""
        n = len(rows)
        b = _pow2(n)
        longest = max(len(r[0]) for r in rows)
        bucket = self._bucket_for(longest)
        if longest > bucket or b * bucket > self.max_prefill_chunk:
            raise ValueError(
                f"prefill group of {n} rows up to {longest} tokens exceeds "
                f"the largest bucket {self.max_prefill_chunk}")
        p = self.config.max_pages_per_seq
        values = {
            "tokens": np.zeros((b, bucket), np.int64),
            "positions": np.zeros((b, bucket), np.int64),
            "valid": np.zeros((b, bucket), bool),
            "tables": np.zeros((b, p), np.int32),
            "lens": np.zeros(b, np.int32),
            "last_idx": np.zeros(b, np.int64),
            "temperature": np.zeros(b, np.float32),
            "top_p": np.ones(b, np.float32),
            "top_k": np.zeros(b, np.int64),
            "seeds": np.zeros(b, np.int64),
        }
        for i, (tokens, start, table, kv_after, sampling) in enumerate(rows):
            t = len(tokens)
            values["tokens"][i, :t] = tokens
            values["positions"][i, :t] = np.arange(start, start + t)
            values["valid"][i, :t] = True
            values["tables"][i, :len(table)] = table
            values["lens"][i] = kv_after
            values["last_idx"][i] = t - 1
            (values["temperature"][i], values["top_p"][i], values["top_k"][i],
             values["seeds"][i]) = sampling
        self.prefill_steps += 1
        attention_fn = self.attention_fn or paged_attention_xla
        model, kv, matmul_fn = self.model, self.kv_cache, self.matmul_fn

        def step(x):
            logits = forward(model, x["tokens"], x["positions"], kv,
                             x["tables"], x["lens"], valid=x["valid"],
                             attention_fn=attention_fn, matmul_fn=matmul_fn,
                             last_idx=x["last_idx"])[:, 0, :]
            out = sample_with_logprobs(
                logits, x["temperature"], x["top_p"], x["top_k"], x["seeds"],
                torch.zeros_like(x["seeds"]))
            return out + ((logits,) if want_logits else ())

        return self._run_step("prefill_logits" if want_logits else "prefill",
                              bucket, 1, step, values)

    # -- decode-kind steps ---------------------------------------------------

    def _functions(self) -> tuple:
        """The functions a step may call: part of every graph key, since a
        graph keeps the functions it was captured with."""
        return (self.attention_fn, self.decode_attention_fn,
                self.spec_attention_fn, self.matmul_fn)

    def _decode_forward_fn(self):
        """One decode forward, logits [B, 1, V], over the runner's current
        functions: the deferred-write fast path, or the unified
        write-then-attend `forward` when the caller supplied `attention_fn`
        (inactive slots write to scratch page 0)."""
        attention_fn, decode_fn, _, matmul_fn = self._functions()
        model, kv = self.model, self.kv_cache

        def fwd(toks, pos, tables, lens, act):
            if attention_fn is not None:
                return forward(model, toks[:, None], pos[:, None], kv, tables,
                               lens, valid=act[:, None],
                               attention_fn=attention_fn, matmul_fn=matmul_fn)
            return forward_decode(model, toks, pos, kv, tables, lens, act,
                                  decode_attention_fn=decode_fn,
                                  matmul_fn=matmul_fn)
        return fwd

    def _step_values(self, tokens, positions, block_tables, kv_lens, active,
                     temperature, top_p, top_k, seeds, steps) -> dict:
        if steps is None:
            steps = np.zeros(len(positions), np.int32)
        return {"tokens": tokens, "positions": positions,
                "tables": block_tables, "lens": kv_lens, "active": active,
                "temperature": temperature, "top_p": top_p, "top_k": top_k,
                "seeds": seeds, "steps": steps}

    def _run_step(self, method: str, variant, forwards: int, step: Step,
                  values: dict, clone: bool = True) -> tuple:
        """Run `step` over `values` (host arrays or device tensors, by
        `STEP_INPUTS` name): replay the graph of key (method, batch, table
        width, variant, functions), capturing it first if it is new, or run
        eagerly when `cuda_graphs` is off.
        `forwards` is the number of model forwards the step runs. With
        `clone=False` a replay returns the graph's static outputs, valid
        until the key's next replay. A capture that fails raises; nothing
        falls back to eager."""
        kind = {"decode_spec": "spec", "decode_spec_logits": "spec",
                "prefill": "prefill",
                "prefill_logits": "prefill"}.get(method, "decode")
        if not self.config.cuda_graphs:
            self.eager_forwards[kind] += forwards
            return step({name: self._t(
                value if isinstance(value, torch.Tensor)
                else np.asarray(value, NUMPY_DTYPES[STEP_INPUTS[name]]),
                STEP_INPUTS[name]) for name, value in values.items()})
        b, width = _shape(values["tables"])
        key = (method, b, width, variant, self._functions())
        graph = self.step_graphs.get(key)
        if graph is None:
            graph = self._capture(step, values)
            self.step_graphs[key] = graph
            self.graph_warm_forwards[kind] += forwards
        self.graph_replays += 1
        return graph.run(values, clone=clone)

    def _capture(self, step: Step, values: dict) -> StepGraph:
        """A new key's graph over neutral static inputs (every slot
        inactive, lengths and tables 0; top_p 1)."""
        inputs = {name: (torch.ones if name == "top_p" else torch.zeros)(
            _shape(value), dtype=STEP_INPUTS[name], device=self.device)
            for name, value in values.items()}
        graph = StepGraph(step, inputs)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
            graph.capture(self._graph_pool, self._capture_stream)
        else:
            graph.capture()
        graph.capture_s = time.perf_counter() - t0
        self.graph_capture_s += graph.capture_s
        self.graph_captures += 1
        return graph

    def graph_memory_bytes(self) -> int:
        """Device memory the step graphs' shared pool holds (its
        segments, free blocks included; 0 before the first capture and on
        the CPU)."""
        if self._graph_pool is None:
            return 0
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def _logits_rows(self, logits: torch.Tensor,
                     slots: Optional[Sequence[int]]) -> torch.Tensor:
        """The logits rows of `slots` (all rows when None) as a host tensor:
        indexed on the device, so only those rows cross, then one copy into
        pinned memory. On the card the copy is asynchronous: the host tensor
        is ready after the next synchronizing readback on the same stream
        (each caller reads its tokens back right after)."""
        if slots is not None:
            idx = torch.from_numpy(np.asarray(slots, np.int64))
            if logits.is_cuda:  # pinned: the index copy does not sync
                idx = idx.pin_memory().to(logits.device, non_blocking=True)
            logits = logits.index_select(0, idx)
        self.logits_reads += 1
        self.logits_bytes_read += logits.numel() * logits.element_size()
        if logits.device.type != "cuda":
            return logits.clone()
        host = torch.empty(logits.shape, dtype=logits.dtype,
                           pin_memory=True)
        host.copy_(logits, non_blocking=True)
        return host

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
        logits_slots: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """One decode step for all slots; returns sampled tokens [B] on the
        host. `want_logprobs` fills `last_decode_sample`. `want_logits`
        selects the logits-processor variant (key "decode_logits"): it
        fills `last_decode_logits` with the raw logits rows of
        `logits_slots`, in that order ([len(slots), V]; every slot's row
        when None), and overrides `want_logprobs` as in the reference (the
        scheduler derives logprob data on the host from the raw rows)."""
        self.decode_steps += 1
        fwd = self._decode_forward_fn()
        want_logprobs = want_logprobs and not want_logits

        def step(x):
            logits = fwd(x["tokens"], x["positions"], x["tables"], x["lens"],
                         x["active"])[:, 0, :]
            samp = (x["temperature"], x["top_p"], x["top_k"], x["seeds"],
                    x["steps"])
            out = (sample_with_logprobs(logits, *samp) if want_logprobs
                   else (sample(logits, *samp),))
            return out + ((logits,) if want_logits else ())

        values = self._step_values(tokens, positions, block_tables, kv_lens,
                                   active, temperature, top_p, top_k, seeds,
                                   steps)
        if want_logits:
            # Static outputs, no clone: only the asked rows leave the graph.
            out = self._run_step("decode_logits", None, 1, step, values,
                                 clone=False)
            rows = self._logits_rows(out[1], logits_slots)
            next_tokens = out[0].cpu().numpy()  # syncs: `rows` has landed
            self.last_decode_sample = (None, None, None)
            self.last_decode_logits = rows.numpy()
            return next_tokens
        out = self._run_step("decode", want_logprobs, 1, step, values)
        self.last_decode_sample = (tuple(t.cpu().numpy() for t in out[1:4])
                                   if want_logprobs else (None, None, None))
        self.last_decode_logits = None
        return out[0].cpu().numpy()

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
        fwd = self._decode_forward_fn()

        def step(x):
            toks, pos, lens, sidx = (x["tokens"], x["positions"], x["lens"],
                                     x["steps"])
            tables, act = x["tables"], x["active"]
            samp = (x["temperature"], x["top_p"], x["top_k"], x["seeds"])
            grow = act.to(lens.dtype)  # inactive slots keep zero history
            out = []
            for _ in range(k):
                nxt = sample(fwd(toks, pos, tables, lens, act)[:, 0, :],
                             *samp, sidx)
                out.append(nxt)
                toks = nxt.long()
                pos, lens, sidx = pos + 1, lens + grow, sidx + 1
            return (torch.stack(out),)  # [K, B] int32

        (toks_k,) = self._run_step(
            "decode_multi", k, k, step,
            self._step_values(tokens, positions, block_tables, kv_lens,
                              active, temperature, top_p, top_k, seeds, steps))
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
        logits_slots: Optional[Sequence[int]] = None,
    ):
        """One speculative verification step. Returns (targets [B, K+1],
        n_accept [B]); callers commit targets[b, : n_accept[b] + 1], the
        tokens K+1 sequential decode steps would sample for the accepted
        prefix. `want_logits` selects the key "decode_spec_logits" and fills
        `last_spec_logits` with the raw [len(slots), K+1, V] rows of
        `logits_slots` (every slot's when None). `return_device=True` skips
        the readback (the scheduler drains after overlapping prefill and
        admission); `last_spec_logits` is then a host tensor, ready once the
        targets have been read back."""
        t = _shape(drafts)[1] + 1
        self.spec_steps += 1
        model, kv = self.model, self.kv_cache
        _, _, spec_fn, matmul_fn = self._functions()

        def step(x):
            chunk = torch.cat([x["tokens"][:, None], x["drafts"]], dim=1)
            pos = (x["positions"][:, None]
                   + torch.arange(t, device=chunk.device)[None, :])
            logits = forward_spec(model, chunk, pos, kv, x["tables"],
                                  x["lens"], x["active"],
                                  spec_attention_fn=spec_fn,
                                  matmul_fn=matmul_fn)
            targets, n_accept = spec_verify(
                logits, chunk[:, 1:], x["temperature"], x["top_p"],
                x["top_k"], x["seeds"], x["steps"])
            return (targets, n_accept) + ((logits,) if want_logits else ())

        values = self._step_values(tokens, positions, block_tables, kv_lens,
                                   active, temperature, top_p, top_k, seeds,
                                   steps)
        values["drafts"] = drafts
        if want_logits:
            # Static outputs: the targets are cloned, the logits indexed to
            # the asked rows before they leave the graph.
            out = self._run_step("decode_spec_logits", t, 1, step, values,
                                 clone=False)
            targets, n_accept = out[0].clone(), out[1].clone()
            self.last_spec_logits = self._logits_rows(out[2], logits_slots)
        else:
            targets, n_accept = self._run_step("decode_spec", t, 1, step,
                                               values)
            self.last_spec_logits = None
        if return_device:
            return targets, n_accept
        targets, n_accept = targets.cpu().numpy(), n_accept.cpu().numpy()
        if want_logits:
            self.last_spec_logits = self.last_spec_logits.numpy()
        return targets, n_accept

    # -- page I/O: KV transfers (llm/kv_transfer.py) --------------------------

    def _ready_event(self) -> Optional[torch.cuda.Event]:
        """On the card, an event recorded on the current stream after the
        work queued so far (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _side_stream(self) -> torch.cuda.Stream:
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    @torch.inference_mode()
    def gather_pages_device(self, page_ids) -> DeviceBundle:
        """Gather pages into a FRESH bundle on the device: [n, L, 2, ps, kh,
        hd], or packed uint8 [n, bytes] for an int8 pool
        (`ops/block_copy.py`). Runs on the scheduler thread, queued on the
        stream the step graphs replay on, so it reads what every earlier
        step wrote; the returned event marks its end. The copy to the host
        (`bundle_to_host`) then runs off that thread."""
        if self._kv_quantized:
            values, scales = self.kv_cache
            tensor = gather_kv_blocks_q8(values, scales, page_ids)
        else:
            tensor = gather_kv_blocks(self.kv_cache, page_ids)
        return DeviceBundle(tensor, self._ready_event())

    def bundle_to_host(self, bundle: DeviceBundle) -> torch.Tensor:
        """A device bundle's bytes on the host (pinned memory on the card):
        the copy runs on a side stream behind the bundle's event, so the
        thread that calls this (not the scheduler's) waits, and the step
        stream does not."""
        tensor = bundle.tensor
        if tensor.device.type != "cuda":
            return tensor
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        stream = self._side_stream()
        with torch.cuda.stream(stream):
            if bundle.ready is not None:
                stream.wait_event(bundle.ready)
            host.copy_(tensor, non_blocking=True)
        stream.synchronize()
        return host

    def gather_pages(self, page_ids) -> torch.Tensor:
        """Pages to the host, synchronously (scheduler thread only)."""
        return self.bundle_to_host(self.gather_pages_device(page_ids))

    def stage_bundle(self, blocks: torch.Tensor) -> DeviceBundle:
        """Upload a host bundle (a CPU tensor) to the device on a side
        stream, off the scheduler thread; `scatter_pages` waits on the
        returned event and does only the indexed write. On the CPU the
        bundle comes back as it is."""
        if self.device.type != "cuda":
            return DeviceBundle(blocks, None)
        stream = self._side_stream()
        with torch.cuda.stream(stream):
            tensor = blocks.pin_memory().to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        # the scatter reads the tensor on the step stream
        tensor.record_stream(torch.cuda.default_stream(self.device))
        return DeviceBundle(tensor, event)

    @torch.inference_mode()
    def scatter_pages(self, page_ids, blocks) -> None:
        """Write a bundle into pool pages, in place (scheduler thread only):
        the step graphs captured the pool's storage, so the pool's tensors
        are never rebound. `blocks` is a staged DeviceBundle (the write
        waits on its upload) or a host bundle, a CPU tensor (uploaded
        here)."""
        if isinstance(blocks, DeviceBundle):
            if blocks.ready is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    blocks.ready)
            blocks = blocks.tensor
        if self._kv_quantized:
            values, scales = self.kv_cache
            scatter_from_host_q8(values, scales, page_ids, blocks)
        else:
            scatter_from_host(self.kv_cache, page_ids, blocks)

    def kv_layout(self) -> dict:
        """The wire-layout descriptor of this runner's pool, as the
        reference's `kv_layout` writes it: an int8 pool travels packed
        (`kv_dtype` "int8", `scale_lanes` 128), so the two packages'
        descriptors compare equal."""
        cfg = self.model_config
        layout = {
            "n_layers": cfg.n_layers,
            "kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim,
            "kv_dims": 2,
            "page_size": self.config.page_size,
            "dtype": cfg.dtype,
        }
        if self._kv_quantized:
            layout["kv_dtype"] = "int8"
            layout["scale_lanes"] = KV_SCALE_LANES
        return layout

    def warmup(self) -> None:
        """One decode step and one tiny prefill (on the card this builds the
        kernels, initializes the math libraries and captures the decode
        step at the widest table and the (1, smallest bucket) prefill key
        before traffic)."""
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

    def prewarm(self, spec_widths: Optional[Sequence[int]] = None) -> None:
        """Build the whole steady-state key space before serving, as the
        reference's `prewarm` compiles its jit keys: `warmup`, every
        prefill key of `prefill_keys` (one batched call each, its rows
        writing to scratch page 0), then for every table-width bucket the
        fused block (k = DYNT_DECODE_BLOCK, when above 1), `decode` with
        and without logprobs and its logits-processor variant, and the
        verification step, with and without logits, for each draft count in
        `spec_widths` (default: [DYNT_SPEC_MAX_K] when DYNT_SPEC_ENABLE is
        set and the runner supports speculation). The scheduler's batch is
        `max_batch`. The reference compiles its logits variants lazily; here
        they are captured up front, so a first processor request does not
        stall every stream while its key is captured."""
        self.warmup()
        b = self.config.max_batch
        p = self.config.max_pages_per_seq
        for rows, bucket in self.prefill_keys():
            row = (np.zeros(bucket, np.int32), 0, np.zeros(p, np.int32),
                   min(bucket, self.config.max_context), (0.0, 1.0, 0, 0))
            self.prefill_chunk_batch([row] * rows)
        if spec_widths is None:
            spec_widths = ([max(1, int(env("DYNT_SPEC_MAX_K")))]
                           if env("DYNT_SPEC_ENABLE") and self.supports_spec
                           else [])
        block = max(1, int(env("DYNT_DECODE_BLOCK") or 1))
        zeros_i, zeros_b = np.zeros(b, np.int32), np.zeros(b, bool)
        ones_f = np.ones(b, np.float32)
        idle = (zeros_i, zeros_b, ones_f, ones_f, zeros_i,
                np.zeros(b, np.uint32))
        for width in table_widths(p):
            tables = np.zeros((b, width), np.int32)
            if block > 1:
                self.decode_multi(zeros_i, zeros_i, tables, *idle, k=block,
                                  return_device=True)
            for want_logprobs in (False, True):
                self.decode(zeros_i, zeros_i, tables, *idle,
                            want_logprobs=want_logprobs)
            self.decode(zeros_i, zeros_i, tables, *idle, want_logits=True,
                        logits_slots=[])
            for k in spec_widths:
                for want_logits in (False, True):
                    self.decode_spec(zeros_i, np.zeros((b, k), np.int32),
                                     zeros_i, tables, *idle,
                                     want_logits=want_logits,
                                     logits_slots=[], return_device=True)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)
