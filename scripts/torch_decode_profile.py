"""Where a decode step of the PyTorch/CUDA port spends its time, on one card.

    python3 scripts/torch_decode_profile.py [--model llama3-8b]
        [--weight-dtype model|int8|int4] [--kv-dtype model|int8]
        [--graphs on|off|both] [--out DIR]

Builds a `ModelRunner` at full width (random weights, seed 0, quantized on
the card when --weight-dtype asks for it), fills the KV pool pages of a
batch of 8 sequences with random history (no prefill is run for them; an
int8 pool gets random K/V quantized by the port's `quantize_kv`), then
measures, with the decode attention and the quantized matmul by the CUDA
kernels (with `RunnerConfig.cuda_graphs` on, off, or both: each step one
CUDA-graph replay, or op by op) and by their plain PyTorch versions (op by
op) in turn:

  * one fused decode block (`decode_multi`, k = 8): host time until the call
    returns (dispatch), wall time until the card is done, and the card's
    time from the block's first operation to its last (CUDA events, idle
    gaps included), per step;
  * a `torch.profiler` trace of one block: device time by kernel name, the
    attention kernels' share (the split decode body and its merge), and the
    device's busy share of the block's wall time;
  * (gpt-oss and MLA: the unified forward graphed and eager, no kernel
    variants, no verification step, as the runner serves it)
  * the same for one speculative verification step (`decode_spec`) of
    K = 4 drafts per slot (5 positions each: the folded attention, the
    projections at M = 16 slots x 5 = 80, since the runner's 16 slots all
    run, 8 of them live; the verification sampler);
  * one prefill chunk of 38, 127, 512 and 1,500 tokens over no history,
    three ways in turns: the serving path (`prefill_chunk`, padded to its
    bucket, one graph replay), the same padded step op by op (cuda_graphs
    off) and the unpadded eager forward the runner ran before prefill was
    padded (`chip_smoke._unpadded_prefill`); wall time until the token is
    on the host, the best of three runs after a warm-up; and a
    `torch.profiler` trace of one graphed chunk (busy time, kernels).

Prints one JSON line per measurement; the trace tables go to --out.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HISTORY = [600, 700, 32, 1500, 200, 96, 900, 1200]
BLOCK = 8
SPEC_K = 4
# device-side names of the attention kernels (csrc/paged_decode_pool.cu)
ATTENTION_KERNELS = ("decode_kernel", "merge_kernel")


def _emit(kind: str, **fields) -> None:
    print(json.dumps({"measure": kind, **fields}), flush=True)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _is_kernel(evt) -> bool:
    """A device-side row (a kernel or a memcpy/memset), not the host op
    that launched it: the ops' rows repeat their kernels' time."""
    return evt.device_type == torch.autograd.DeviceType.CUDA


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--weight-dtype", default="model",
                    choices=("model", "int8", "int4"))
    ap.add_argument("--kv-dtype", default="model", choices=("model", "int8"))
    ap.add_argument("--graphs", default="both", choices=("on", "off", "both"),
                    help="the kernel path's decode-kind steps as CUDA-graph "
                         "replays, op by op, or both in turn")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_profile: needs a CUDA card")

    from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig
    from dynamo_tpu_torch.engine.model_runner import bucket_table_width
    from dynamo_tpu_torch.models import get_config
    from dynamo_tpu_torch.models.transformer import (
        paged_attention_decode_xla,
        paged_attention_spec_xla,
        quant_matmul,
        quant_matmul_ref,
        quantize_kv,
    )
    from dynamo_tpu_torch.ops import (
        paged_attention_decode_pool,
        paged_attention_spec_pool,
    )

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = get_config(args.model)
    rc = RunnerConfig(weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype)
    runner = ModelRunner(cfg, rc, device="cuda", seed=0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _emit("device", nvidia_smi=smi, torch=torch.__version__, model=cfg.name,
          weight_dtype=rc.weight_dtype, kv_dtype=rc.kv_dtype)

    # random history for the batch, written straight into the pool
    b = rc.max_batch
    ps = rc.page_size
    tables = np.zeros((b, rc.max_pages_per_seq), np.int32)
    kv_lens = np.zeros(b, np.int32)
    active = np.zeros(b, bool)
    next_page = 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for i, h in enumerate(HISTORY):
        n = -(-(h + 2 * BLOCK) // ps)
        tables[i, :n] = np.arange(next_page, next_page + n)
        next_page += n
        kv_lens[i], active[i] = h + 1, True
    if isinstance(runner.kv_cache, tuple):
        values, scales = runner.kv_cache
        for layer in range(cfg.n_layers):
            q, s = quantize_kv(torch.randn(
                values[layer, :, 1:next_page].shape, generator=gen,
                device="cuda"))
            values[layer, :, 1:next_page] = q
            scales[layer, :, 1:next_page] = s
    else:
        runner.kv_cache[:, :, 1:next_page].copy_(torch.randn(
            runner.kv_cache[:, :, 1:next_page].shape, generator=gen,
            device="cuda").to(runner.kv_cache.dtype))
    width = bucket_table_width(-(-(max(HISTORY) + 2 * BLOCK) // ps),
                               rc.max_pages_per_seq)
    args_np = dict(
        tokens=np.arange(b, dtype=np.int32), positions=kv_lens - 1,
        block_tables=np.ascontiguousarray(tables[:, :width]),
        kv_lens=kv_lens, active=active,
        temperature=np.zeros(b, np.float32), top_p=np.ones(b, np.float32),
        top_k=np.zeros(b, np.int32), seeds=np.zeros(b, np.uint32))

    spec_args = dict(
        tokens=np.arange(b, dtype=np.int32),
        drafts=np.random.default_rng(1).integers(
            1, cfg.vocab_size, (b, SPEC_K)).astype(np.int32),
        positions=kv_lens - 1, block_tables=args_np["block_tables"],
        kv_lens=kv_lens, active=active,
        temperature=args_np["temperature"], top_p=args_np["top_p"],
        top_k=args_np["top_k"], seeds=args_np["seeds"])

    def measure(kind, run, steps, kernels, **fields):
        """Time `run` (which dispatches `steps` forwards) three times and
        trace it once; one JSON line per step. The warm call captures a
        new graph key."""
        run()  # warm
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            run()
            t1 = time.perf_counter()
            end.record()
            torch.cuda.synchronize()
            runs.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3,
                         start.elapsed_time(end)))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            traced_wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages() if _is_kernel(e)]
        events.sort(key=_device_us, reverse=True)
        busy_us = sum(_device_us(e) for e in events)
        attn_us = sum(_device_us(e) for e in events
                      if any(k in e.key for k in ATTENTION_KERNELS))
        graphs = "graphs" if rc.cuda_graphs else "eager"
        tag = (f"{kind}_{cfg.name}_{rc.weight_dtype}_{rc.kv_dtype}_{kernels}"
               f"_{graphs}")
        (out_dir / f"{tag}.txt").write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40))
        _emit(kind, kernels=kernels, cuda_graphs=rc.cuda_graphs,
              batch=len(HISTORY), history=HISTORY, **fields,
              step_ms=min(r[1] for r in runs) / steps,
              dispatch_ms_per_step=min(r[0] for r in runs) / steps,
              device_span_ms_per_step=min(r[2] for r in runs) / steps,
              traced_step_ms=traced_wall_us / 1e3 / steps,
              device_busy_ms_per_step=busy_us / 1e3 / steps,
              device_busy_share=busy_us / traced_wall_us,
              attention_ms_per_step=attn_us / 1e3 / steps,
              kernel_launches_per_step=sum(e.count for e in events) / steps,
              top=[{"name": e.key[:80],
                    "ms_per_step": _device_us(e) / 1e3 / steps,
                    "calls_per_step": e.count / steps} for e in events[:12]])

    modes = {"on": (True,), "off": (False,), "both": (True, False)}
    if cfg.is_gptoss or cfg.is_mla:
        # no decode or spec kernel and no speculation: the unified forward
        # (plain sink or latent attention, the plain MoE), graphed or eager
        variants = [("unified", None, None, quant_matmul, g)
                    for g in modes[args.graphs]]
    else:
        variants = [*[("kernel", paged_attention_decode_pool,
                       paged_attention_spec_pool, quant_matmul, g)
                      for g in modes[args.graphs]],
                    ("plain", paged_attention_decode_xla,
                     paged_attention_spec_xla, quant_matmul_ref, False)]
    functions = (runner.decode_attention_fn, runner.spec_attention_fn,
                 runner.matmul_fn)
    for name, attn_fn, spec_fn, mm_fn, graphs in variants:
        runner.decode_attention_fn, runner.matmul_fn = attn_fn, mm_fn
        runner.spec_attention_fn = spec_fn
        rc.cuda_graphs = graphs
        measure("decode_block",
                lambda: runner.decode_multi(**args_np, k=BLOCK,
                                            return_device=True),
                BLOCK, name, block=BLOCK)
        if runner.supports_spec:
            measure("spec_step",
                    lambda: runner.decode_spec(**spec_args,
                                               return_device=True),
                    1, name, spec_k=SPEC_K, positions=SPEC_K + 1)
    (runner.decode_attention_fn, runner.spec_attention_fn,
     runner.matmul_fn) = functions
    rc.cuda_graphs = True
    _emit("graphs", captures=runner.graph_captures,
          replays=runner.graph_replays, capture_s=runner.graph_capture_s,
          keys=len(runner.step_graphs),
          graph_pool_GB=runner.graph_memory_bytes() / 1e9,
          memory_reserved_GB=torch.cuda.memory_reserved() / 1e9,
          max_memory_allocated_GB=torch.cuda.max_memory_allocated() / 1e9)

    from chip_smoke import _unpadded_prefill

    table = np.zeros(rc.max_pages_per_seq, np.int32)
    table[:96] = np.arange(next_page, next_page + 96)
    rng = np.random.default_rng(0)
    for n in (38, 127, 512, 1500):
        toks = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        args = (toks, 0, table, n, (0.0, 1.0, 0, 0))

        def padded(graphs):
            rc.cuda_graphs = graphs
            try:
                runner.prefill_chunk(*args)
            finally:
                rc.cuda_graphs = True

        ways = {"graphed": lambda: padded(True),
                "eager_padded": lambda: padded(False),
                "eager_unpadded": lambda: _unpadded_prefill(runner,
                                                            *args[:4])}
        runs = {way: [] for way in ways}
        for fn in ways.values():
            fn()  # warm: captures the bucket's key if it is new
        for _ in range(3):
            for way, fn in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs[way].append((time.perf_counter() - t0) * 1e3)
        # one graphed chunk traced: the card's busy time and its kernels
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            padded(True)
            torch.cuda.synchronize()
            traced_us = (time.perf_counter() - t0) * 1e6
        events = sorted((e for e in prof.key_averages() if _is_kernel(e)),
                        key=_device_us, reverse=True)
        busy_us = sum(_device_us(e) for e in events)
        (out_dir / f"prefill_{n}_{cfg.name}_{rc.weight_dtype}_graphs.txt"
         ).write_text(prof.key_averages().table(
             sort_by="self_cuda_time_total", row_limit=40))
        _emit("prefill_chunk", tokens=n, bucket=runner._bucket_for(n),
              **{f"{way}_ms": min(r) for way, r in runs.items()},
              runs_ms=runs, traced_graphed_ms=traced_us / 1e3,
              device_busy_ms=busy_us / 1e3,
              device_busy_share=busy_us / traced_us,
              kernel_launches=sum(e.count for e in events),
              top=[{"name": e.key[:80], "ms": _device_us(e) / 1e3,
                    "calls": e.count} for e in events[:12]])


if __name__ == "__main__":
    main()
