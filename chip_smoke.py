"""Drive the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device    - the card (nvidia-smi name and power limit), torch and CUDA
  build     - nvcc builds every kernel under dynamo_tpu_torch/ops/csrc/ for
              sm_90a, all sources at once
  kernels   - the paged decode kernel, bf16 pool and int8 pool, held against
              its plain PyTorch version at llama3-8b decode shapes, then
              timed beside its plain version, one PyTorch library call for
              the same function, and its bound
  gemm      - the W8A16 and W4A16 (v2, v1) kernels the same way, at every
              mistral-7b projection geometry, for M = 8 and M = 512; then
              ragged M and N (off the kernels' tiles), correctness only
  engine    - the bf16 path: a TorchWorker serving llama3-8b at full width
              (random weights from a fixed seed) answers a prefix-warming
              request, then 8 concurrent requests through `generate`; the
              bf16 decode kernel's launch count must equal 32 x the decode
              forwards run, and no other kernel may launch
  parity    - one greedy prompt through that runner with the kernels and
              with the plain versions: first-step logits and greedy tokens
  engine_q  - the quantized path: the same traffic through a TorchWorker
              serving mistral-7b with W4A16 weights (quantized on the card)
              and an int8 KV pool; launches: int8 decode kernel = 32 x
              decode forwards, q4 v2 matmul = (7 x 32 + 1) x all forwards,
              none of the others
  parity_q  - the parity prompt on the quantized runner, kernels (decode
              attention and matmul) against plain versions
  secondary - mistral-7b widths at 4 layers through the runner: W8A16 with
              int8 KV, and W4A16 under DYNT_Q4_VARIANT=v1; a few greedy
              steps each against the plain versions, launches checked

Then one line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and the last line is not printed. Without a CUDA card, or
without the rest of the repository beside it, the script exits non-zero.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODEL = "llama3-8b"
QMODEL = "mistral-7b"
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
L2_BYTES = 50e6
# Kernel vs plain version, unit-normal bf16 inputs, f32 math in both:
KERNEL_TOL = {"normalized": 2e-3, "m": 1e-3, "l_rel": 1e-3}
# GEMM kernel vs plain version, |out - ref| <= tol x max|ref|: both round
# one f32 sum to bf16 (one bf16 ulp is 2^-8 of the value); q4 kernels also
# round each dequantized weight to bf16 exactly as the plain version does.
GEMM_REL_TOL = {"q8_matmul": 1e-2, "q4_matmul_v2": 2e-2, "q4_matmul_v1": 2e-2}
# mistral-7b's projection geometries (K, N): wq/wo, wk/wv, gate/up, down,
# lm_head.
GEMM_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (4096, 32768))
GEMM_MS = (8, 512)  # a decode batch and a prefill chunk
# First-decode-step logits, kernel path vs plain path: the two round the
# attention and projection outputs to bf16 at different points and 32
# layers compound it.
PARITY_LOGITS_REL_TOL = 0.05

# Where each kernel of the port comes from: name -> (source, TPU kernel).
KERNELS = {
    "paged_decode_attention_pool": (
        "dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu",
        "dynamo_tpu/ops/paged_attention.py:297"),
    "paged_decode_attention_pool_int8": (
        "dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu",
        "dynamo_tpu/ops/paged_attention.py:445"),
    "q8_matmul": (
        "dynamo_tpu_torch/ops/csrc/q8_matmul.cu",
        "dynamo_tpu/ops/q8_linear.py:55"),
    "q4_matmul_v2": (
        "dynamo_tpu_torch/ops/csrc/q4_matmul.cu",
        "dynamo_tpu/ops/q4_linear.py:349"),
    "q4_matmul_v1": (
        "dynamo_tpu_torch/ops/csrc/q4_matmul.cu",
        "dynamo_tpu/ops/q4_linear.py:311"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_SIDE_STREAM = []  # one warm-up stream for every timing: cuBLAS keeps a
# workspace per stream it runs on, so a new stream per timing would leave
# one allocated for each and inflate the engine phases' peak memory


def gpu_time_ms(fn, n: int) -> float:
    """Mean device time of fn(i) over n calls, captured in one CUDA graph
    and replayed, so host launch overhead is not in the number."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / n


def counters() -> dict:
    """Each kernel wrapper of the port, by kernel name."""
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import q4_linear as q4l
    from dynamo_tpu_torch.ops import q8_linear as q8l

    return {"paged_decode_attention_pool": pa.paged_decode_attention_pool,
            "paged_decode_attention_pool_int8":
                pa.paged_decode_attention_pool_int8,
            "q8_matmul": q8l.q8_matmul,
            "q4_matmul_v2": q4l.q4_matmul_v2,
            "q4_matmul_v1": q4l.q4_matmul_v1}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def matmul_kernels_per_forward(runner) -> dict:
    """How many times one forward launches each matmul kernel: once per
    quantized projection leaf, the kernel chosen by the leaf's kind."""
    from dynamo_tpu_torch.ops import Q4Weight, Q8Weight

    per = {}
    for leaf in runner.model.modules():
        if isinstance(leaf, Q8Weight):
            name = "q8_matmul"
        elif isinstance(leaf, Q4Weight):
            name = ("q4_matmul_v2" if leaf.q4.dtype == torch.int8
                    else "q4_matmul_v1")
        else:
            continue
        per[name] = per.get(name, 0) + 1
    return per


def expected_counts(runner, decode_forwards: int, prefill_forwards: int,
                    dev: torch.device) -> dict:
    want = {name: 0 for name in counters()}
    if dev.type != "cuda":
        return want
    attn = ("paged_decode_attention_pool_int8"
            if isinstance(runner.kv_cache, tuple)
            else "paged_decode_attention_pool")
    want[attn] = runner.model_config.n_layers * decode_forwards
    for name, n in matmul_kernels_per_forward(runner).items():
        want[name] = n * (decode_forwards + prefill_forwards)
    return want


def kernel_entry(name: str, max_abs_err: float, ms: float, plain_ms: float,
                 library_ms, n_bytes: float, flops: float) -> dict:
    source, replaces = KERNELS[name]
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


def phase_build() -> None:
    from dynamo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = []
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(secs, 3),
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()],
         ptxas=ptxas)


def phase_kernels(dev: torch.device) -> list:
    """paged_decode_attention_pool at llama3-8b decode shapes: B = 8,
    qh = 32, kh = 8, hd = 128, ps = 16, 128-page tables, mixed history;
    with a bf16 pool (row 1) and the same pool quantized to int8 by the
    port's quantize_kv (row 2)."""
    from dynamo_tpu_torch.models import get_config
    from dynamo_tpu_torch.models.transformer import quantize_kv
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = get_config(MODEL)
    qh, kh, hd, ps, max_pages = (cfg.n_q_heads, cfg.n_kv_heads,
                                 cfg.head_dim, 16, 128)
    hist = [0, 1, 15, 16, 17, 1000, 2047, 1500]
    b = len(hist)
    n_layers, n_pages = 8, 320
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pool = torch.randn((n_layers, 2, n_pages, ps, kh, hd), generator=gen,
                       device=dev).to(torch.bfloat16)
    q = torch.randn((b, qh, hd), generator=gen, device=dev).to(torch.bfloat16)
    # each row owns distinct random pages; unused slots point at scratch
    # page 0, as the scheduler's tables do
    perm = np.random.default_rng(SEED).permutation(np.arange(1, n_pages))
    table_np = np.zeros((b, max_pages), np.int32)
    used = 0
    for i, h in enumerate(hist):
        n = -(-h // ps)
        table_np[i, :n] = perm[used:used + n]
        used += n
    tables = torch.from_numpy(table_np).to(dev)
    lens = torch.tensor(hist, dtype=torch.int32, device=dev)
    values, scales = quantize_kv(pool)
    n_hist = sum(hist)
    n_table = sum(-(-h // ps) for h in hist)
    ctx = max_pages * ps
    mask = (torch.arange(ctx, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]  # [B, 1, 1, ctx]
    q4d = q[:, :, None, :]  # [B, qh, 1, hd]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = []
    for name, kv, kv_scales, elt in (
            ("paged_decode_attention_pool", pool, None, 2),
            ("paged_decode_attention_pool_int8", values, scales, 1)):
        # 1. correctness against the plain version, reading layer 1
        acc, m, l = pa.paged_decode_attention_pool(q, kv, 1, tables, lens,
                                                   kv_scales=kv_scales)
        torch.cuda.synchronize()
        r_acc, r_m, r_l = pa.paged_decode_attention_pool_ref(
            q, kv, 1, tables, lens, kv_scales)
        empty = lens == 0
        check(bool(torch.all(torch.isneginf(m[empty]))
                   and torch.all(l[empty] == 0) and torch.all(acc[empty] == 0)),
              f"{name}: zero-history rows must be m=-inf, l=0, acc=0")
        live = ~empty
        norm = acc[live] / l[live][..., None]
        r_norm = r_acc[live] / r_l[live][..., None]
        err = {
            "normalized": float((norm - r_norm).abs().max()),
            "m": float((m[live] - r_m[live]).abs().max()),
            "l_rel": float(((l[live] - r_l[live]).abs() / r_l[live]).max()),
        }
        for key, tol in KERNEL_TOL.items():
            check(err[key] <= tol, f"{name} {key} error {err[key]} > {tol}")

        # 2. timing: each call reads another layer, so 8 layers of history
        #    cycle through the 50 MB L2 cold, as in a decode step
        def kernel(i, kv=kv, kv_scales=kv_scales):
            pa.paged_decode_attention_pool(q, kv, i % n_layers, tables, lens,
                                           kv_scales=kv_scales)

        def plain(i, kv=kv, kv_scales=kv_scales):
            pa.paged_decode_attention_pool_ref(q, kv, i % n_layers, tables,
                                               lens, kv_scales)

        ms = gpu_time_ms(kernel, 200)
        plain_ms = gpu_time_ms(plain, 20)

        # one library call for the same attention: SDPA over the gathered,
        # contiguous (dequantized) K/V (the port never calls it)
        gathered = []
        for layer in range(n_layers):
            kvs = []
            for j in (0, 1):
                x = kv[layer, j][tables.long()].reshape(b, ctx, kh, hd)
                if kv_scales is not None:
                    x = (x.float() * kv_scales[layer, j][tables.long()]
                         .reshape(b, ctx, 1, 1).float()).to(torch.bfloat16)
                kvs.append(x.transpose(1, 2).contiguous())
            gathered.append(kvs)

        def library(i):
            k, v = gathered[i % n_layers]
            sdpa(q4d, k, v, attn_mask=mask, enable_gqa=True)

        library_ms = gpu_time_ms(library, 50)
        del gathered

        # bound: history K+V rows (and their scales) read once, q / tables /
        # lens read once, partials written once; flops of q.k and p.v
        n_bytes = (n_hist * kh * hd * 2 * elt
                   + (n_hist * 2 * 2 if kv_scales is not None else 0)
                   + b * qh * hd * 2 + n_table * 4 + b * 4 + b * qh * hd * 4
                   + 2 * b * qh * 4)
        flops = 4 * qh * hd * n_hist
        entry = kernel_entry(name, err["normalized"], ms, plain_ms, library_ms,
                             n_bytes, flops)
        emit("kernels", shapes={"B": b, "qh": qh, "kh": kh, "hd": hd,
                                "ps": ps, "max_pages": max_pages,
                                "history": hist, "layers": n_layers,
                                "read_layer": 1},
             errors=err, tolerances=KERNEL_TOL, bytes=n_bytes, flops=flops,
             kernel_ms=ms, achieved_GBps=n_bytes / (ms * 1e-3) / 1e9, **entry)
        results.append(entry)
    del pool, values, scales
    free_memory()
    return results


def phase_gemms(dev: torch.device) -> list:
    """q8_matmul, q4_matmul_v2 and q4_matmul_v1 at mistral-7b's projection
    geometries for M = 8 and M = 512, against their plain versions. Each
    timed call reads another copy of the packed weight (enough copies to
    exceed the L2 twice over), so weights come from HBM as in a decode
    step. The kernels-line numbers are the sums over the five geometries
    at M = 8 (one of each projection, decode shapes)."""
    from dynamo_tpu_torch.ops import q4_linear as q4l
    from dynamo_tpu_torch.ops import q8_linear as q8l

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    kernels = {"q8_matmul": (q8l.q8_matmul, q8l.q8_matmul_ref),
               "q4_matmul_v2": (q4l.q4_matmul_v2, q4l.q4_matmul_ref),
               "q4_matmul_v1": (q4l.q4_matmul_v1, q4l.q4_matmul_ref)}
    totals = {name: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                     "library_ms": 0.0, "bytes": 0.0, "flops": 0.0}
              for name in kernels}
    for k, n in GEMM_SHAPES:
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        leaves = {"q8_matmul": q8l.quantize_weight(w, 1),
                  "q4_matmul_v2": q4l.quantize_weight_q4(w, 1, version=2),
                  "q4_matmul_v1": q4l.quantize_weight_q4(w, 1, version=1)}
        del w
        for name, leaf in leaves.items():
            kernel_fn, plain_fn = kernels[name]
            args = tuple(leaf.values())
            if name == "q8_matmul":
                deq = (args[0].float() * args[1]).to(torch.bfloat16)
            else:
                deq = q4l.dequantize_q4(*args).to(torch.bfloat16)
            w_bytes = sum(t.numel() * t.element_size() for t in args)
            copies = [args] + [tuple(t.clone() for t in args) for _ in range(
                min(15, math.ceil(2 * L2_BYTES / w_bytes) - 1))]
            lib = [deq] + [deq.clone() for _ in range(
                min(7, math.ceil(2 * L2_BYTES / (deq.numel() * 2)) - 1))]
            for m in GEMM_MS:
                x = torch.randn((m, k), generator=gen,
                                device=dev).to(torch.bfloat16)
                out = kernel_fn(x, *args)
                torch.cuda.synchronize()
                ref = plain_fn(x, *args)
                err = float((out.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                check(bool(torch.isfinite(out).all())
                      and err <= GEMM_REL_TOL[name] * scale,
                      f"{name} K={k} N={n} M={m}: max|d| {err} > "
                      f"{GEMM_REL_TOL[name]} x {scale}")
                ms = gpu_time_ms(
                    lambda i: kernel_fn(x, *copies[i % len(copies)]), 50)
                plain_ms = gpu_time_ms(
                    lambda i: plain_fn(x, *copies[i % len(copies)]), 4)
                library_ms = gpu_time_ms(
                    lambda i: torch.matmul(x, lib[i % len(lib)]), 20)
                n_bytes = w_bytes + m * k * 2 + m * n * 2
                flops = 2 * m * k * n
                bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                               flops / BF16_FLOPS) * 1e3
                emit("gemm", name=name, K=k, N=n, M=m, max_abs_err=err,
                     max_abs_ref=scale, tolerance_rel=GEMM_REL_TOL[name],
                     ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bytes=n_bytes, flops=flops,
                     weight_copies=len(copies),
                     achieved_GBps=n_bytes / (ms * 1e-3) / 1e9,
                     achieved_TFLOPs=flops / (ms * 1e-3) / 1e12)
                tot = totals[name]
                tot["err"] = max(tot["err"], err)
                if m == GEMM_MS[0]:
                    tot["ms"] += ms
                    tot["plain_ms"] += plain_ms
                    tot["library_ms"] += library_ms
                    tot["bytes"] += n_bytes
                    tot["flops"] += flops
            del copies, lib, deq
        del leaves
        free_memory()
    # ragged shapes, correctness only: M off the 16- and 64-row tiles, N a
    # multiple of 16 but not of the 64- or 128-column tile
    k, n = 4096, 1040
    w = (torch.randn((k, n), generator=gen, device=dev)
         / math.sqrt(k)).to(torch.bfloat16)
    tails = {}
    for name, leaf in (("q8_matmul", q8l.quantize_weight(w, 1)),
                       ("q4_matmul_v2", q4l.quantize_weight_q4(w, 1, 2)),
                       ("q4_matmul_v1", q4l.quantize_weight_q4(w, 1, 1))):
        kernel_fn, plain_fn = kernels[name]
        for m in (3, 77):
            x = torch.randn((m, k), generator=gen,
                            device=dev).to(torch.bfloat16)
            out = kernel_fn(x, *leaf.values())
            torch.cuda.synchronize()
            ref = plain_fn(x, *leaf.values())
            err = float((out.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            check(err <= GEMM_REL_TOL[name] * scale,
                  f"{name} K={k} N={n} M={m}: max|d| {err} > "
                  f"{GEMM_REL_TOL[name]} x {scale}")
            tails[f"{name} M={m}"] = err / scale
    emit("gemm_tails", K=k, N=n, rel_errors=tails)
    return [kernel_entry(name, t["err"], t["ms"], t["plain_ms"],
                         t["library_ms"], t["bytes"], t["flops"])
            for name, t in totals.items()]


async def _stream(worker, body: dict) -> dict:
    t0 = time.perf_counter()
    tokens, stamps, finish = [], [], []
    async for frame in worker.generate(body):
        if frame.get("t"):
            tokens += frame["t"]
            stamps.append(time.perf_counter())
        if "f" in frame:
            finish.append(frame["f"])
            if frame.get("err"):
                raise SystemExit(f"chip_smoke: request failed: {frame['err']}")
    return {"tokens": tokens, "finish": finish, "t0": t0, "stamps": stamps}


def _body(rid: str, token_ids, temperature: float, top_p: float) -> dict:
    from dynamo_tpu_torch.llm.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    return PreprocessedRequest(
        request_id=rid, token_ids=[int(t) for t in token_ids],
        sampling=SamplingOptions(max_tokens=64, temperature=temperature,
                                 top_p=top_p, seed=int(rid.split("-")[-1])),
        stop=StopConditions(ignore_eos=True)).to_wire()


def phase_engine(dev: torch.device, model: str = MODEL, runner_config=None,
                 label: str = "engine"):
    """A main path: TorchWorker.generate at full width. Returns the worker
    (scheduler still running) and the kernel launches counted in the run,
    after checking them against the forwards the runner ran."""
    from dynamo_tpu_torch.engine import TorchWorker

    t0 = time.perf_counter()
    before_gb = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 1e9
    worker = TorchWorker(model, runner_config, device=dev, seed=SEED)
    worker.start()
    init_s = time.perf_counter() - t0
    cfg = worker.model_config
    runner = worker.runner
    sched = worker.scheduler
    rng = np.random.default_rng(SEED + 1)
    vocab = cfg.vocab_size
    prefix = rng.integers(1, vocab, 512)
    lengths = [600, 700, 32, 1500, 200, 96, 900, 1200]
    prompts = []
    for i, n in enumerate(lengths):
        if i in (0, 1):  # these two share the 512-token prefix
            prompts.append(np.concatenate(
                [prefix, rng.integers(1, vocab, n - len(prefix))]))
        else:
            prompts.append(rng.integers(1, vocab, n))
    warm = np.concatenate([prefix, rng.integers(1, vocab, 40)])

    # counts to zero just before the main path
    reset_counts()
    runner.decode_steps = 0
    runner.prefill_steps = 0

    async def serve():
        first = await _stream(worker, _body("warm-0", warm, 0.0, 1.0))
        prefilled0 = sched.stats.prefill_tokens
        start = time.perf_counter()
        results = await asyncio.gather(*[
            _stream(worker, _body(f"req-{i}", p, 0.0 if i % 2 == 0 else 0.8,
                                  1.0 if i % 2 == 0 else 0.9))
            for i, p in enumerate(prompts)])
        wall = time.perf_counter() - start
        return first, results, wall, sched.stats.prefill_tokens - prefilled0

    warm_res, results, wall, prefilled = asyncio.run(serve())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = read_counts()
    decode_forwards = runner.decode_steps
    prefill_forwards = runner.prefill_steps

    for res in [warm_res] + results:
        check(res["finish"] == ["length"], f"finish reasons {res['finish']}")
        check(len(res["tokens"]) == 64, f"{len(res['tokens'])} tokens != 64")
        check(all(0 <= t < vocab for t in res["tokens"]),
              "token id outside the vocabulary")
    check(sched.error is None, f"scheduler error {sched.error!r}")
    cached = sum(len(p) for p in prompts) - prefilled
    check(cached == 2 * len(prefix),
          f"prefix cache reused {cached} tokens, expected {2 * len(prefix)}")
    want = expected_counts(runner, decode_forwards, prefill_forwards, dev)
    check(decode_forwards > 0 and prefill_forwards > 0 and launches == want,
          f"{label}: kernel launches {launches} != expected {want} for "
          f"{decode_forwards} decode and {prefill_forwards} prefill forwards")
    ttft = [(r["stamps"][0] - r["t0"]) * 1e3 for r in results]
    itl = [(r["stamps"][-1] - r["stamps"][0]) * 1e3 / (len(r["tokens"]) - 1)
           for r in results]
    rc = runner.config
    emit(label, model=cfg.name, layers=cfg.n_layers, hidden=cfg.hidden,
         vocab=vocab, weight_dtype=rc.weight_dtype, kv_dtype=rc.kv_dtype,
         init_and_warmup_s=init_s, requests=len(results),
         prompt_lengths=[len(p) for p in prompts],
         prefix_cached_tokens=cached, decode_forwards=decode_forwards,
         prefill_forwards=prefill_forwards, kernel_launches=launches,
         decode_block=sched.decode_block, decode_pipeline=sched.decode_pipeline,
         ttft_ms_mean=float(np.mean(ttft)), ttft_ms_max=float(np.max(ttft)),
         itl_ms_mean=float(np.mean(itl)),
         output_tokens_per_s=sum(len(r["tokens"]) for r in results) / wall,
         wall_s=wall,
         max_memory_allocated_GB=(torch.cuda.max_memory_allocated() / 1e9
                                  if dev.type == "cuda" else None),
         memory_allocated_before_GB=before_gb)
    return worker, launches


def greedy_parity(runner, table: np.ndarray, prompt: np.ndarray, steps: int,
                  label: str, **extra) -> None:
    """One greedy prompt through `runner` twice: decode attention and
    quantized matmul by the kernels, then by the plain versions passed in
    explicitly. History positions are never rewritten, so the two runs see
    the same pool."""
    from dynamo_tpu_torch.engine.model_runner import bucket_table_width
    from dynamo_tpu_torch.models.transformer import (
        paged_attention_decode_xla,
        quant_matmul,
        quant_matmul_ref,
    )
    from dynamo_tpu_torch.ops import paged_attention_decode_pool

    n = len(prompt)
    first = runner.prefill_chunk(prompt, 0, table, n, (0.0, 1.0, 0, 0))
    width = bucket_table_width(-(-(n + steps) // runner.config.page_size),
                               runner.config.max_pages_per_seq)
    one = np.ones(1, np.float32)

    def run(attn_fn, mm_fn):
        runner.decode_attention_fn, runner.matmul_fn = attn_fn, mm_fn
        tok, out, logits = first, [], None
        for s in range(steps):
            nxt = runner.decode(
                np.asarray([tok], np.int32), np.asarray([n + s], np.int32),
                table[None, :width], np.asarray([n + s + 1], np.int32),
                np.ones(1, bool), np.zeros(1, np.float32), one,
                np.zeros(1, np.int32), np.zeros(1, np.uint32),
                np.asarray([s], np.int32), want_logits=s == 0)
            if s == 0:
                logits = runner.last_decode_logits[0]
            tok = int(nxt[0])
            out.append(tok)
        return logits, out

    k_logits, k_tokens = run(paged_attention_decode_pool, quant_matmul)
    p_logits, p_tokens = run(paged_attention_decode_xla, quant_matmul_ref)
    runner.decode_attention_fn = paged_attention_decode_pool
    runner.matmul_fn = quant_matmul
    diff = float(np.abs(k_logits - p_logits).max())
    scale = float(np.abs(p_logits).max())
    agree = next((i for i, (a, b) in enumerate(zip(k_tokens, p_tokens))
                  if a != b), steps)
    top2 = np.sort(p_logits)[-2:]
    check(np.all(np.isfinite(k_logits)), f"{label}: non-finite kernel logits")
    check(diff <= PARITY_LOGITS_REL_TOL * scale,
          f"{label}: logits max|d| {diff} > {PARITY_LOGITS_REL_TOL} x {scale}")
    check(agree >= 1 or float(top2[1] - top2[0]) <= 2 * diff,
          f"{label}: first greedy token differs beyond a near-tie")
    emit(label, prompt_len=n, logits_max_abs_diff=diff, logits_max_abs=scale,
         tolerance_rel=PARITY_LOGITS_REL_TOL,
         greedy_tokens_agree_leading=agree, greedy_steps=steps, **extra)


def phase_parity(worker, label: str = "parity") -> None:
    """greedy_parity on a serving runner, its pages taken from the pool."""
    worker.close()  # the scheduler thread must not step this runner now
    runner = worker.runner
    n, steps = 300, 16
    prompt = np.random.default_rng(SEED + 2).integers(
        1, worker.model_config.vocab_size, n)
    pages = -(-(n + steps) // runner.config.page_size)
    alloc = worker.scheduler.pool.allocate([], pages)
    check(alloc is not None, "no free pages for the parity prompt")
    table = np.zeros(runner.config.max_pages_per_seq, np.int32)
    table[:pages] = alloc.pages
    greedy_parity(runner, table, prompt, steps, label,
                  weight_dtype=runner.config.weight_dtype,
                  kv_dtype=runner.config.kv_dtype)


def phase_secondary(dev: torch.device, weight_dtype: str,
                    variant=None) -> dict:
    """A secondary quantized path at mistral-7b widths, 4 layers: prefill
    one prompt and run a few greedy decode steps through the runner with
    the kernels, then with the plain versions; the launches of the kernel
    run are checked against its forwards. Returns the launches."""
    from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig
    from dynamo_tpu_torch.models import get_config

    label = f"secondary_{weight_dtype}" + (f"_{variant}" if variant else "")
    cfg = dataclasses.replace(get_config(QMODEL), n_layers=4)
    saved = os.environ.get("DYNT_Q4_VARIANT")
    if variant:
        os.environ["DYNT_Q4_VARIANT"] = variant
    try:
        runner = ModelRunner(cfg, RunnerConfig(
            num_pages=64, max_batch=1, weight_dtype=weight_dtype,
            kv_dtype="int8"), device=dev, seed=SEED)
    finally:
        if saved is None:
            os.environ.pop("DYNT_Q4_VARIANT", None)
        else:
            os.environ["DYNT_Q4_VARIANT"] = saved
    n, steps = 200, 8
    table = np.zeros(runner.config.max_pages_per_seq, np.int32)
    pages = -(-(n + steps) // runner.config.page_size)
    table[:pages] = np.arange(1, pages + 1)
    prompt = np.random.default_rng(SEED + 4).integers(1, cfg.vocab_size, n)
    reset_counts()
    greedy_parity(runner, table, prompt, steps, label, layers=cfg.n_layers,
                  weight_dtype=weight_dtype, kv_dtype="int8",
                  q4_variant=variant, kernels_per_forward=(
                      matmul_kernels_per_forward(runner)))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = read_counts()
    # the kernel run: 1 prefill + `steps` decode forwards; the plain run
    # launches nothing
    want = expected_counts(runner, steps, 1, dev)
    check(launches == want,
          f"{label}: kernel launches {launches} != expected {want}")
    emit(label + "_launches", kernel_launches=launches)
    del runner
    free_memory()
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    if not (ROOT / "dynamo_tpu_torch" / "ops" / "csrc").is_dir():
        raise SystemExit("chip_smoke: dynamo_tpu_torch/ is not beside this "
                         "script; run it from a checkout of the repository")
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engine import RunnerConfig

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    phase_build()
    entries = {e["name"]: e for e in phase_kernels(dev) + phase_gemms(dev)}
    launches = {}

    # the bf16 path (llama3-8b)
    worker, counts = phase_engine(dev)
    launches["paged_decode_attention_pool"] = counts[
        "paged_decode_attention_pool"]
    try:
        phase_parity(worker)
    finally:
        worker.close()
    del worker
    free_memory()

    # the quantized path (mistral-7b, W4A16 + int8 KV)
    worker, counts = phase_engine(
        dev, QMODEL, RunnerConfig(weight_dtype="int4", kv_dtype="int8"),
        label="engine_q")
    n_layers = worker.model_config.n_layers
    check(matmul_kernels_per_forward(worker.runner)
          == {"q4_matmul_v2": 7 * n_layers + 1},
          "mistral-7b int4 must pack every projection in the v2 layout")
    for name in ("paged_decode_attention_pool_int8", "q4_matmul_v2"):
        launches[name] = counts[name]
    try:
        phase_parity(worker, "parity_q")
    finally:
        worker.close()
    del worker
    free_memory()

    # the secondary quantized paths
    launches["q8_matmul"] = phase_secondary(dev, "int8")["q8_matmul"]
    launches["q4_matmul_v1"] = phase_secondary(dev, "int4", "v1")[
        "q4_matmul_v1"]

    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on its path")
    kernels = [{**entries[name], "launches": launches[name]}
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
