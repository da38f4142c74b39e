"""Drive the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device  - the card (nvidia-smi name and power limit), torch and CUDA
  build   - nvcc builds every kernel under dynamo_tpu_torch/ops/csrc/ for
            sm_90a, all sources at once
  kernels - each kernel held against its plain PyTorch version on the card
            at llama3-8b decode shapes, then timed beside its plain version,
            one PyTorch library call for the same function, and its bound
  engine  - the main path: a TorchWorker serving llama3-8b at full width
            (random weights from a fixed seed) answers a prefix-warming
            request, then 8 concurrent requests through `generate`; the
            kernel's launch count must equal 32 x the decode forwards run
  parity  - one greedy prompt through the runner with the kernel and with
            the plain decode attention: first-step logits and the first 16
            greedy tokens

Then one line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and the last line is not printed. Without a CUDA card, or
without the rest of the repository beside it, the script exits non-zero.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODEL = "llama3-8b"
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
# Kernel vs plain version, unit-normal bf16 inputs, f32 math in both:
KERNEL_TOL = {"normalized": 2e-3, "m": 1e-3, "l_rel": 1e-3}
# First-decode-step logits, kernel path vs plain path, bf16 model: the two
# attention outputs round to bf16 differently and 32 layers compound it.
PARITY_LOGITS_REL_TOL = 0.05


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


def gpu_time_ms(fn, n: int) -> float:
    """Mean device time of fn(i) over n calls, captured in one CUDA graph
    and replayed, so host launch overhead is not in the number."""
    side = torch.cuda.Stream()
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


def phase_kernels(dev: torch.device) -> dict:
    """paged_decode_attention_pool at llama3-8b decode shapes: B = 8,
    qh = 32, kh = 8, hd = 128, ps = 16, 128-page tables, mixed history."""
    from dynamo_tpu_torch.models import get_config
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

    # 1. correctness against the plain version, reading layer 1
    acc, m, l = pa.paged_decode_attention_pool(q, pool, 1, tables, lens)
    torch.cuda.synchronize()
    r_acc, r_m, r_l = pa.paged_decode_attention_pool_ref(q, pool, 1, tables,
                                                          lens)
    empty = lens == 0
    check(bool(torch.all(torch.isneginf(m[empty])) and torch.all(l[empty] == 0)
               and torch.all(acc[empty] == 0)),
          "zero-history rows must be m=-inf, l=0, acc=0")
    live = ~empty
    norm = acc[live] / l[live][..., None]
    r_norm = r_acc[live] / r_l[live][..., None]
    err = {
        "normalized": float((norm - r_norm).abs().max()),
        "m": float((m[live] - r_m[live]).abs().max()),
        "l_rel": float(((l[live] - r_l[live]).abs() / r_l[live]).max()),
    }
    for key, tol in KERNEL_TOL.items():
        check(err[key] <= tol, f"kernel {key} error {err[key]} > {tol}")

    # 2. timing: each call reads another layer, so 8 layers x ~19 MB of
    #    history cycle through the 50 MB L2 cold, as in a decode step
    def kernel(i):
        pa.paged_decode_attention_pool(q, pool, i % n_layers, tables, lens)

    def plain(i):
        pa.paged_decode_attention_pool_ref(q, pool, i % n_layers, tables,
                                           lens)

    ms = gpu_time_ms(kernel, 200)
    plain_ms = gpu_time_ms(plain, 20)

    # one library call for the same attention: SDPA over the gathered,
    # contiguous K/V (the port never calls it)
    ctx = max_pages * ps
    mask = (torch.arange(ctx, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]  # [B, 1, 1, ctx]
    gathered = []
    for layer in range(n_layers):
        k = pool[layer, 0][tables.long()].reshape(b, ctx, kh, hd)
        v = pool[layer, 1][tables.long()].reshape(b, ctx, kh, hd)
        gathered.append((k.transpose(1, 2).contiguous(),
                         v.transpose(1, 2).contiguous()))
    q4 = q[:, :, None, :]  # [B, qh, 1, hd]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(i):
        k, v = gathered[i % n_layers]
        sdpa(q4, k, v, attn_mask=mask, enable_gqa=True)

    library_ms = gpu_time_ms(library, 50)
    del gathered

    # bound: history K+V rows read once, q/tables/lens read once, partials
    # written once; flops of q.k and p.v on bf16 inputs
    n_hist = sum(hist)
    n_table = sum(-(-h // ps) for h in hist)
    n_bytes = (n_hist * kh * hd * 2 * 2 + b * qh * hd * 2 + n_table * 4
               + b * 4 + b * qh * hd * 4 + 2 * b * qh * 4)
    flops = 4 * qh * hd * n_hist
    bound_s = max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
    result = {
        "name": "paged_decode_attention_pool",
        "route": "cuda",
        "source": "dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu",
        "replaces": "dynamo_tpu/ops/paged_attention.py:297",
        "max_abs_err": err["normalized"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                     >= flops / BF16_FLOPS else "operations"),
        "library_ms": library_ms,
    }
    emit("kernels", shapes={"B": b, "qh": qh, "kh": kh, "hd": hd, "ps": ps,
                            "max_pages": max_pages, "history": hist,
                            "layers": n_layers, "read_layer": 1},
         errors=err, tolerances=KERNEL_TOL, bytes=n_bytes, flops=flops,
         kernel_ms=ms, achieved_GBps=n_bytes / (ms * 1e-3) / 1e9, **result)
    return result


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


def phase_engine(dev: torch.device, model: str = MODEL, runner_config=None):
    """The main path: TorchWorker.generate at full width. Returns the
    worker (scheduler still running) and the kernel launches counted."""
    from dynamo_tpu_torch.engine import TorchWorker
    from dynamo_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
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
    pa.paged_decode_attention_pool.launches = 0
    runner.decode_steps = 0

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
    launches = pa.paged_decode_attention_pool.launches
    decode_forwards = runner.decode_steps

    for res in [warm_res] + results:
        check(res["finish"] == ["length"], f"finish reasons {res['finish']}")
        check(len(res["tokens"]) == 64, f"{len(res['tokens'])} tokens != 64")
        check(all(0 <= t < vocab for t in res["tokens"]),
              "token id outside the vocabulary")
    check(sched.error is None, f"scheduler error {sched.error!r}")
    cached = sum(len(p) for p in prompts) - prefilled
    check(cached == 2 * len(prefix),
          f"prefix cache reused {cached} tokens, expected {2 * len(prefix)}")
    want_launches = cfg.n_layers * decode_forwards if dev.type == "cuda" else 0
    check(decode_forwards > 0 and launches == want_launches,
          f"kernel launches {launches} != {cfg.n_layers} x "
          f"{decode_forwards} decode forwards")
    ttft = [(r["stamps"][0] - r["t0"]) * 1e3 for r in results]
    itl = [(r["stamps"][-1] - r["stamps"][0]) * 1e3 / (len(r["tokens"]) - 1)
           for r in results]
    emit("engine", model=cfg.name, layers=cfg.n_layers, hidden=cfg.hidden,
         vocab=vocab, init_and_warmup_s=init_s, requests=len(results),
         prompt_lengths=[len(p) for p in prompts],
         prefix_cached_tokens=cached, decode_forwards=decode_forwards,
         kernel_launches=launches,
         decode_block=sched.decode_block, decode_pipeline=sched.decode_pipeline,
         ttft_ms_mean=float(np.mean(ttft)), ttft_ms_max=float(np.max(ttft)),
         itl_ms_mean=float(np.mean(itl)),
         output_tokens_per_s=sum(len(r["tokens"]) for r in results) / wall,
         wall_s=wall,
         max_memory_allocated_GB=(torch.cuda.max_memory_allocated() / 1e9
                                  if dev.type == "cuda" else None))
    return worker, launches


def phase_parity(worker, dev: torch.device) -> None:
    """One greedy prompt through the same runner twice: decode attention by
    the kernel, then by the plain version passed in explicitly. History
    positions are never rewritten, so the two runs see the same pool."""
    from dynamo_tpu_torch.engine.model_runner import bucket_table_width
    from dynamo_tpu_torch.models.transformer import paged_attention_decode_xla
    from dynamo_tpu_torch.ops import paged_attention_decode_pool

    worker.close()  # the scheduler thread must not step this runner now
    runner = worker.runner
    cfg = worker.model_config
    ps = runner.config.page_size
    n, steps = 300, 16
    prompt = np.random.default_rng(SEED + 2).integers(1, cfg.vocab_size, n)
    pages = -(-(n + steps) // ps)
    alloc = worker.scheduler.pool.allocate([], pages)
    check(alloc is not None, "no free pages for the parity prompt")
    table = np.zeros(runner.config.max_pages_per_seq, np.int32)
    table[:pages] = alloc.pages
    first = runner.prefill_chunk(prompt, 0, table, n, (0.0, 1.0, 0, 0))
    width = bucket_table_width(pages, runner.config.max_pages_per_seq)
    one = np.ones(1, np.float32)

    def run(attn_fn):
        runner.decode_attention_fn = attn_fn
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

    k_logits, k_tokens = run(paged_attention_decode_pool)
    p_logits, p_tokens = run(paged_attention_decode_xla)
    runner.decode_attention_fn = paged_attention_decode_pool
    diff = float(np.abs(k_logits - p_logits).max())
    scale = float(np.abs(p_logits).max())
    agree = next((i for i, (a, b) in enumerate(zip(k_tokens, p_tokens))
                  if a != b), steps)
    top2 = np.sort(p_logits)[-2:]
    check(np.all(np.isfinite(k_logits)), "non-finite kernel-path logits")
    check(diff <= PARITY_LOGITS_REL_TOL * scale,
          f"logits max|d| {diff} > {PARITY_LOGITS_REL_TOL} x {scale}")
    check(agree >= 1 or float(top2[1] - top2[0]) <= 2 * diff,
          "first greedy token differs beyond a near-tie")
    emit("parity", prompt_len=n, logits_max_abs_diff=diff,
         logits_max_abs=scale, tolerance_rel=PARITY_LOGITS_REL_TOL,
         greedy_tokens_agree_leading=agree, greedy_steps=steps)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    if not (ROOT / "dynamo_tpu_torch" / "ops" / "csrc").is_dir():
        raise SystemExit("chip_smoke: dynamo_tpu_torch/ is not beside this "
                         "script; run it from a checkout of the repository")
    from dynamo_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    phase_build()
    kernel = phase_kernels(dev)
    worker, launches = phase_engine(dev)
    try:
        phase_parity(worker, dev)
    finally:
        worker.close()
    kernel = {**kernel, "launches": launches}
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
