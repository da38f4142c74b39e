"""Which split span the port's decode kernel should use, on one card.

    python3 scripts/torch_decode_span.py [--spans 64,128,256]

The pool decode kernel (`dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu`)
cuts each sequence's history into splits of `ops.paged_attention.SPAN`
tokens and merges their partials. A span set by the page size alone keeps a
sequence's decode the same in any batch and at any table width; the plan the
port had before followed the batch and the width
(`chip_smoke._batch_following_plan`). On llama3-8b bf16 (random weights,
seed 0), for each span of --spans and for that earlier plan:

  * invariance (spans only): slot 0 decoded greedily at batch 1 and 8 and
    table widths 32 and 128, as `chip_smoke.phase_batch_invariance` does;
    the max |delta logits| against batch 1 / width 32 and the first token
    at which the streams part;
  * kernel times at the engine's shapes (16 slots, 8 live, lengths 0-2,047
    cut to the table) at table widths 8, 16, 32, 64 and 128 pages: row 1
    (bf16 pool), row 2 (int8 pool) and the g' = 40 fold (bf16); every plan
    timed in turns, forward then backward, each time a CUDA graph of 200
    calls (`chip_smoke.gpu_time_ms`);
  * engine ITL and TTFT through `TorchWorker.generate`: a short wave (16
    requests, prompts of 32-256 tokens) and chip_smoke's standard wave (8
    requests, 32-1,500 tokens), 64 greedy tokens each, over an empty
    prefix cache; every plan in turns, forward then backward, each turn
    after a warm wave that captures the plan's step graphs.

Prints the card's name and power limit, then one JSON line per measurement
and a summary line. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.ops import paged_attention as pa  # noqa: E402

WIDTHS = (8, 16, 32, 64, 128)
HIST = [0, 1, 15, 16, 17, 1000, 2047, 1500] + [0] * 8
SHORT_LENGTHS = np.linspace(32, 256, 16).astype(int)
FOLD_ROWS = 40


def emit(what: str, **fields) -> None:
    print(json.dumps({"what": what, **fields}), flush=True)


class Plans:
    """Switch the kernel's split plan: "span<N>" fixes the span at N
    tokens, "batch_following" is the earlier plan."""

    def __init__(self, spans: list) -> None:
        self.names = [f"span{n}" for n in spans] + ["batch_following"]
        self._plan, self._span = pa.split_plan, pa.SPAN

    def use(self, name: str) -> None:
        if name == "batch_following":
            pa.split_plan, pa.SPAN = cs._batch_following_plan, self._span
        else:
            pa.split_plan, pa.SPAN = self._plan, int(name[len("span"):])

    def restore(self) -> None:
        pa.split_plan, pa.SPAN = self._plan, self._span


def invariance(worker, plans: Plans) -> dict:
    """Per fixed span: slot 0's greedy logits at batch 1 / 8 and width 32 /
    128 against batch 1 / width 32."""
    runner = worker.runner
    ps = runner.config.page_size
    vocab = worker.model_config.vocab_size
    rng = np.random.default_rng(cs.SEED + 11)
    prompts = [rng.integers(1, vocab, n) for n in cs.INVARIANCE_LENGTHS]
    cs._fresh_scheduler(worker)
    narrow = min(cs.INVARIANCE_WIDTHS)
    tables = np.zeros((len(prompts), max(cs.INVARIANCE_WIDTHS)), np.int32)
    firsts = []
    for i, p in enumerate(prompts):
        need = -(-(len(p) + cs.INVARIANCE_STEPS + 1) // ps)
        tables[i, :need] = 1 + i * narrow + np.arange(need)
        firsts.append(runner.prefill_chunk(np.asarray(p, np.int32), 0,
                                           tables[i], len(p),
                                           (0.0, 1.0, 0, 0)))
    out = {}
    for name in plans.names:
        if name == "batch_following":
            continue
        plans.use(name)
        runner.step_graphs.clear()  # the graphs captured the old plan
        base = None
        for width in cs.INVARIANCE_WIDTHS:
            for batch in cs.INVARIANCE_BATCHES:
                tokens, logits = cs._greedy_at(runner, prompts, tables,
                                               firsts, batch, width)
                if base is None:
                    base = (tokens, logits)
                d = cs._first_divergence(base[0], tokens)
                upto = min(d, cs.INVARIANCE_STEPS)
                delta = (float(np.abs(logits[:upto] - base[1][:upto]).max())
                         if upto else 0.0)
                out[f"{name}/B={batch}/W={width}"] = {
                    "max_abs_delta_logits": delta,
                    "first_parting_token": d if d < len(tokens) else None}
        plans.restore()
    runner.step_graphs.clear()
    cs._fresh_scheduler(worker)
    emit("invariance", results=out)
    return out


def kernel_times(dev: torch.device, plans: Plans) -> dict:
    """Rows 1, 2 and the g' = 40 fold at the engine's shapes and each
    width, every plan in turns (forward, then backward)."""
    st = cs._attention_setup(dev, HIST, n_layers=8, n_pages=320)
    qh, kh, hd = st["cfg"].n_q_heads, st["kh"], st["hd"]
    q = torch.randn((len(HIST), qh, hd), generator=st["gen"],
                    device=dev).to(torch.bfloat16)
    q_fold = torch.randn((len(HIST), kh * FOLD_ROWS, hd), generator=st["gen"],
                         device=dev).to(torch.bfloat16)
    cases = (("row1", pa.paged_decode_attention_pool, q, False),
             ("row2", pa.paged_decode_attention_pool, q, True),
             (f"fold_g{FOLD_ROWS}", pa.paged_decode_attention_pool_folded,
              q_fold, False))
    out: dict = {}
    for case, wrapper, qq, quantized in cases:
        kv = st["values"] if quantized else st["pool"]
        scales = st["scales"] if quantized else None
        for width in WIDTHS:
            lens = torch.clamp(st["lens"], max=width * st["ps"])
            tables = st["tables"][:, :width].contiguous()

            def call(i, wrapper=wrapper, qq=qq, kv=kv, scales=scales,
                     tables=tables, lens=lens):
                return wrapper(qq, kv, i % st["n_layers"], tables, lens,
                               kv_scales=scales)

            ms: dict = {n: [] for n in plans.names}
            for name in plans.names + plans.names[::-1]:
                plans.use(name)
                try:
                    ms[name].append(cs.gpu_time_ms(call, 200))
                finally:
                    plans.restore()
            row = {name: float(np.mean(v)) for name, v in ms.items()}
            out[f"{case}[W={width}]"] = row
            emit("kernel", case=case, width=width, ms=row,
                 turns={k: v for k, v in ms.items()})
    del st, q, q_fold
    cs.free_memory()
    return out


def waves(worker, vocab: int) -> dict:
    """The short wave's and the standard wave's bodies."""
    rng = np.random.default_rng(cs.SEED + 17)
    short = [cs._body(f"short-{i}", rng.integers(1, vocab, n), 0.0, 1.0)
             for i, n in enumerate(SHORT_LENGTHS)]
    _, prompts = cs.standard_traffic(vocab)
    standard = [cs._body(f"std-{i}", p, 0.0, 1.0)
                for i, p in enumerate(prompts)]
    return {"short": short, "standard": standard}


def engine_itl(worker, plans: Plans) -> dict:
    """ITL / TTFT of each wave under each plan, in turns."""
    bodies = waves(worker, worker.model_config.vocab_size)
    rows: dict = {n: {w: [] for w in bodies} for n in plans.names}
    streams: dict = {}
    for name in plans.names + plans.names[::-1]:
        plans.use(name)
        try:
            worker.runner.step_graphs.clear()
            cs._fresh_scheduler(worker)
            asyncio.run(cs._serve_wave(worker, bodies["short"]))  # captures
            for wave, wave_bodies in bodies.items():
                cs._fresh_scheduler(worker)
                res = asyncio.run(cs._serve_wave(worker, wave_bodies))
                lat = cs._latency(res)
                rows[name][wave].append(lat)
                emit("engine", plan=name, wave=wave, **lat)
                streams.setdefault(wave, {})[name] = [r["tokens"]
                                                      for r in res]
        finally:
            plans.restore()
    worker.runner.step_graphs.clear()
    cs._fresh_scheduler(worker)
    out = {n: {w: {"itl_ms_mean": float(np.mean(
                       [r["itl_ms_mean"] for r in v])),
                   "ttft_ms_mean": float(np.mean(
                       [r["ttft_ms_mean"] for r in v]))}
               for w, v in by_wave.items()}
           for n, by_wave in rows.items()}
    # greedy streams of the fixed spans against each other (near-ties may
    # part them: summation order differs between spans)
    same = {wave: {n: sum(a == b for a, b in zip(s[plans.names[0]], s[n]))
                   for n in plans.names}
            for wave, s in streams.items()}
    emit("engine_summary", itl=out, streams_equal_to_first_plan=same)
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--spans", default="64,128,256")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_span: needs a CUDA card", file=sys.stderr)
        return 1
    from dynamo_tpu_torch.engine import TorchWorker

    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    plans = Plans([int(s) for s in args.spans.split(",")])
    t0 = time.perf_counter()
    kernels = kernel_times(dev, plans)
    worker = TorchWorker(cs.MODEL, device=dev, seed=cs.SEED)
    worker.start()
    try:
        inv = invariance(worker, plans)
        itl = engine_itl(worker, plans)
    finally:
        worker.scheduler.stop()
    emit("summary", spans=args.spans, kernels=kernels, engine=itl,
         invariant={n: all(not (v["max_abs_delta_logits"]
                                or v["first_parting_token"])
                           for k, v in inv.items() if k.startswith(n + "/"))
                    for n in plans.names if n != "batch_following"},
         seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
