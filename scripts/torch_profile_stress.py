"""Many /debug/profile captures while a worker decodes, on one card.

    python3 scripts/torch_profile_stress.py [--captures 30] [--ms 50]
        [--no-gate]

A profiler stop that ran while a scheduler thread replayed a step graph
once left both threads waiting inside CUDA for good; the launch gate
(`dynamo_tpu_torch/perf/steptrace.py` LaunchGate) keeps the two apart. This
script serves llama3-8b bf16 (random weights, seed 0) from one TorchWorker
on a port DistributedRuntime with its status server, keeps waves of 16
requests decoding one token per step (DYNT_DECODE_BLOCK=1: a graph replay
per token), and takes --captures captures of --ms each through
/debug/profile, one after another: first one on the idle worker, then the
rest under traffic. A capture that has not answered in 60 s prints every
thread's stack and fails the run. --no-gate turns the gate off in this
process (its two holds do nothing), to see what it prevents.

Prints the card's name and power limit, one JSON line per capture (its
start / stop / export seconds, the decode steps it overlapped) and a
summary: the captures, the token gaps seen by the clients with and without
a capture running (the gate holds replays back while a start or stop runs),
and the wall time. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import faulthandler
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

WAVE = 16
PROMPT = 128
TOKENS = 256


def emit(what: str, **fields) -> None:
    print(json.dumps({"what": what, **fields}), flush=True)


async def run(worker, captures: int, ms: int) -> dict:
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    root = tempfile.mkdtemp(prefix="profile_stress_")
    rt = await DistributedRuntime(RuntimeConfig(
        discovery_backend="file", discovery_path=root, tcp_host="127.0.0.1",
        system_enabled=True, system_port=0)).start()
    worker._served, worker._tasks = [], []
    await worker.serve(rt)
    port = rt.status_server.port
    rng = np.random.default_rng(cs.SEED + 23)
    vocab = worker.model_config.vocab_size
    windows: list = []  # (start, end) of each capture, perf_counter
    stamps: list = []
    done = asyncio.Event()

    async def waves() -> int:
        n = 0
        while not done.is_set():
            bodies = [cs._body(f"stress-{n * WAVE + i}",
                               rng.integers(1, vocab, PROMPT), 0.0, 1.0)
                      for i in range(WAVE)]
            for b in bodies:
                b["sampling"]["max_tokens"] = TOKENS
            for res in await cs._serve_wave(worker, bodies):
                stamps.append(res["stamps"])
            n += 1
        return n

    async def capture(i: int) -> dict:
        t0 = time.perf_counter()
        steps0 = worker.runner.decode_steps
        try:
            res = await asyncio.wait_for(cs._http(
                port, "GET", f"/debug/profile?duration_ms={ms}"), 60)
        except asyncio.TimeoutError:
            faulthandler.dump_traceback(all_threads=True)
            raise SystemExit(f"torch_profile_stress: capture {i} hung")
        t1 = time.perf_counter()
        if res["status"] != 200:
            raise SystemExit(f"torch_profile_stress: capture {i} answered "
                             f"{res['status']}: {res['text'][:300]}")
        got = json.loads(res["text"])
        shutil.rmtree(got["trace_dir"], ignore_errors=True)
        windows.append((t0, t1))
        row = {"capture": i, "request_s": t1 - t0,
               "decode_steps_during": worker.runner.decode_steps - steps0,
               **{k: got[k] for k in ("start_s", "stop_s", "export_s")}}
        emit("capture", **row)
        return row

    rows = []
    try:
        rows.append(await capture(0))  # the idle worker
        traffic = asyncio.ensure_future(waves())
        steps0 = worker.runner.decode_steps
        while worker.runner.decode_steps < steps0 + 32:
            if traffic.done():
                traffic.result()  # the waves failed: raise it
            await asyncio.sleep(0.01)
        t_traffic = time.perf_counter()
        for i in range(1, captures):
            rows.append(await capture(i))
            await asyncio.sleep(0.1)
        t_end = time.perf_counter()
        done.set()
        n_waves = await asyncio.wait_for(traffic, 600)
    finally:
        await worker.shutdown()
        await rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    inside, outside = [], []
    for s in stamps:
        for a, b in zip(s, s[1:]):
            if not t_traffic <= a <= t_end:
                continue
            gap = (b - a) * 1e3
            (inside if any(w0 <= b and a <= w1 for w0, w1 in windows[1:])
             else outside).append(gap)
    return {"captures": len(rows), "waves": n_waves,
            "start_s_first": rows[0]["start_s"],
            "start_s_max_later": max(r["start_s"] for r in rows[1:]),
            "stop_s_max": max(r["stop_s"] for r in rows),
            "decode_steps_during_captures": sum(
                r["decode_steps_during"] for r in rows[1:]),
            "token_gap_ms": {
                "during_captures": {
                    "n": len(inside), "median": float(np.median(inside)),
                    "p99": float(np.percentile(inside, 99)),
                    "max": float(np.max(inside))},
                "outside": {
                    "n": len(outside), "median": float(np.median(outside)),
                    "p99": float(np.percentile(outside, 99)),
                    "max": float(np.max(outside))}}}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--captures", type=int, default=30)
    parser.add_argument("--ms", type=int, default=50)
    parser.add_argument("--no-gate", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_stress: needs a CUDA card", file=sys.stderr)
        return 1
    from dynamo_tpu_torch.engine import TorchWorker

    print(cs.nvidia_smi(), flush=True)
    if args.no_gate:
        from dynamo_tpu_torch.perf.steptrace import LAUNCH_GATE

        LAUNCH_GATE.launch = LAUNCH_GATE.exclusive = contextlib.nullcontext
    prof_dir = tempfile.mkdtemp(prefix="profile_stress_traces_")
    os.environ.update(DYNT_PROF_DIR=prof_dir, DYNT_DECODE_BLOCK="1")
    t0 = time.perf_counter()
    try:
        worker = TorchWorker(cs.MODEL, device=torch.device("cuda"),
                             seed=cs.SEED)
        worker.start()
        out = asyncio.run(run(worker, args.captures, args.ms))
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    emit("summary", ms=args.ms, gate=not args.no_gate,
         seconds=time.perf_counter() - t0, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
