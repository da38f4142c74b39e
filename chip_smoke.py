"""Drive the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device    - the card (nvidia-smi name and power limit), torch and CUDA
  build     - nvcc builds every kernel under dynamo_tpu_torch/ops/csrc/ for
              sm_90a, all sources at once
  noise     - the sampler's Gumbel noise (JAX's threefry draw, one fused
              Triton pass; no TPU kernel's port, so not in the kernels
              line) held bit-equal to its plain int64 version at 16 x
              128,256, 16 x 32,768, 80 x 128,256 and ragged shapes, and
              timed beside it and its store bound
  kernels   - the attention kernels at llama3-8b decode shapes, each held
              against its plain PyTorch version, then timed beside it, one
              PyTorch library call for the same function, and its bound:
              the whole-pool kernel on a bf16 and an int8 pool (rows 1-2),
              the same at a speculative chunk's folded width (g' = 20), and
              the one-layer normalized (row 3) and partials (row 4)
              kernels; then the folded pool kernels at g' = 40 (two row
              tiles) and rows 1-2 at a full batch of 16 x 2,047 tokens
              (also timed with the split plan held to one split)
  gemm      - the W8A16 and W4A16 (v2, v1) kernels the same way, at every
              mistral-7b projection geometry, for M = 8, 16, 40, 80 and 512
              (the small-M bodies up to 80 rows, the prefill body above),
              with each kernel's split plan; then ragged M and N (off both
              bodies' tiles) and a split of w_down's K, correctness only
  engine    - the bf16 path: a TorchWorker serving llama3-8b at full width
              (random weights from a fixed seed) answers a prefix-warming
              request, then 8 concurrent requests through `generate`; the
              bf16 decode kernel's launch count must equal 32 x the decode
              forwards run (replays and each capture's eager warm-up
              forward), and no other kernel may launch; every step the
              wave committed splits into host + device == wall (decode-only
              and prefill-carrying steps among them, perf/steptrace.py),
              and the wave's dynamo_mfu and dynamo_roofline_fraction lie in
              (0, 1]
  parity    - one greedy prompt through that runner with the kernels and
              with the plain versions: first-step logits and greedy tokens
  prefill_bf16 - prefill as the reference runs it, on a fresh runner that
              shares the weights: the 25 (batch, bucket) keys captured
              (seconds, graph pool), then chunks of 38, 127, 512 and 1,500
              tokens over 0 and over 1,024 cached tokens (1,500 over 544,
              the most the 2,048-token context leaves), each padded to its
              bucket and one graph replay, against the same padded step
              eagerly (last-row logits bit-equal) and the parent's unpadded
              eager forward (within a tolerance; greedy tokens equal but
              at a near-tie), best of three wall times each way in turns;
              one batched dispatch of 4 rows (32-127 tokens) graphed,
              eagerly and one row at a time
  graphs_bf16 - that runner prewarmed, then the 8 requests served three
              times with CUDA graphs on and three times off, in turns: the
              same streams every run, ITL and memory of each; per-step
              host dispatch and device wall (CUDA events) of the fused
              block and the spec step on and off, and the fused block
              with every slot sampled (temperature 0.8, top_p 0.9); a spec
              step replayed and eager on the same inputs draws the same
              targets
  serve_bf16 - the serving edge on that worker, in this process: the
              port's DistributedRuntime (file discovery in a temporary
              directory, the TCP request plane on 127.0.0.1),
              `worker.serve()` and the port's OpenAI Frontend; the 8
              requests as /v1/completions (token-id prompts, half SSE, half
              aggregate) from an asyncio HTTP client, one warm turn, then
              three direct and three HTTP turns in turns, each admitted
              whole on a new scheduler: every text equals the direct
              stream's decode, usage and [DONE] checked, /metrics'
              dynamo_requests_total moves by the requests sent, a chat
              stream, a stream cut by its client frees its pages; TTFT and
              ITL over HTTP beside direct, the frontend's and the request
              plane's CPU shares
  checkpoint - that worker's weights written as an HF checkpoint
              directory (safetensors shards of at most 5 GB, the index,
              config.json, a generated Llama-3-form tokenizer.json of
              128,256 ids, a chat template; 32 layers, or the first N if
              the disk is short) and served from it: the tokenizer's load,
              encode (1,500 tokens), render and first guided-mask costs;
              `TorchWorker(model_path=...)` in bf16 (config = the preset
              but its name, every leaf equal, the standard traffic's
              greedy streams equal the in-memory worker's, one seeded
              temperature request the same ids twice; write and load
              seconds, GB/s, host RSS and device peaks) and in W4A16 +
              int8 KV (every q4 leaf equal to quantize_params_int4 of the
              in-memory weights, greedy streams equal a worker built from
              those; rows 2 and 6); then the port's frontend in front of
              it: chat requests through the template (the prompt ids the
              worker receives = encode(render(messages)), each text = the
              decode of the worker's ids) and a json_schema request guided
              over the 128,256 ids; the directory is deleted after
  disagg    - disaggregated prefill/decode on that worker: it decodes, and
              a second TorchWorker in mode "prefill" on the same weight
              tensors prefills (its prefill keys captured first); both
              behind a port Frontend whose prefill pool is active. The 8
              requests as streamed /v1/completions over empty caches, once
              with the streamed handoff (DYNT_DISAGG_PIPELINE=1) and once
              serial (0): per request the prefill leg's wall and its first
              kv_transfer_params, the pull's ms, bytes and GB/s, the onboard
              (staged upload) ms, TTFT and ITL. The decode worker prefills 0
              tokens; req-0's pulled pages equal the prefill worker's byte
              for byte; greedy streams equal the aggregated run's or part
              only at a near-tie; every transfer is claimed and the prefill
              pool returns to its free count; row 1 = 32 x decode forwards;
              each request's TTFT split (prefill leg, pull and its frames /
              assembly / staging, onboard) from the flight-recorder
              timelines
  comesh    - co-located disaggregation (`--mode comesh`'s in-process KV
              bridge, engine/ici_transfer.py) on the disagg phase's two
              workers, joined by one IciKvBridge: the same two runs, every
              pull a gather from the prefill pool and an in-place scatter
              into the decode pool on the card (no host copy); bridge hits
              == pulls == 8 in each run, 0 prefill tokens on the decode
              side, req-0's bridged pages byte-equal to the prefill pool's,
              greedy streams equal the aggregated ones or part at a
              near-tie, host + device == wall on every committed step of
              both workers, /debug/requests holding every timeline, and one
              200 ms /debug/profile capture (torch.profiler, CPU and CUDA)
              naming the decode scope; the TTFT split (prefill leg, bridge
              pull: wait / gather / copy, onboard) from the timelines
  batch_invariance - one greedy sequence decoded at batch 1 and 8, table
              widths 32 and 128, with the decode kernel's split plan (a
              128-token span whatever the batch) and with its earlier,
              batch-following plan: max |delta logits| and the first
              parting token of each against batch 1 / width 32 (the port's
              plan must give equal logits in all four); rows 1 and 2 timed
              with each plan at the engine's shapes
  unified   - the same traffic through TorchWorker(attention_fn=
              paged_attention), the reference's unified path: row 3 = 32 x
              decode forwards, row 1 = 0; then greedy parity against the
              default path on the same runner (parity_unified)
  dropins   - that runner with decode_attention_fn = paged_attention_
              decode_fused and spec_attention_fn = paged_attention_spec (row
              4) against the whole-pool path: one verification chunk and 16
              greedy steps; row 4 = 32 x their forwards
  engine_spec - llama3-8b with DYNT_SPEC_ENABLE=1, DYNT_SPEC_MAX_K=4, and
              again with speculation off: the 8 requests plus 4 repetitive
              prompts, then the first of those again, then a greedy
              repetition-penalty request and a guided-regex request on
              repetitive prompts, one at a time; speculation must verify
              drafts, processor slots must ride verification steps (checked
              on the host), every greedy request's first 16 tokens must
              agree on and off (a processor stream may part only at a
              near-tie of its processed logits), and the folded pool
              kernel = 32 x spec forwards
  engine_q  - the quantized path: the same traffic through a TorchWorker
              serving mistral-7b with W4A16 weights (quantized on the card)
              and an int8 KV pool; launches: int8 decode kernel = 32 x
              decode forwards, q4 v2 matmul = (7 x 32 + 1) x all forwards,
              none of the others
  parity_q  - the parity prompt on the quantized runner, kernels (decode
              attention and matmul) against plain versions
  prefill_q - prefill_bf16 on the quantized runner (row 6 at M = the padded
              batch x bucket, launches counted)
  graphs_q  - graphs_bf16 on that runner, plus a spec step at K = 5 (M =
              16 x 6 = 96: the GEMMs' TMA prefill body inside the graph)
  serve_q   - serve_bf16 on that worker (rows 2 and 6 under HTTP)
  logits_q  - logits processors and structured outputs on that worker over
              HTTP, its card naming the hermes tool parser: 8 concurrent
              requests of 256-1,024 tokens (two greedy controls; penalties;
              min_tokens 16 with EOS biased +100; seeded min_p; a chat
              json_schema response_format; a guided choice; a chat with
              tool_choice forcing get_weather), each checked (64 tokens,
              stop after exactly 16, valid JSON, one of the choices, one
              tool call and finish tool_calls); the same requests again
              with CUDA graphs off give the same streams; the graphed turns
              run no eager decode forward and capture nothing; rows 2 and 6
              counted; TTFT and ITL per request, the controls' ITL beside
              the same prompts without processors, host ms per logits step
              by processor, bytes read back per step, the logits keys'
              count, capture seconds and static outputs
  serve_kv  - KV-aware routing: a second mistral-7b W4A16 worker on the
              first's weights, each prewarmed, on its own port runtime
              (file discovery, the TCP request plane, the zmq event plane
              over ZMTP), port Frontends in kv and round_robin mode; 4
              prefixes of 1,024 tokens, wave 1 one request per prefix
              together, wave 2 each prefix twice one at a time, wave 3 the
              same together: wave 1 splits 2 / 2, every wave-2 request
              goes to its prefix's worker with overlap >= 64 blocks, the
              router's trees equal the workers' local indexes,
              clear_kv_blocks empties them, load metrics arrive, a busy
              threshold answers 503, the HTTP texts of waves 1 and 2 equal
              a direct replay; the same waves in round_robin beside; event
              lag and the event plane's CPU share; rows 2 and 6 counted;
              wave 2's prefill tokens exactly its suffixes' (kv) and 4
              prefixes more (round_robin), its TTFT for cache hits and
              misses, each wave's batched prefill dispatches; run three
              times
  resilience - migration, deadlines and admission at full width: a second
              mistral-7b W4A16 worker on the first's weights, each prewarmed
              on its own port runtime with a HealthCheckManager, a port
              Frontend in round_robin; 4 streams of 256 tokens (2 per
              worker), worker B killed once each has 32 tokens (server
              drops its connections, lease revoked, scheduler stopped):
              every stream ends with 256 tokens and the original prompt
              length, each migrated stream is B's tokens before the cut
              then A's replay, equal to a direct continuation on A up to
              a near-tie; B
              restarted and its scheduler frozen with the stream idle
              timeout at 3 s: the streams migrate, B's canaries fail and
              deregister it, its /health answers 503, and it re-registers
              after a thaw; a 1,000 ms deadline ends a long request with
              the in-band 504 and its pages return within one iteration, a
              spent budget gets 503; 48 requests saturate both workers: a
              deadline below the estimated queue wait gets 503 with the
              estimator's Retry-After before any prefill, a generous one is
              admitted, a tenant over DYNT_TENANT_RATE_LIMIT is refused
              while another is served; stall, deregistration and estimate
              against actual wait; rows 2 and 6 counted, no graph captured
  drain     - the drain ladder on the resilience phase's two workers (B
              listed alone while the traffic arrives): 4 streams of
              256-1,024 prompt tokens and 256 out (greedy and seeded) and a
              repetition-penalty request on B, then A serves and, once every
              stream has 64 tokens, POST /drain on B: 4 handoffs (A pulls
              B's packed int8 pages and resumes with 0 prompt tokens
              recomputed) and 1 replay (A prefills its prompt plus its
              generated tokens), every stream 256 tokens, B empty and then
              deregistered, dynamo_drain_state 0 -> 1 -> 2; each handoff's
              stall and bytes, and each stream against the same request
              served undrained on A (greedy ones part only at a near-tie);
              rows 2 and 6 counted
  spec_q    - the spec step at mistral-7b widths, 4 layers, W4A16 + int8
              KV: a runner of 8 slots, all live, 5 positions each (the int8
              pool kernel folded, the q4 v2 kernel at M = 8 x 5 = 40),
              against plain versions
  secondary - mistral-7b widths at 4 layers through the runner: W8A16 with
              int8 KV, and W4A16 under DYNT_Q4_VARIANT=v1; a few greedy
              steps each against the plain versions, launches checked

Every decode, fused block, spec step and prefill chunk (padded to its
bucket) runs as a CUDA-graph replay (`RunnerConfig.cuda_graphs`, on by
default) except where a phase says otherwise; the engine and unified
runners capture each key at its first use on the scheduler thread,
engine_spec and engine_q prewarm first. Each of engine, unified, dropins,
engine_spec, engine_q, spec_q, secondary and the serve phases checks that
it replayed graphs and ran no decode, spec or prefill forward of a
graphable call eagerly, and prints its captures, replays, capture seconds
and peak memory. The parity phases swap the plain versions in on a live runner: the
graph key holds the step functions, so those runs capture their own graphs.

Then one line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and the last line is not printed; a run past 1,100 s (a
hang) prints every thread's stack and exits non-zero. Without a CUDA card, or
without the rest of the repository beside it, the script exits non-zero.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import faulthandler
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HANG_S = 1100  # the whole run's watchdog (it takes 550-600 s)
MODEL = "llama3-8b"
QMODEL = "mistral-7b"
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
L2_BYTES = 50e6
# Kernel vs plain version, unit-normal bf16 inputs, f32 math in both:
KERNEL_TOL = {"normalized": 2e-3, "m": 1e-3, "l_rel": 1e-3}
# GEMM kernel vs plain version, |out - ref| <= tol x max|ref|: both round
# one f32 sum to bf16 (one bf16 ulp is 2^-8 of the value), summed in other
# orders (split-K adds per-split f32 partials). The plain q4 version rounds
# each dequantized weight (u - z) * s to bf16; the q4 kernels do not at
# M <= 80 (they multiply the raw codes and fold the zero point and scale in
# f32 per group) and at M > 80 round (u - z) * bf16(s) to bf16 (s rounded
# to bf16 first), so q4 also differs by those roundings.
GEMM_REL_TOL = {"q8_matmul": 1e-2, "q4_matmul_v2": 2e-2, "q4_matmul_v1": 2e-2}
# mistral-7b's projection geometries (K, N): wq/wo, wk/wv, gate/up, down,
# lm_head.
GEMM_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (4096, 32768))
# A half-full and a full decode batch (the runner's 16 slots), the
# verification chunk of 8 and of 16 slots at K = 4 drafts, a prefill chunk.
GEMM_MS = (8, 16, 40, 80, 512)
# The kernels-line entries of the GEMMs sum the five geometries at M = 8;
# every GEMM row also gets extra cases at the full verification chunk (the
# small-M body's widest) and at a prefill chunk (the prefill body).
GEMM_EXTRA_MS = (80, 512)
# Ragged shapes, correctness only: (K, N, q4 group, Ms). M off the 16-, 48-,
# 80- and 128-row tiles (both bodies), N a multiple of 16 but not of the
# 64- or 128-column tiles; then w_down's K (56 groups of 256, 28 per v2
# half) split unevenly at M <= 80 and through the prefill body at M = 512;
# then the q4 kernels alone at DYNT_Q4_GROUP = 128, where both bodies load
# new scale and zero rows more often (v1's prefill body every other stage).
GEMM_TAILS = ((4096, 1040, 256, (1, 3, 17, 77, 80, 81, 129, 1500)),
              (14336, 1040, 256, (8, 80, 512)),
              (4096, 1040, 128, (80, 129)))
# First-decode-step logits, kernel path vs plain path: the two round the
# attention and projection outputs to bf16 at different points and 32
# layers compound it.
PARITY_LOGITS_REL_TOL = 0.05
# The speculative chunk: DYNT_SPEC_MAX_K = 4 drafts + the committed token.
SPEC_K = 4
SPEC_T = SPEC_K + 1
# Leading greedy tokens that must be identical with speculation on and off.
SPEC_PARITY_TOKENS = 16
# engine_spec's guided request: lower-case a-h and spaces, at least 80
SPEC_GUIDED_REGEX = "[a-h ]{80,}"
# Attention cases beside the six at decode shapes: a fold of 40 rows per
# kv head (llama3-70b's g = 8 at DYNT_SPEC_MAX_K = 4, two row tiles) and
# the runner's full batch of 16 sequences, every history 2,047 tokens.
WIDE_FOLD_ROWS = 40
FULL_BATCH = 16
FULL_HISTORY = 2047

# Where each kernel of the port comes from: name -> (source, TPU kernel).
# The folded entries are rows 1 and 2 at a speculative chunk's width,
# launched through their own wrappers so their launches count apart.
KERNELS = {
    "paged_decode_attention_pool": (
        "dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu",
        "dynamo_tpu/ops/paged_attention.py:297"),
    "paged_decode_attention_pool_int8": (
        "dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu",
        "dynamo_tpu/ops/paged_attention.py:445"),
    "paged_decode_attention_pool_folded": (
        "dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu",
        "dynamo_tpu/ops/paged_attention.py:297"),
    "paged_decode_attention_pool_int8_folded": (
        "dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu",
        "dynamo_tpu/ops/paged_attention.py:445"),
    "paged_decode_attention": (
        "dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu",
        "dynamo_tpu/ops/paged_attention.py:33"),
    "paged_decode_attention_partial": (
        "dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu",
        "dynamo_tpu/ops/paged_attention.py:162"),
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


@contextlib.contextmanager
def knobs(**values: str):
    """Set DYNT_* knobs for the body, then restore what was there."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    from dynamo_tpu_torch.ops import kernel_wrappers

    return kernel_wrappers()


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def reset_runner_counts(runner) -> None:
    """The runner's forward and graph counters to 0, beside reset_counts."""
    runner.decode_steps = runner.spec_steps = runner.prefill_steps = 0
    runner.graph_captures = runner.graph_replays = 0
    runner.graph_capture_s = 0.0
    runner.graph_warm_forwards = {"decode": 0, "spec": 0, "prefill": 0}
    runner.eager_forwards = {"decode": 0, "spec": 0, "prefill": 0}


def launched_forwards(runner) -> dict:
    """Decode and spec forwards that launched kernels since the counters
    were reset: serving forwards, eager or replayed, plus the eager forward
    each graph capture runs first."""
    warm = runner.graph_warm_forwards
    return {"decode": runner.decode_steps + warm["decode"],
            "spec": runner.spec_steps + warm["spec"]}


def graph_report(runner) -> dict:
    """The runner's graph counters and the card's peak memory since the last
    reset_peak_memory_stats, for a phase line."""
    cuda = runner.device.type == "cuda"
    return {"cuda_graphs": runner.config.cuda_graphs,
            "graph_captures": runner.graph_captures,
            "graph_replays": runner.graph_replays,
            "graph_capture_s": runner.graph_capture_s,
            "graph_warm_forwards": dict(runner.graph_warm_forwards),
            "eager_forwards": dict(runner.eager_forwards),
            "graph_keys": len(runner.step_graphs),
            "graph_keys_prefill": sum(key[0].startswith("prefill")
                                      for key in runner.step_graphs),
            "graph_pool_GB": runner.graph_memory_bytes() / 1e9,
            "max_memory_allocated_GB": (torch.cuda.max_memory_allocated() / 1e9
                                        if cuda else None),
            "memory_reserved_GB": (torch.cuda.memory_reserved() / 1e9
                                   if cuda else None)}


def check_graphed(runner, label: str) -> None:
    """A graphed phase replayed graphs and ran no decode, spec or prefill
    forward of a graphable call eagerly: every prefill chunk was one
    replay."""
    check(runner.config.cuda_graphs and runner.graph_replays > 0,
          f"{label}: no graph replay (cuda_graphs="
          f"{runner.config.cuda_graphs})")
    check(runner.eager_forwards == {"decode": 0, "spec": 0, "prefill": 0},
          f"{label}: eager forwards on graphable keys {runner.eager_forwards}")


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


def attention_kernels(runner) -> tuple:
    """(decode kernel, spec kernel) one forward of `runner` launches per
    layer, by the attention functions it runs."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    int8 = "_int8" if isinstance(runner.kv_cache, tuple) else ""
    if runner.attention_fn is not None:  # the unified forward
        return (None if int8 else "paged_decode_attention"), None
    decode = {pa.paged_attention_decode_pool:
              f"paged_decode_attention_pool{int8}",
              pa.paged_attention_decode_fused:
              "paged_decode_attention_partial"}.get(runner.decode_attention_fn)
    spec = {pa.paged_attention_spec_pool:
            f"paged_decode_attention_pool{int8}_folded",
            pa.paged_attention_spec: "paged_decode_attention_partial"}.get(
                runner.spec_attention_fn)
    return decode, spec


def expected_counts(runner, dev: torch.device, decode: int = 0,
                    prefill: int = 0, spec: int = 0, warm=None) -> dict:
    """Launches per kernel for the forwards run: each layer of a decode
    (spec) forward launches the decode (spec) attention kernel once (of a
    unified forward, the row-3 kernel: decode is its only T = 1 forward,
    since every prefill chunk is padded to a bucket of 8 or more tokens);
    each quantized projection launches its matmul kernel once per forward,
    whatever its M (the padded batch x bucket of a prefill forward). `warm`
    adds the graph captures' eager forwards ({"decode": n, "spec": n,
    "prefill": n}, the runner's `graph_warm_forwards`), which launch as any
    forward does; a replay counts as the forward it replays."""
    want = {name: 0 for name in counters()}
    if dev.type != "cuda":
        return want
    if warm is not None:
        decode += warm["decode"]
        spec += warm["spec"]
        prefill += warm["prefill"]
    n_layers = runner.model_config.n_layers
    decode_kernel, spec_kernel = attention_kernels(runner)
    if decode_kernel is not None:
        want[decode_kernel] += n_layers * decode
    if spec_kernel is not None:
        want[spec_kernel] += n_layers * spec
    for name, n in matmul_kernels_per_forward(runner).items():
        want[name] = n * (decode + prefill + spec)
    return want


def kernel_entry(name: str, max_abs_err: float, ms: float, plain_ms: float,
                 library_ms, n_bytes: float, flops: float,
                 label: str = None) -> dict:
    """One entry of the kernels line for wrapper `name`; `label` names an
    extra case of the same kernel (its shape in brackets)."""
    source, replaces = KERNELS[name]
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"name": label or name, "route": "cuda", "source": source,
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
    ptxas = []  # per kernel: its (mangled) name, registers and spills
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            ptxas += [ln.split("info    :")[-1].strip()
                      for ln in log.read_text().splitlines()
                      if "Compiling entry function" in ln
                      or "registers" in ln or "spill" in ln]
    emit("build", seconds=round(secs, 3),
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()],
         ptxas=ptxas)


def _attention_setup(dev: torch.device, hist: list, n_layers: int,
                     n_pages: int) -> dict:
    """llama3-8b attention inputs: a random bf16 pool of `n_layers` layers
    and the same pool quantized to int8 by the port's quantize_kv, one
    block table row per history length (distinct random pages; unused
    slots point at scratch page 0, as the scheduler's tables do)."""
    from dynamo_tpu_torch.models import get_config
    from dynamo_tpu_torch.models.transformer import quantize_kv

    cfg = get_config(MODEL)
    kh, hd, ps, max_pages = cfg.n_kv_heads, cfg.head_dim, 16, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pool = torch.randn((n_layers, 2, n_pages, ps, kh, hd), generator=gen,
                       device=dev).to(torch.bfloat16)
    perm = np.random.default_rng(SEED).permutation(np.arange(1, n_pages))
    table_np = np.zeros((len(hist), max_pages), np.int32)
    used = 0
    for i, h in enumerate(hist):
        n = -(-h // ps)
        table_np[i, :n] = perm[used:used + n]
        used += n
    values, scales = quantize_kv(pool)
    return {"cfg": cfg, "gen": gen, "hist": hist, "n_layers": n_layers,
            "kh": kh, "hd": hd, "ps": ps, "max_pages": max_pages,
            "pool": pool, "values": values, "scales": scales,
            "tables": torch.from_numpy(table_np).to(dev),
            "lens": torch.tensor(hist, dtype=torch.int32, device=dev)}


def _attention_case(dev: torch.device, st: dict, name: str, label: str,
                    qq: torch.Tensor, kind: str, quantized: bool,
                    one_split: bool = False) -> dict:
    """One attention case: the kernel of wrapper `name` held against its
    plain version (reading layer 1), then timed beside it, SDPA over the
    gathered K/V, and its bound. kind: "pool" (rows 1-2 and folded), "norm"
    (row 3) or "partial" (row 4). With `one_split` the kernel is also timed
    with the split plan held to one split per sequence (the (B, kh) grid
    alone), so the plan's cost shows. Returns the kernels-line entry."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    hist, n_layers, tables, lens = (st["hist"], st["n_layers"],
                                    st["tables"], st["lens"])
    kh, hd, ps, max_pages = st["kh"], st["hd"], st["ps"], st["max_pages"]
    pool = st["pool"]
    kv, kv_scales = ((st["values"], st["scales"]) if quantized
                     else (pool, None))
    if kind == "pool":  # the int8 wrappers count launches, the bf16 ones
        # dispatch on kv_scales
        wrapper = (pa.paged_decode_attention_pool_folded if "folded" in name
                   else pa.paged_decode_attention_pool)

        def kernel_call(layer):
            return wrapper(qq, kv, layer, tables, lens, kv_scales=kv_scales)

        def plain_call(layer):
            return pa.paged_decode_attention_pool_ref(qq, kv, layer, tables,
                                                      lens, kv_scales)
    else:
        wrapper = getattr(pa, name)
        plain = (pa.paged_decode_attention_ref if kind == "norm"
                 else pa.paged_decode_attention_partial_ref)

        def kernel_call(layer):
            return wrapper(qq, pool[layer, 0], pool[layer, 1], tables, lens)

        def plain_call(layer):
            return plain(qq, pool[layer, 0], pool[layer, 1], tables, lens)
    b, rows = qq.shape[0], qq.shape[1]
    norm = kind == "norm"
    empty = lens == 0
    live = ~empty
    # 1. correctness against the plain version, reading layer 1
    out = kernel_call(1)
    torch.cuda.synchronize()
    ref = plain_call(1)
    if norm:
        check(bool(torch.all(out[empty] == 0)),
              f"{label}: zero-length rows must be 0")
        err = {"normalized": float((out[live].float()
                                    - ref[live].float()).abs().max())}
    else:
        acc, m, l = out
        r_acc, r_m, r_l = ref
        check(bool(torch.all(torch.isneginf(m[empty]))
                   and torch.all(l[empty] == 0)
                   and torch.all(acc[empty] == 0)),
              f"{label}: zero-length rows must be m=-inf, l=0, acc=0")
        err = {
            "normalized": float((acc[live] / l[live][..., None]
                                 - r_acc[live] / r_l[live][..., None])
                                .abs().max()),
            "m": float((m[live] - r_m[live]).abs().max()),
            "l_rel": float(((l[live] - r_l[live]).abs()
                            / r_l[live]).max()),
        }
    for key, val in err.items():
        check(val <= KERNEL_TOL[key],
              f"{label} {key} error {val} > {KERNEL_TOL[key]}")
    del out, ref

    # 2. timing: each call reads another layer, so the layers' history
    #    cycles through the 50 MB L2 cold, as in a decode step
    ms = gpu_time_ms(lambda i: kernel_call(i % n_layers), 200)
    plain_ms = gpu_time_ms(lambda i: plain_call(i % n_layers), 20)
    extra = {}
    if one_split:
        span = pa.SPAN
        pa.SPAN = pa.MAX_SPAN  # one span covers the whole table
        try:
            extra["ms_one_split"] = gpu_time_ms(
                lambda i: kernel_call(i % n_layers), 200)
        finally:
            pa.SPAN = span

    # one library call for the same attention: SDPA over the gathered,
    # contiguous (dequantized) K/V (the port never calls it)
    ctx = max_pages * ps
    mask = (torch.arange(ctx, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]  # [B, 1, 1, ctx]
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
    q4d = qq[:, :, None, :]  # [B, rows, 1, hd]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(i):
        k, v = gathered[i % n_layers]
        sdpa(q4d, k, v, attn_mask=mask, enable_gqa=True)

    library_ms = gpu_time_ms(library, 50)
    del gathered

    # bound: history K+V rows (and their scales) read once, q / tables /
    # lengths read once, outputs (bf16, or f32 partials with m and l)
    # written once; flops of q.k and p.v
    n_hist = sum(hist)
    n_table = sum(-(-h // ps) for h in hist)
    elt = 1 if quantized else 2
    out_bytes = b * rows * hd * 2 if norm else (b * rows * hd * 4
                                                + 2 * b * rows * 4)
    n_bytes = (n_hist * kh * hd * 2 * elt
               + (n_hist * 2 * 2 if quantized else 0)
               + b * rows * hd * 2 + n_table * 4 + b * 4 + out_bytes)
    flops = 4 * rows * hd * n_hist
    entry = kernel_entry(name, err["normalized"], ms, plain_ms, library_ms,
                         n_bytes, flops, label=label)
    plan = pa.split_plan(b, kh, rows // kh, max_pages, ps)
    emit("kernels", shapes={"B": b, "q_rows": rows, "kh": kh, "hd": hd,
                            "ps": ps, "max_pages": max_pages,
                            "lengths": hist if len(set(hist)) > 1 else
                            f"{len(hist)} x {hist[0]}",
                            "layers": n_layers, "read_layer": 1},
         split_plan=plan._asdict(), errors=err, tolerances=KERNEL_TOL,
         bytes=n_bytes, flops=flops, kernel_ms=ms,
         achieved_GBps=n_bytes / (ms * 1e-3) / 1e9, **extra, **entry)
    return entry


NOISE_SHAPES = ((16, 128256), (16, 32768), (80, 128256), (3, 1000), (1, 7))


def phase_noise(dev: torch.device) -> None:
    """The sampler's Gumbel noise (`ops.gumbel`): the fused Triton pass
    against its plain int64 version, bit for bit, at the decode batch
    (16 slots) over llama3-8b's and mistral-7b's vocabularies, a spec
    step's 16 x 5 rows, and ragged small shapes; then both timed at 16 x
    128,256 beside the least time for its store (B * V * 4 bytes). The pass
    replaces no TPU kernel, so it stays out of the kernels line."""
    from dynamo_tpu_torch.ops import gumbel

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    out = {}
    for b, v in NOISE_SHAPES:
        seeds = torch.randint(0, 2**32, (b,), generator=gen, device=dev,
                              dtype=torch.int64)
        steps = torch.randint(0, 5000, (b,), generator=gen, device=dev,
                              dtype=torch.int64)
        got = gumbel.gumbel_noise(seeds, steps, v)
        want = gumbel.gumbel_noise_ref(seeds, steps, v)
        torch.cuda.synchronize()
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        check(n_diff == 0 and bool(torch.isfinite(got).all()),
              f"noise {b} x {v}: {n_diff} values differ from the plain "
              "version")
        out[f"{b}x{v}"] = {"bit_equal": True}
        if (b, v) == NOISE_SHAPES[0]:
            out["ms"] = gpu_time_ms(
                lambda i: gumbel.gumbel_noise(seeds, steps, v), 50)
            out["plain_ms"] = gpu_time_ms(
                lambda i: gumbel.gumbel_noise_ref(seeds, steps, v), 10)
            out["bound_ms"] = b * v * 4 / HBM_BYTES_PER_S * 1e3
    emit("noise", route="triton", source="dynamo_tpu_torch/ops/gumbel.py",
         shapes=out)


def phase_kernels(dev: torch.device) -> list:
    """The attention kernels at llama3-8b decode shapes: B = 8, qh = 32,
    kh = 8, hd = 128, ps = 16, 128-page tables, mixed lengths. Rows 1 and 2
    (bf16 pool, and the same pool quantized to int8 by the port's
    quantize_kv), the same two at a speculative chunk's folded width
    (g' = (DYNT_SPEC_MAX_K + 1) * g = 20 query rows per kv head), row 3
    (normalized, one layer's slices, lengths including the current token)
    and row 4 (partials, one layer's slices). Then the
    folded pool kernels at g' = 40 (llama3-70b's g = 8 at K = 4: two row
    tiles), and rows 1 and 2 at the runner's full batch of 16 sequences of
    2,047 tokens each. Each is held against its plain version, then timed
    beside it, one PyTorch library call for the same function, and its
    bound."""
    st = _attention_setup(dev, [0, 1, 15, 16, 17, 1000, 2047, 1500],
                          n_layers=8, n_pages=320)
    qh, hd, b, gen = st["cfg"].n_q_heads, st["hd"], len(st["hist"]), st["gen"]
    q = torch.randn((b, qh, hd), generator=gen, device=dev).to(torch.bfloat16)
    q_fold = torch.randn((b, qh * SPEC_T, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
    q_wide = torch.randn((b, st["kh"] * WIDE_FOLD_ROWS, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
    cases = (
        ("paged_decode_attention_pool", None, q, "pool", False),
        ("paged_decode_attention_pool_int8", None, q, "pool", True),
        ("paged_decode_attention_pool_folded", None, q_fold, "pool", False),
        ("paged_decode_attention_pool_int8_folded", None, q_fold, "pool",
         True),
        ("paged_decode_attention", None, q, "norm", False),
        ("paged_decode_attention_partial", None, q, "partial", False),
        ("paged_decode_attention_pool_folded", f"g'={WIDE_FOLD_ROWS}",
         q_wide, "pool", False),
        ("paged_decode_attention_pool_int8_folded", f"g'={WIDE_FOLD_ROWS}",
         q_wide, "pool", True),
    )
    results = [_attention_case(dev, st, name,
                               f"{name}[{tag}]" if tag else name, qq, kind,
                               quantized)
               for name, tag, qq, kind, quantized in cases]
    del st, q, q_fold, q_wide
    free_memory()

    full = _attention_setup(dev, [FULL_HISTORY] * FULL_BATCH, n_layers=4,
                            n_pages=FULL_BATCH * 128 + 1)
    q_full = torch.randn((FULL_BATCH, qh, hd), generator=full["gen"],
                         device=dev).to(torch.bfloat16)
    for name, quantized in (("paged_decode_attention_pool", False),
                            ("paged_decode_attention_pool_int8", True)):
        results.append(_attention_case(
            dev, full, name, f"{name}[B={FULL_BATCH}]", q_full, "pool",
            quantized, one_split=True))
    del full, q_full
    free_memory()
    return results


def phase_gemms(dev: torch.device) -> list:
    """q8_matmul, q4_matmul_v2 and q4_matmul_v1 at mistral-7b's projection
    geometries for every M of GEMM_MS, against their plain versions. Each
    timed call reads another copy of the packed weight (enough copies to
    exceed the L2 twice over), so weights come from HBM as in a decode
    step. The kernels-line numbers are the sums over the five geometries
    at M = 8 (one of each projection, decode shapes), and also at each M
    of GEMM_EXTRA_MS ("name[M=80]", "name[M=512]"); one "gemm_sums" line
    gives every kernel's sums at every M beside torch.matmul's and the
    bound."""
    from dynamo_tpu_torch.ops import q4_linear as q4l
    from dynamo_tpu_torch.ops import q8_linear as q8l

    def plan_of(name, m, k, n, leaf):
        if name == "q8_matmul":
            return q8l.q8_split_plan(m, n, k)._asdict()
        q4, qs4 = leaf[0], leaf[1]
        return q4l.q4_split_plan(m, n, k, k // qs4.shape[0],
                                 q4l.pack_version(q4))._asdict()

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    kernels = {"q8_matmul": (q8l.q8_matmul, q8l.q8_matmul_ref),
               "q4_matmul_v2": (q4l.q4_matmul_v2, q4l.q4_matmul_ref),
               "q4_matmul_v1": (q4l.q4_matmul_v1, q4l.q4_matmul_ref)}
    totals = {(name, m): {"err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                          "library_ms": 0.0, "bytes": 0.0, "flops": 0.0}
              for name in kernels for m in GEMM_MS}
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
                plan = plan_of(name, m, k, n, args)
                emit("gemm", name=name, K=k, N=n, M=m, max_abs_err=err,
                     max_abs_ref=scale, tolerance_rel=GEMM_REL_TOL[name],
                     ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bytes=n_bytes, flops=flops,
                     weight_copies=len(copies), plan=plan,
                     achieved_GBps=n_bytes / (ms * 1e-3) / 1e9,
                     achieved_TFLOPs=flops / (ms * 1e-3) / 1e12)
                tot = totals[(name, m)]
                tot["err"] = max(tot["err"], err)
                tot["ms"] += ms
                tot["plain_ms"] += plain_ms
                tot["library_ms"] += library_ms
                tot["bytes"] += n_bytes
                tot["flops"] += flops
            del copies, lib, deq
        del leaves
        free_memory()
    for k, n, group, ms_tail in GEMM_TAILS:
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        tails, plans = {}, {}
        with knobs(DYNT_Q4_GROUP=str(group)):
            leaves = [("q4_matmul_v2", q4l.quantize_weight_q4(w, 1, 2)),
                      ("q4_matmul_v1", q4l.quantize_weight_q4(w, 1, 1))]
        check(all(k // leaf["qs4"].shape[0] == group for _, leaf in leaves),
              f"q4 tails at K={k}: not quantized in groups of {group}")
        if group == q4l.PACK_BLOCK:
            leaves.insert(0, ("q8_matmul", q8l.quantize_weight(w, 1)))
        for name, leaf in leaves:
            kernel_fn, plain_fn = kernels[name]
            for m in ms_tail:
                x = torch.randn((m, k), generator=gen,
                                device=dev).to(torch.bfloat16)
                out = kernel_fn(x, *leaf.values())
                torch.cuda.synchronize()
                ref = plain_fn(x, *leaf.values())
                err = float((out.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                check(bool(torch.isfinite(out).all())
                      and err <= GEMM_REL_TOL[name] * scale,
                      f"{name} K={k} N={n} M={m}: max|d| {err} > "
                      f"{GEMM_REL_TOL[name]} x {scale}")
                tails[f"{name} M={m}"] = err / scale
                plans[f"{name} M={m}"] = plan_of(name, m, k, n,
                                                 tuple(leaf.values()))
        emit("gemm_tails", K=k, N=n, group=group, rel_errors=tails,
             plans=plans)
        del w
    sums = {}
    for (name, m), t in totals.items():
        bound = max(t["bytes"] / HBM_BYTES_PER_S,
                    t["flops"] / BF16_FLOPS) * 1e3
        sums[f"{name} M={m}"] = {
            "ms": t["ms"], "library_ms": t["library_ms"], "bound_ms": bound,
            "x_library": t["ms"] / t["library_ms"], "x_bound": t["ms"] / bound}
    emit("gemm_sums", geometries=len(GEMM_SHAPES), sums=sums)
    worst = {}  # each kernel's largest error over every M
    for (name, _), t in totals.items():
        worst[name] = max(worst.get(name, 0.0), t["err"])
    entries = [kernel_entry(name, worst[name], t["ms"], t["plain_ms"],
                            t["library_ms"], t["bytes"], t["flops"])
               for (name, m), t in totals.items() if m == GEMM_MS[0]]
    entries += [kernel_entry(name, t["err"], t["ms"], t["plain_ms"],
                             t["library_ms"], t["bytes"], t["flops"],
                             label=f"{name}[M={m}]")
                for (name, m), t in totals.items() if m in GEMM_EXTRA_MS]
    return entries


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


async def _serve_wave(worker, bodies: list, hold: bool = False) -> list:
    """Stream `bodies` concurrently through `generate`. With `hold` the
    scheduler thread starts only once every request has been submitted, so
    the whole wave is admitted in one iteration and two runs of it chunk
    their prefills identically."""
    tasks = [asyncio.ensure_future(_stream(worker, b)) for b in bodies]
    if hold:
        await asyncio.sleep(0)  # each generate() has submitted its request
        worker.scheduler.start()
    return await asyncio.gather(*tasks)


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


def _processor_bodies(prompts, prefix: str) -> list:
    """engine_spec's processor requests on repetitive prompts, greedy, 64
    tokens: a repetition penalty, and a guided regex whose 80-character
    minimum keeps EOS out of the 64 tokens."""
    from dynamo_tpu_torch.llm.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    kinds = [({"repetition_penalty": 1.3}, []),
             ({}, [{"name": "guided", "args": {"regex": SPEC_GUIDED_REGEX}}])]
    return [PreprocessedRequest(
        request_id=f"{prefix}-{i}", token_ids=[int(t) for t in p],
        sampling=SamplingOptions(max_tokens=64, temperature=0.0, seed=i,
                                 **sampling),
        stop=StopConditions(ignore_eos=True),
        logits_processors=procs).to_wire()
        for i, (p, (sampling, procs)) in enumerate(zip(prompts, kinds))]


def _bodies(prompts, prefix: str) -> list:
    """Half greedy (even i), half temperature 0.8 / top_p 0.9; the seed is
    i, so two waves of one prefix-free index draw alike."""
    return [_body(f"{prefix}-{i}", p, 0.0 if i % 2 == 0 else 0.8,
                  1.0 if i % 2 == 0 else 0.9) for i, p in enumerate(prompts)]


def _greedy(rid: str) -> bool:
    return int(rid.split("-")[-1]) % 2 == 0


def standard_traffic(vocab: int):
    """(warm-up prompt, 8 prompts of 32-1500 tokens; the first two share the
    warm-up's 512-token prefix)."""
    rng = np.random.default_rng(SEED + 1)
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
    return warm, prompts


def repetitive_traffic(vocab: int, n: int = 4):
    """n prompts of 240 tokens, each one 6-token pattern repeated."""
    rng = np.random.default_rng(SEED + 5)
    return [np.tile(rng.integers(1, vocab, 6), 40) for _ in range(n)]


def _latency(results) -> dict:
    ttft = [(r["stamps"][0] - r["t0"]) * 1e3 for r in results]
    itl = [(r["stamps"][-1] - r["stamps"][0]) * 1e3 / (len(r["tokens"]) - 1)
           for r in results]
    return {"ttft_ms_mean": float(np.mean(ttft)),
            "ttft_ms_max": float(np.max(ttft)),
            "itl_ms_mean": float(np.mean(itl))}


def phase_engine(dev: torch.device, model=None, runner_config=None,
                 label: str = "engine", attention_fn=None,
                 prewarm: bool = False):
    """A main path: TorchWorker.generate at full width, every decode step a
    graph replay. With `prewarm` the runner captures its whole key space
    before serving; without, the scheduler thread captures each key at its
    first use, inside the run. Returns the worker (scheduler still
    running), the kernel launches counted in the run, after checking them
    against the forwards the runner ran, and the served token streams by
    request id."""
    from dynamo_tpu_torch.engine import TorchWorker

    t0 = time.perf_counter()
    before_gb = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 1e9
    worker = TorchWorker(model or MODEL, runner_config, device=dev, seed=SEED,
                         attention_fn=attention_fn)
    if prewarm:
        worker.runner.prewarm()
        prewarm_captures = worker.runner.graph_captures
        worker.scheduler.start()
    else:
        worker.start()
        prewarm_captures = None
    init_s = time.perf_counter() - t0
    cfg = worker.model_config
    runner = worker.runner
    sched = worker.scheduler
    vocab = cfg.vocab_size
    warm, prompts = standard_traffic(vocab)

    # counts to zero just before the main path
    reset_counts()
    reset_runner_counts(runner)

    async def serve():
        first = await _stream(worker, _body("warm-0", warm, 0.0, 1.0))
        prefilled0 = sched.stats.prefill_tokens
        # the live gauges' interval starts here (perf/steptrace.py)
        worker.publish_steptrace_metrics()
        start = time.perf_counter()
        results = await _serve_wave(worker, _bodies(prompts, "req"))
        wall = time.perf_counter() - start
        return first, results, wall, sched.stats.prefill_tokens - prefilled0

    with _DecodeEvents(worker) as events:
        warm_res, results, wall, prefilled = asyncio.run(serve())
    roofline = _roofline_gauges(label, worker, events)
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
    check(cached == 2 * 512,
          f"prefix cache reused {cached} tokens, expected {2 * 512}")
    want = expected_counts(runner, dev, decode=decode_forwards,
                           prefill=prefill_forwards,
                           warm=runner.graph_warm_forwards)
    check(decode_forwards > 0 and prefill_forwards > 0 and launches == want,
          f"{label}: kernel launches {launches} != expected {want} for "
          f"{decode_forwards} decode and {prefill_forwards} prefill forwards "
          f"and graph warm-up forwards {runner.graph_warm_forwards}")
    check_graphed(runner, label)
    if prewarm:
        check(runner.graph_captures == 0,
              f"{label}: {runner.graph_captures} captures after prewarm")
    rc = runner.config
    emit(label, model=cfg.name, layers=cfg.n_layers, hidden=cfg.hidden,
         vocab=vocab, weight_dtype=rc.weight_dtype, kv_dtype=rc.kv_dtype,
         attention_fn=getattr(attention_fn, "__name__", None),
         init_and_warmup_s=init_s, requests=len(results),
         prompt_lengths=[len(p) for p in prompts],
         prefix_cached_tokens=cached, decode_forwards=decode_forwards,
         prefill_forwards=prefill_forwards,
         prefill_batched_steps=sched.stats.prefill_batched_steps,
         kernel_launches=launches,
         decode_block=sched.decode_block, decode_pipeline=sched.decode_pipeline,
         **_latency(results),
         output_tokens_per_s=sum(len(r["tokens"]) for r in results) / wall,
         wall_s=wall, prewarm=prewarm, prewarm_captures=prewarm_captures,
         **graph_report(runner), memory_allocated_before_GB=before_gb,
         steptrace=roofline)
    served = {f"req-{i}": r["tokens"] for i, r in enumerate(results)}
    return worker, launches, served


def _gauge(name: str, worker) -> float:
    """A per-worker gauge's value from the port's metrics registry."""
    from dynamo_tpu_torch.runtime import metrics

    key = f'{name}{{worker="{worker.instance_id:x}"}} '
    for line in metrics.render().decode().splitlines():
        if line.startswith(key):
            return float(line[len(key):])
    raise SystemExit(f"chip_smoke: {key.strip()} was never published")


def _roofline_gauges(label: str, worker, events: _DecodeEvents) -> dict:
    """Over the wave just served: every committed step splits into host +
    device == wall (decode-only and prefill-carrying steps among them); the
    decode windows agree with the card's CUDA events (`events`,
    `_check_decode_windows`); dynamo_mfu and dynamo_roofline_fraction of the
    interval lie in (0, 1] (perf/steptrace.py LiveRoofline against the
    H100's data sheet), and so does the fraction before the gauge clamps
    it: the interval's roofline time over its measured device time, at most
    1.05."""
    sched = worker.scheduler
    t = time.perf_counter()
    while (sched.steptrace.steps != sched.stats.steps
           or sched.queue_depth() != (0, 0)):  # the last step's commit
        check(time.perf_counter() - t < 30, f"{label}: steps uncommitted")
        time.sleep(0.001)
    samples = sched.steptrace.drain_samples()
    windows = {kind: _steptrace_windows(label, samples, kind)
               for kind in ("decode", "prefill")}
    prev = worker._roof_prev  # the interval's start (phase_engine)
    worker.publish_steptrace_metrics()
    cur = worker._roof_prev
    ideal_s = worker._roofline.ideal_s(
        prefill_tokens=cur[0] - prev[0], decode_steps=cur[2] - prev[2],
        active_kv_tokens=sched.active_kv_tokens())
    out = {"windows": windows,
           "decode_windows": _check_decode_windows(label, events),
           "chip": worker._roofline.chip.name,
           "mfu": _gauge("dynamo_mfu", worker),
           "roofline_fraction": _gauge("dynamo_roofline_fraction", worker),
           "roofline_fraction_unclamped": ideal_s / (
               (cur[3] - prev[3]) / 1e3),
           "host_bound": _gauge("dynamo_host_bound", worker)}
    # (on the CPU the gauges compare against the cpu stand-in spec)
    check(worker.device.type != "cuda" or (
        0 < out["mfu"] <= 1 and 0 < out["roofline_fraction"] <= 1
        and 0 < out["roofline_fraction_unclamped"] <= 1.05),
          f"{label}: dynamo_mfu {out['mfu']}, dynamo_roofline_fraction "
          f"{out['roofline_fraction']} (unclamped "
          f"{out['roofline_fraction_unclamped']}) outside (0, 1]")
    return out


def _first_divergence(a: list, b: list) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


@contextlib.contextmanager
def _host_margins():
    """Record, for every greedy host sample of the scheduler (the processor
    path), the gap between the processed row's two largest logits, keyed
    by (seed, step): where two runs' processor streams part, this says
    whether the step was a near-tie that rounding can flip."""
    from dynamo_tpu_torch.engine import scheduler

    margins = {}
    plain = scheduler.host_sample

    def recording(row, temperature, top_p, top_k, seed, step):
        if temperature <= 0.0:
            margins[(int(seed), int(step))] = _near_tie(row)
        return plain(row, temperature, top_p, top_k, seed, step)

    scheduler.host_sample = recording
    try:
        yield margins
    finally:
        scheduler.host_sample = plain


def _spec_run(dev: torch.device, spec: bool) -> dict:
    """One llama3-8b worker with DYNT_SPEC_ENABLE on or off, DYNT_SPEC_MAX_K
    = 4: wave 1 is the standard 8 requests plus 4 repetitive prompts,
    admitted together; wave 2 repeats the first repetitive request (same
    prompt and seed), which the cross-request lookahead then drafts from
    wave 1; then the two processor requests of `_processor_bodies` on the
    second and third repetitive prompts, one at a time (with speculation on
    they ride verification steps, checked on the host, _commit_spec_host).
    Every wave is admitted whole, so the run is the same every time: which
    steps speculate, and so where the verification forward's rounding meets
    the decode forward's, does not depend on host timing."""
    from dynamo_tpu_torch.engine import TorchWorker

    torch.cuda.reset_peak_memory_stats()
    with knobs(DYNT_SPEC_ENABLE="1" if spec else "0",
               DYNT_SPEC_MAX_K=str(SPEC_K)):
        worker = TorchWorker(MODEL, device=dev, seed=SEED)
        # the scheduler starts with wave 1 (_serve_wave hold)
        worker.runner.prewarm()
    runner, sched = worker.runner, worker.scheduler
    prewarm_captures = runner.graph_captures
    check(sched.spec_enabled == spec and sched.spec_k == SPEC_K,
          f"spec knobs not applied: enabled={sched.spec_enabled}")
    check(spec == any(key[0] == "decode_spec" for key in runner.step_graphs),
          f"prewarm with speculation {'on' if spec else 'off'} captured "
          f"{sorted(key[:4] for key in runner.step_graphs)}")
    vocab = worker.model_config.vocab_size
    _, prompts = standard_traffic(vocab)
    rep = repetitive_traffic(vocab)
    wave1 = _bodies(prompts, "req") + _bodies(rep, "rep")
    wave2 = _bodies(rep[:1], "rep2")
    procs = _processor_bodies(rep[1:3], "proc")

    # counts to zero just before the main path
    reset_counts()
    reset_runner_counts(runner)

    async def serve():
        start = time.perf_counter()
        first = await _serve_wave(worker, wave1, hold=True)
        second = await _serve_wave(worker, wave2)
        for body in procs:
            second += await _serve_wave(worker, [body])
        return first, second, time.perf_counter() - start

    try:
        with _host_margins() as margins:
            first, second, wall = asyncio.run(serve())
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        worker.close()
    check(sched.error is None, f"scheduler error {sched.error!r}")
    streams = {}
    for body, res in zip(wave1 + wave2 + procs, first + second):
        check(res["finish"] == ["length"] and len(res["tokens"]) == 64,
              f"{body['request_id']}: finish {res['finish']}, "
              f"{len(res['tokens'])} tokens")
        streams[body["request_id"]] = res["tokens"]
    forwards = {"decode": runner.decode_steps, "spec": runner.spec_steps,
                "prefill": runner.prefill_steps}
    label = f"engine_spec (spec {'on' if spec else 'off'})"
    want = expected_counts(runner, dev, **forwards,
                           warm=runner.graph_warm_forwards)
    check(launches == want,
          f"{label}: kernel launches {launches} != expected {want} for "
          f"forwards {forwards}, warm-up {runner.graph_warm_forwards}")
    check_graphed(runner, label)
    check(runner.graph_captures == 0,
          f"{label}: {runner.graph_captures} captures after prewarm")
    out = {"streams": streams, "stats": dataclasses.asdict(sched.stats),
           "margins": margins,
           "launches": launches, "forwards": forwards, "wall_s": wall,
           "graphs": {**graph_report(runner),
                      "prewarm_captures": prewarm_captures},
           **_latency(first)}
    del worker, runner, sched
    free_memory()
    return out


def phase_engine_spec(dev: torch.device) -> dict:
    """Speculative decoding on llama3-8b at full width and depth, on and
    off. Checks: the spec run verified proposals; every greedy request's
    first 16 tokens are identical on and off (later tokens may part at a
    near-tie: the T = 5 verification forward and the T = 1 decode forward
    round differently); the two processor requests ran through verification
    steps on the host (_commit_spec_host), their streams are the same on
    and off or part where the processed row's top two logits are within
    NEAR_TIE_NATS (`_host_margins`), and the guided one kept its grammar;
    the folded pool kernel launched once per layer of every spec forward,
    the unfolded one once per layer of every decode forward. Returns the
    spec run's launches."""
    on = _spec_run(dev, True)
    off = _spec_run(dev, False)
    stats = on["stats"]
    check(stats["spec_steps"] > 0 and stats["spec_proposed"] > 0,
          f"engine_spec: no speculation happened: {stats}")
    check(off["stats"]["spec_steps"] == 0 and off["forwards"]["spec"] == 0,
          "engine_spec: the spec-off run speculated")
    divergence = {rid: _first_divergence(toks, off["streams"][rid])
                  for rid, toks in on["streams"].items()
                  if _greedy(rid) or rid.startswith("proc-")}
    for rid, at in divergence.items():
        if rid.startswith("proc-"):
            continue
        check(at >= SPEC_PARITY_TOKENS,
              f"engine_spec: greedy {rid} differs with speculation on at "
              f"token {at} (< {SPEC_PARITY_TOKENS})")
    # a processor stream is picked on the host from the processed rows: on
    # and off it may part only where that row's top two were a near-tie
    proc_margins = {}
    for rid in (r for r in divergence if r.startswith("proc-")):
        at = divergence[rid]
        if at == len(on["streams"][rid]):
            continue
        key = (int(rid.split("-")[-1]), at)
        gap = min(on["margins"].get(key, math.inf),
                  off["margins"].get(key, math.inf))
        proc_margins[rid] = gap
        check(gap < NEAR_TIE_NATS,
              f"engine_spec: {rid} differs with speculation on at token "
              f"{at}, where its processed logits' top two are {gap} apart "
              f"(not a near-tie, < {NEAR_TIE_NATS})")
    check(stats["spec_logits_steps"] > 0,
          f"engine_spec: no verification step carried a processor slot: "
          f"{stats}")
    guided = on["streams"]["proc-1"]
    check(re.fullmatch(SPEC_GUIDED_REGEX.replace("{80,}", "{64}"),
                       bytes(t for t in guided if t < 256).decode(
                           "latin-1")) is not None and max(guided) < 256,
          f"engine_spec: the guided stream left its grammar: {guided}")
    emit("engine_spec", model=MODEL, spec_max_k=SPEC_K,
         requests_wave1=12, requests_wave2=1, processor_requests=2,
         spec_stats=stats,
         acceptance_rate=(stats["spec_accepted"] / stats["spec_proposed"]),
         forwards_on=on["forwards"], forwards_off=off["forwards"],
         kernel_launches_on=on["launches"],
         kernel_launches_off=off["launches"],
         greedy_first_divergence=divergence,
         greedy_tokens_checked=SPEC_PARITY_TOKENS,
         processor_streams_equal={
             rid: on["streams"][rid] == off["streams"][rid]
             for rid in on["streams"] if rid.startswith("proc-")},
         processor_divergence_margin=proc_margins,
         spec_logits_steps=stats["spec_logits_steps"],
         host_ms_on=stats["host_ms"], logits_steps_on=stats["logits_steps"],
         itl_ms_mean_on=on["itl_ms_mean"], itl_ms_mean_off=off["itl_ms_mean"],
         ttft_ms_mean_on=on["ttft_ms_mean"],
         ttft_ms_mean_off=off["ttft_ms_mean"],
         wall_s_on=on["wall_s"], wall_s_off=off["wall_s"],
         graphs_spec_on=on["graphs"], graphs_spec_off=off["graphs"])
    return on["launches"]


def greedy_parity(runner, table: np.ndarray, prompt: np.ndarray, steps: int,
                  label: str, kernel_fns=None, plain_fns=None,
                  spec_drafts=None, **extra) -> dict:
    """One greedy prompt through `runner` twice: with the runner attributes
    in `kernel_fns` (default: the decode kernel and the quantized matmul
    kernels), then with those in `plain_fns` (default: their plain
    versions). With `spec_drafts`, each run first scores one verification
    chunk [first token] + drafts at the prompt's end (`decode_spec`). The
    attributes are restored afterwards. History positions are never
    rewritten, and each run rewrites its own chunk and decode positions
    before reading them, so the two runs see the same pool.

    The first decode step and the verification chunk want logits, so they
    replay their logits keys; the other steps replay the plain keys. The
    plain run is graphed too: the graph key holds the step functions, so it captures its own
    graphs and never replays the kernel run's. Returns each run's
    `launched_forwards`."""
    from dynamo_tpu_torch.engine.model_runner import bucket_table_width
    from dynamo_tpu_torch.models.transformer import (
        paged_attention_decode_xla,
        quant_matmul,
        quant_matmul_ref,
    )
    from dynamo_tpu_torch.ops import paged_attention_decode_pool

    kernel_fns = kernel_fns or {"decode_attention_fn": paged_attention_decode_pool,
                                "matmul_fn": quant_matmul}
    plain_fns = plain_fns or {"decode_attention_fn": paged_attention_decode_xla,
                              "matmul_fn": quant_matmul_ref}
    saved = {k: getattr(runner, k) for k in {**kernel_fns, **plain_fns}}
    n = len(prompt)
    first = runner.prefill_chunk(prompt, 0, table, n, (0.0, 1.0, 0, 0))
    chunk = len(spec_drafts) + 1 if spec_drafts is not None else 0
    width = bucket_table_width(
        -(-(n + max(steps, chunk)) // runner.config.page_size),
        runner.config.max_pages_per_seq)
    one = np.ones(1, np.float32)
    greedy = (np.zeros(1, np.float32), one, np.zeros(1, np.int32),
              np.zeros(1, np.uint32))

    def run(fns):
        for k, v in fns.items():
            setattr(runner, k, v)
        spec_logits = None
        if spec_drafts is not None:
            runner.decode_spec(
                np.asarray([first], np.int32),
                np.asarray([spec_drafts], np.int32),
                np.asarray([n], np.int32), table[None, :width],
                np.asarray([n + 1], np.int32), np.ones(1, bool), *greedy,
                np.zeros(1, np.int32), want_logits=True)
            spec_logits = runner.last_spec_logits[0]
        tok, out, logits = first, [], None
        for s in range(steps):
            nxt = runner.decode(
                np.asarray([tok], np.int32), np.asarray([n + s], np.int32),
                table[None, :width], np.asarray([n + s + 1], np.int32),
                np.ones(1, bool), *greedy, np.asarray([s], np.int32),
                want_logits=s == 0)
            if s == 0:
                logits = runner.last_decode_logits[0]
            tok = int(nxt[0])
            out.append(tok)
        return logits, out, spec_logits

    def delta(before):
        after = launched_forwards(runner)
        return {kind: after[kind] - before[kind] for kind in after}

    try:
        before = launched_forwards(runner)
        k_logits, k_tokens, k_spec = run(kernel_fns)
        forwards = {"kernel": delta(before)}
        before = launched_forwards(runner)
        p_logits, p_tokens, p_spec = run(plain_fns)
        forwards["plain"] = delta(before)
    finally:
        for k, v in saved.items():
            setattr(runner, k, v)
    diff = float(np.abs(k_logits - p_logits).max())
    scale = float(np.abs(p_logits).max())
    agree = _first_divergence(k_tokens, p_tokens)
    top2 = np.sort(p_logits)[-2:]
    check(np.all(np.isfinite(k_logits)), f"{label}: non-finite kernel logits")
    check(diff <= PARITY_LOGITS_REL_TOL * scale,
          f"{label}: logits max|d| {diff} > {PARITY_LOGITS_REL_TOL} x {scale}")
    check(agree >= 1 or float(top2[1] - top2[0]) <= 2 * diff,
          f"{label}: first greedy token differs beyond a near-tie")
    if spec_drafts is not None:
        spec_diff = float(np.abs(k_spec - p_spec).max())
        spec_scale = float(np.abs(p_spec).max())
        check(np.all(np.isfinite(k_spec)), f"{label}: non-finite spec logits")
        check(spec_diff <= PARITY_LOGITS_REL_TOL * spec_scale,
              f"{label}: spec logits max|d| {spec_diff} > "
              f"{PARITY_LOGITS_REL_TOL} x {spec_scale}")
        extra.update(spec_logits_max_abs_diff=spec_diff,
                     spec_logits_max_abs=spec_scale,
                     spec_positions=chunk)
    emit(label, prompt_len=n, logits_max_abs_diff=diff, logits_max_abs=scale,
         tolerance_rel=PARITY_LOGITS_REL_TOL,
         greedy_tokens_agree_leading=agree, greedy_steps=steps,
         plain_run="graphed, its own keys by function identity",
         launched_forwards=forwards, **extra)
    return forwards


def _pool_table(worker, n: int, steps: int) -> np.ndarray:
    """A block table for an n-token prompt plus `steps` tokens, its pages
    taken from the worker's pool (its scheduler must be stopped)."""
    runner = worker.runner
    pages = -(-(n + steps) // runner.config.page_size)
    alloc = worker.scheduler.pool.allocate([], pages)
    check(alloc is not None, "no free pages for the parity prompt")
    table = np.zeros(runner.config.max_pages_per_seq, np.int32)
    table[:pages] = alloc.pages
    return table


def phase_parity(worker, label: str = "parity", **fns) -> None:
    """greedy_parity on a serving runner, its pages taken from the pool."""
    worker.close()  # the scheduler thread must not step this runner now
    n, steps = 300, 16
    prompt = np.random.default_rng(SEED + 2).integers(
        1, worker.model_config.vocab_size, n)
    greedy_parity(worker.runner, _pool_table(worker, n, steps), prompt, steps,
                  label, weight_dtype=worker.runner.config.weight_dtype,
                  kv_dtype=worker.runner.config.kv_dtype, **fns)


def phase_unified(dev: torch.device, default_streams: dict) -> dict:
    """The unified path: TorchWorker(attention_fn=paged_attention) serving
    llama3-8b at full width and depth; each decode forward writes every
    layer's K/V, then row 3 attends over the pool. Then the drop-ins on the
    same runner. Returns the launches of both paths."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    worker, launches, served = phase_engine(
        dev, label="unified", attention_fn=pa.paged_attention)
    divergence = {rid: _first_divergence(toks, default_streams[rid])
                  for rid, toks in served.items() if _greedy(rid)}
    emit("unified_streams", greedy_first_divergence_from_default=divergence,
         note="host-clock admission differs between the two runs, so "
              "prefill chunking (and bf16 rounding) may differ")
    try:
        # greedy parity against the default path on the same runner
        phase_parity(worker, "parity_unified",
                     kernel_fns={"attention_fn": pa.paged_attention},
                     plain_fns={"attention_fn": None})
        dropins = phase_dropins(dev, worker)
    finally:
        worker.close()
    del worker
    free_memory()
    return {"paged_decode_attention": launches["paged_decode_attention"],
            "paged_decode_attention_partial": dropins}


def phase_dropins(dev: torch.device, worker) -> int:
    """The reference's one-layer drop-ins on a llama3-8b runner:
    decode_attention_fn = paged_attention_decode_fused and spec_attention_fn
    = paged_attention_spec (row 4, at g and at the folded g'), held against
    the whole-pool path (rows 1 and 1-folded) on one prompt: a verification
    chunk of 5 positions, then 16 greedy decode steps. Returns row 4's
    launches in the drop-in run."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    runner = worker.runner
    n, steps = 300, 16
    prompt = np.random.default_rng(SEED + 6).integers(
        1, worker.model_config.vocab_size, n)
    table = _pool_table(worker, n, steps)
    drafts = [int(t) for t in prompt[:SPEC_K]]
    runner.attention_fn = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reset_runner_counts(runner)
    forwards = greedy_parity(
        runner, table, prompt, steps, "dropins",
        kernel_fns={"decode_attention_fn": pa.paged_attention_decode_fused,
                    "spec_attention_fn": pa.paged_attention_spec},
        plain_fns={"decode_attention_fn": pa.paged_attention_decode_pool,
                   "spec_attention_fn": pa.paged_attention_spec_pool},
        spec_drafts=drafts)
    torch.cuda.synchronize()
    launches = read_counts()
    n_layers = runner.model_config.n_layers
    want = {name: 0 for name in counters()}
    kernel, plain = forwards["kernel"], forwards["plain"]
    if dev.type == "cuda":
        # drop-in run: row 4 per layer of 1 spec + `steps` decode forwards
        # (and each new key's warm-up forward); whole-pool run (the
        # comparison): rows 1 and 1-folded likewise
        want["paged_decode_attention_partial"] = n_layers * (
            kernel["decode"] + kernel["spec"])
        want["paged_decode_attention_pool"] = n_layers * plain["decode"]
        want["paged_decode_attention_pool_folded"] = n_layers * plain["spec"]
    # one verification forward each, plus its logits key's warm-up forward
    # where that key was new
    check(kernel["decode"] >= steps and 1 <= kernel["spec"] <= 2
          and plain["decode"] >= steps and 1 <= plain["spec"] <= 2,
          f"dropins: forwards {forwards}")
    check(launches == want,
          f"dropins: kernel launches {launches} != expected {want}")
    check_graphed(runner, "dropins")
    emit("dropins_launches", kernel_launches=launches,
         launched_forwards=forwards, **graph_report(runner))
    return launches["paged_decode_attention_partial"]


# Histories of the 8 live slots of the graphs phase's step timings (the
# runner's 16 slots, the rest idle), as scripts/torch_decode_profile.py.
STEP_HISTORY = [600, 700, 32, 1500, 200, 96, 900, 1200]
BLOCK = 8  # DYNT_DECODE_BLOCK's default: the fused block


def _itl_runs(dev: torch.device, worker, runs: int) -> dict:
    """The standard 8 requests served `runs` times with graphs on and
    `runs` times off, in turns (on, off, on, ...), each time through a new
    scheduler (an empty prefix cache) on `worker`'s runner, its scheduler
    thread started once the whole wave is in, so every run admits the wave
    in one iteration and drives the runner through the same calls. Checks
    each run's launch counts and graph counters, and that every stream is
    the same in every run. Returns the runs' latencies and memory."""
    from dynamo_tpu_torch.engine import InferenceScheduler

    runner = worker.runner
    _, prompts = standard_traffic(worker.model_config.vocab_size)
    out = {"on": [], "off": []}
    first = None
    for i in range(2 * runs):
        graphs = i % 2 == 0
        runner.config.cuda_graphs = graphs
        worker.scheduler = InferenceScheduler(runner)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        reset_runner_counts(runner)
        start = time.perf_counter()
        try:
            results = asyncio.run(_serve_wave(
                worker, _bodies(prompts, "req"), hold=True))
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = read_counts()
        finally:
            worker.scheduler.stop()
        mode = "on" if graphs else "off"
        check(worker.scheduler.error is None,
              f"graphs {mode}: scheduler error {worker.scheduler.error!r}")
        streams = {f"req-{j}": r["tokens"] for j, r in enumerate(results)}
        first = first or streams
        divergence = {rid: _first_divergence(toks, first[rid])
                      for rid, toks in streams.items()}
        check(all(at == 64 for rid, at in divergence.items() if _greedy(rid)),
              f"graphs {mode} run {i // 2}: greedy streams differ from the "
              f"first run at {divergence}")
        want = expected_counts(runner, dev, decode=runner.decode_steps,
                               prefill=runner.prefill_steps,
                               warm=runner.graph_warm_forwards)
        check(launches == want, f"graphs {mode}: kernel launches {launches} "
              f"!= expected {want}")
        if graphs:
            check_graphed(runner, f"graphs {mode}")
            check(runner.graph_captures == 0,
                  f"graphs {mode}: {runner.graph_captures} captures after "
                  "prewarm")
        else:
            check(runner.graph_replays == 0
                  and runner.eager_forwards["decode"] == runner.decode_steps
                  and runner.eager_forwards["prefill"]
                  == runner.prefill_steps,
                  f"graphs {mode}: replays {runner.graph_replays}, eager "
                  f"{runner.eager_forwards}")
        out[mode].append({
            **_latency(results), "wall_s": wall,
            "output_tokens_per_s": sum(len(r["tokens"]) for r in results)
            / wall, "decode_forwards": runner.decode_steps,
            "all_streams_equal_first_run": all(
                at == 64 for at in divergence.values()),
            **graph_report(runner)})
    runner.config.cuda_graphs = True
    return out


def _time_step(fn, steps: int, repeats: int = 3) -> dict:
    """fn() dispatches `steps` forwards. After a warm call (which captures a
    new key), per step and best of `repeats`: host dispatch (the host clock
    until fn returns), device wall (CUDA events recorded before the call and
    after it returns: the card's time from the step's first operation to
    its last, idle gaps included) and the host clock until synchronized."""
    fn()
    torch.cuda.synchronize()
    host, wall, synced = [], [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3 / steps)
        wall.append(start.elapsed_time(end) / steps)
        synced.append((t2 - t0) * 1e3 / steps)
    return {"host_ms": min(host), "wall_ms": min(wall),
            "synced_ms": min(synced), "host_ms_runs": host,
            "wall_ms_runs": wall}


def _step_inputs(runner, spec_k: int = 0, sampled: bool = False) -> dict:
    """Decode (or, with spec_k, verification) inputs for the runner's slots:
    8 live with STEP_HISTORY tokens of history in pages 1 and up (their
    contents are whatever the pool holds), the rest idle; greedy, or with
    `sampled` every slot at temperature 0.8 / top_p 0.9 from its own
    seed."""
    from dynamo_tpu_torch.engine.model_runner import bucket_table_width

    rc = runner.config
    b, ps = rc.max_batch, rc.page_size
    tables = np.zeros((b, rc.max_pages_per_seq), np.int32)
    kv_lens = np.zeros(b, np.int32)
    active = np.zeros(b, bool)
    next_page = 1
    for i, h in enumerate(STEP_HISTORY):
        n = -(-(h + 2 * BLOCK) // ps)
        tables[i, :n] = np.arange(next_page, next_page + n)
        next_page += n
        kv_lens[i], active[i] = h + 1, True
    width = bucket_table_width(-(-(max(STEP_HISTORY) + 2 * BLOCK) // ps),
                               rc.max_pages_per_seq)
    args = dict(tokens=np.arange(b, dtype=np.int32), positions=kv_lens - 1,
                block_tables=np.ascontiguousarray(tables[:, :width]),
                kv_lens=kv_lens, active=active,
                temperature=np.full(b, 0.8 if sampled else 0.0, np.float32),
                top_p=np.full(b, 0.9 if sampled else 1.0, np.float32),
                top_k=np.zeros(b, np.int32),
                seeds=np.arange(b, dtype=np.uint32))
    if spec_k:
        args["drafts"] = np.random.default_rng(SEED + 8).integers(
            1, runner.model_config.vocab_size, (b, spec_k)).astype(np.int32)
    return args


def _step_timings(runner, spec_ks) -> dict:
    """The fused block (k = 8) and a verification step at each K of spec_ks
    on the runner's 16 slots (8 live), graphs on and off in turns (on, off,
    on, off); per mode the better of the two turns."""
    block_args = _step_inputs(runner)
    cases = {"decode_block": (lambda: runner.decode_multi(
        **block_args, k=BLOCK, return_device=True), BLOCK)}
    for k in spec_ks:
        spec_args = _step_inputs(runner, k)
        cases[f"spec_step_k{k}"] = (
            lambda a=spec_args: runner.decode_spec(**a, return_device=True),
            1)
    out = {}
    for graphs in (True, False, True, False):
        runner.config.cuda_graphs = graphs
        mode = "on" if graphs else "off"
        for name, (fn, steps) in cases.items():
            got = _time_step(fn, steps)
            best = out.setdefault(name, {}).get(mode)
            if best is None or got["wall_ms"] < best["wall_ms"]:
                out[name][mode] = got
    runner.config.cuda_graphs = True
    return out


def phase_graphs(dev: torch.device, worker, label: str, spec_ks=(SPEC_K,),
                 runs: int = 3) -> None:
    """Graphs on and off on a served runner (its scheduler stopped): prewarm
    (what the engine phase left uncaptured), then `_itl_runs` (the same
    greedy streams every run, the ITL of each), `_step_timings`, and for
    each K of spec_ks one verification step replayed and run eagerly on
    the same inputs, whose targets must agree (at K = 5 on the 16 slots
    every projection is M = 96, above the small-M body's 80 rows: the TMA
    prefill body inside the graph)."""
    from dynamo_tpu_torch.ops._gemm_plan import SMALL_M

    runner = worker.runner
    captures = runner.graph_captures
    t0 = time.perf_counter()
    runner.prewarm()
    prewarm_s = time.perf_counter() - t0
    prewarm_captures = runner.graph_captures - captures
    pool_gb = runner.graph_memory_bytes() / 1e9
    itl = _itl_runs(dev, worker, runs)
    spec_check = {}
    for k in spec_ks:
        targets = {}
        for graphs in (True, False):
            runner.config.cuda_graphs = graphs
            replays = runner.graph_replays
            got, n_acc = runner.decode_spec(**_step_inputs(runner, k))
            targets[graphs] = got
            check(graphs == (runner.graph_replays == replays + 1),
                  f"{label}: spec K={k} graphs={graphs} replays")
        runner.config.cuda_graphs = True
        check(np.array_equal(targets[True], targets[False]),
              f"{label}: spec K={k}: replayed targets differ from eager")
        m = runner.config.max_batch * (k + 1)
        spec_check[f"k{k}"] = {"gemm_m": m, "prefill_body": m > SMALL_M,
                               "targets_equal": True}
    timings = _step_timings(runner, spec_ks)
    # the same fused block with every slot sampled (graphs on): the noise
    # and the truncation run in every step either way, so the two agree
    sampled_args = _step_inputs(runner, sampled=True)
    timings["decode_block_sampled"] = {"on": _time_step(
        lambda: runner.decode_multi(**sampled_args, k=BLOCK,
                                    return_device=True), BLOCK)}

    def mean(mode, key):
        return float(np.mean([r[key] for r in itl[mode]]))

    emit(label, model=worker.model_config.name,
         weight_dtype=runner.config.weight_dtype,
         kv_dtype=runner.config.kv_dtype, prewarm_s=prewarm_s,
         prewarm_captures=prewarm_captures,
         graph_pool_GB_after_prewarm=pool_gb,
         graph_keys=len(runner.step_graphs),
         itl_ms_mean_on=mean("on", "itl_ms_mean"),
         itl_ms_mean_off=mean("off", "itl_ms_mean"),
         ttft_ms_mean_on=mean("on", "ttft_ms_mean"),
         ttft_ms_mean_off=mean("off", "ttft_ms_mean"),
         greedy_streams_equal_on_off=True, itl_runs=itl,
         spec_replay_vs_eager=spec_check, step_timings=timings)


def phase_spec_q(dev: torch.device) -> dict:
    """The spec step on the quantized path: mistral-7b widths at 4 layers,
    W4A16 + int8 KV, 8 sequences (the runner's 8 slots) prefilled then one
    verification step of 5 positions each, so every projection runs the q4
    v2 kernel at M = 8 x 5 = 40
    and attention the int8 pool kernel folded (g' = 20); held against the
    plain versions. Returns the launches of the kernel run."""
    from dynamo_tpu_torch.engine import ModelRunner, RunnerConfig
    from dynamo_tpu_torch.models import get_config
    from dynamo_tpu_torch.models.transformer import (
        paged_attention_spec_xla,
        quant_matmul,
        quant_matmul_ref,
    )
    from dynamo_tpu_torch.ops import paged_attention as pa

    cfg = dataclasses.replace(get_config(QMODEL), n_layers=4)
    runner = ModelRunner(cfg, RunnerConfig(
        num_pages=256, max_batch=8, weight_dtype="int4", kv_dtype="int8"),
        device=dev, seed=SEED)
    rng = np.random.default_rng(SEED + 7)
    lengths = [40, 100, 200, 17, 300, 64, 150, 90]
    b, ps = len(lengths), runner.config.page_size
    width = 32
    tables = np.zeros((b, width), np.int32)
    next_page = 1
    for i, n in enumerate(lengths):
        pages = -(-(n + SPEC_T) // ps)
        tables[i, :pages] = np.arange(next_page, next_page + pages)
        next_page += pages
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in lengths]
    drafts = rng.integers(1, cfg.vocab_size, (b, SPEC_K)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    zeros_f, ones_f = np.zeros(b, np.float32), np.ones(b, np.float32)

    def spec_step():
        targets, n_acc = runner.decode_spec(
            np.asarray(firsts, np.int32), drafts, lens, tables, lens + 1,
            np.ones(b, bool), zeros_f, ones_f, np.zeros(b, np.int32),
            np.zeros(b, np.uint32), np.zeros(b, np.int32), want_logits=True)
        return targets, runner.last_spec_logits

    # the kernel run: 8 prefill forwards, then the spec forward at M = 8 x 5
    # as a graph replay (its key captured first) and again through the
    # logits key (its own graph) for its logits; the two draw the same
    # targets
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reset_runner_counts(runner)
    firsts = [runner.prefill_chunk(p, 0, tables[i], len(p), (0.0, 1.0, 0, 0))
              for i, p in enumerate(prompts)]
    g_targets, _ = runner.decode_spec(
        np.asarray(firsts, np.int32), drafts, lens, tables, lens + 1,
        np.ones(b, bool), zeros_f, ones_f, np.zeros(b, np.int32),
        np.zeros(b, np.uint32), np.zeros(b, np.int32))
    k_targets, k_logits = spec_step()
    torch.cuda.synchronize()
    launches = read_counts()
    want = expected_counts(runner, dev, prefill=b, spec=runner.spec_steps,
                           warm=runner.graph_warm_forwards)
    check(runner.spec_steps == 2 and launches == want,
          f"spec_q: kernel launches {launches} != expected {want}")
    check_graphed(runner, "spec_q")
    check(np.array_equal(g_targets, k_targets),
          "spec_q: the spec step drew other targets than its logits "
          "variant")
    graphs = graph_report(runner)
    # the plain run over the same history
    runner.spec_attention_fn = paged_attention_spec_xla
    runner.matmul_fn = quant_matmul_ref
    try:
        p_targets, p_logits = spec_step()
    finally:
        runner.spec_attention_fn = pa.paged_attention_spec_pool
        runner.matmul_fn = quant_matmul
    diff = float(np.abs(k_logits - p_logits).max())
    scale = float(np.abs(p_logits).max())
    check(np.all(np.isfinite(k_logits)) and k_logits.shape == (
        b, SPEC_T, cfg.vocab_size), "spec_q: bad kernel logits")
    check(diff <= PARITY_LOGITS_REL_TOL * scale,
          f"spec_q: logits max|d| {diff} > {PARITY_LOGITS_REL_TOL} x {scale}")
    emit("spec_q", model=QMODEL, layers=cfg.n_layers, weight_dtype="int4",
         kv_dtype="int8", batch=b, positions=SPEC_T, gemm_m=b * SPEC_T,
         logits_max_abs_diff=diff, logits_max_abs=scale,
         tolerance_rel=PARITY_LOGITS_REL_TOL,
         targets_equal=int((k_targets == p_targets).sum()),
         targets=int(k_targets.size), kernel_launches=launches,
         targets_equal_logits_variant=True, **graphs)
    del runner
    free_memory()
    return launches


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
    with knobs(**({"DYNT_Q4_VARIANT": variant} if variant else {})):
        runner = ModelRunner(cfg, RunnerConfig(
            num_pages=64, max_batch=1, weight_dtype=weight_dtype,
            kv_dtype="int8"), device=dev, seed=SEED)
    n, steps = 200, 8
    table = np.zeros(runner.config.max_pages_per_seq, np.int32)
    pages = -(-(n + steps) // runner.config.page_size)
    table[:pages] = np.arange(1, pages + 1)
    prompt = np.random.default_rng(SEED + 4).integers(1, cfg.vocab_size, n)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reset_runner_counts(runner)
    forwards = greedy_parity(
        runner, table, prompt, steps, label, layers=cfg.n_layers,
        weight_dtype=weight_dtype, kv_dtype="int8", q4_variant=variant,
        kernels_per_forward=matmul_kernels_per_forward(runner))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = read_counts()
    # the kernel run: 1 prefill (a replay) + `steps` decode forwards and the
    # warm-up forwards of their two graph keys (the first step's
    # decode_logits and the others' decode); the plain run launches nothing
    want = expected_counts(
        runner, dev, decode=forwards["kernel"]["decode"],
        prefill=runner.prefill_steps + runner.graph_warm_forwards["prefill"])
    check(forwards["kernel"]["decode"] == steps + 2 and launches == want,
          f"{label}: kernel launches {launches} != expected {want} for "
          f"forwards {forwards}")
    check_graphed(runner, label)
    emit(label + "_launches", kernel_launches=launches,
         launched_forwards=forwards, **graph_report(runner))
    del runner
    free_memory()
    return launches


# ---------------------------------------------------------------------------
# Prefill as the reference runs it: padded to a bucket, one graph replay


# Chunk lengths of the prefill phase, each over 0 and over PREFILL_CACHED
# cached tokens (or the most the 2,048-token context leaves, a whole number
# of pages); then one batched dispatch of four rows over 0 cached tokens
# (B = 4 x bucket 128).
PREFILL_CHUNKS = (38, 127, 512, 1500)
PREFILL_CACHED = 1024
PREFILL_BATCH = (32, 57, 100, 127)
# Greedy tokens of two paths whose logits are not bit-equal may part only
# at a near-tie: a top-2 gap within this many nats.
NEAR_TIE_NATS = 0.1


def _unpadded_prefill(runner, tokens, start: int, table, kv_after: int):
    """The parent's prefill, kept as the reference for the padded graphed
    step: one eager `forward` of the chunk as it is (M = its tokens) over
    the table cut to its pages, logits at every position, sampled from the
    last. Returns (last-row logits [V] on the device, greedy token)."""
    from dynamo_tpu_torch.engine.sampler import sample_with_logprobs
    from dynamo_tpu_torch.models.transformer import (
        forward,
        paged_attention_xla,
    )

    dev, t = runner.device, len(tokens)
    pages = -(-kv_after // runner.config.page_size)
    with torch.inference_mode():
        logits = forward(
            runner.model, torch.as_tensor(tokens, device=dev).long()[None],
            torch.arange(start, start + t, device=dev)[None],
            runner.kv_cache, torch.as_tensor(table[None, :pages], device=dev),
            torch.tensor([kv_after], dtype=torch.int32, device=dev),
            attention_fn=runner.attention_fn or paged_attention_xla,
            matmul_fn=runner.matmul_fn)[:, -1]
        zero = torch.zeros(1, device=dev)
        token = sample_with_logprobs(
            logits, zero, torch.ones(1, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev), 0)[0]
    return logits[0], int(token.cpu()[0])


def _wall_ms(fn) -> float:
    """Host wall time of fn(), from an idle card until fn returns (every
    call timed here reads its token back, a sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _near_tie(logits: np.ndarray) -> float:
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def phase_prefill(dev: torch.device, worker, label: str) -> dict:
    """Padded, graphed prefill at full width on a fresh runner that shares
    `worker`'s weights (the worker's scheduler is stopped): prewarm's
    prefill keys first (their capture seconds and graph pool), then the
    rest of prewarm. Each chunk of PREFILL_CHUNKS, over 0 and over cached
    tokens, three ways: the padded step graphed (the serving path), the
    same step eagerly (cuda_graphs off) and the parent's unpadded eager
    forward. Checks: graphed and eager padded last-row logits bit-equal and
    the same token; graphed against unpadded within PARITY_LOGITS_REL_TOL x
    max |logit| (padding changes the GEMMs' M and so their summation order)
    and the same greedy token but at a near-tie; each graphed chunk one
    replay, no eager prefill forward meanwhile. Times: best of three each
    way, in turns. Then one batched dispatch of PREFILL_BATCH rows, graphed
    against eager (tokens and logprobs bit-equal) and against the rows one
    at a time. The kernels' launches (row 6 on the W4A16 model) are counted
    from 0 after prewarm and checked against every forward that ran.
    Returns them."""
    from dynamo_tpu_torch.engine import ModelRunner

    cfg, t_phase = worker.model_config, time.perf_counter()
    runner = ModelRunner(cfg, dataclasses.replace(worker.runner_config),
                         device=dev, params=worker.runner.model)
    rc = runner.config
    p, ps = rc.max_pages_per_seq, rc.page_size
    t0 = time.perf_counter()
    for rows, bucket in runner.prefill_keys():  # prewarm's prefill loop
        row = (np.zeros(bucket, np.int32), 0, np.zeros(p, np.int32),
               min(bucket, rc.max_context), (0.0, 1.0, 0, 0))
        runner.prefill_chunk_batch([row] * rows)
    torch.cuda.synchronize()
    prefill_keys_s = time.perf_counter() - t0
    prefill_pool = runner.graph_memory_bytes()
    prefill_keys = sorted(key[1:4] for key in runner.step_graphs)
    t0 = time.perf_counter()
    runner.prewarm()
    torch.cuda.synchronize()
    prewarm_rest_s = time.perf_counter() - t0
    keys_all = len(runner.step_graphs)

    rng = np.random.default_rng(SEED + 10)
    # history: pages 1-128, 1,024 tokens written by two graphed chunks
    hist_table = np.arange(1, p + 1, dtype=np.int32)
    fresh_table = np.arange(p + 1, 2 * p + 1, dtype=np.int32)
    history = rng.integers(1, cfg.vocab_size, PREFILL_CACHED)
    for start in range(0, PREFILL_CACHED, 512):
        runner.prefill_chunk(history[start:start + 512], start, hist_table,
                             start + 512, (0.0, 1.0, 0, 0))
    torch.cuda.synchronize()

    # counts to zero just before this path
    reset_counts()
    reset_runner_counts(runner)
    unpadded = 0
    cases = []
    for n in PREFILL_CHUNKS:
        for cached in (0, min(PREFILL_CACHED,
                              (rc.max_context - n) // ps * ps)):
            tokens = rng.integers(1, cfg.vocab_size, n)
            table = hist_table if cached else fresh_table
            args = (tokens, cached, table, cached + n, (0.0, 1.0, 0, 0))
            tok_g = runner.prefill_chunk(*args, want_logits=True)
            logits_g = runner.last_prefill_logits
            rc.cuda_graphs = False
            tok_e = runner.prefill_chunk(*args, want_logits=True)
            logits_e = runner.last_prefill_logits
            rc.cuda_graphs = True
            logits_u, tok_u = _unpadded_prefill(runner, *args[:4])
            unpadded += 1
            logits_u = logits_u.float().cpu().numpy()
            what = f"{label}: {n} tokens over {cached}"
            check(np.all(np.isfinite(logits_g))
                  and logits_g.shape == (cfg.vocab_size,),
                  f"{what}: bad graphed logits")
            check(np.array_equal(logits_g, logits_e) and tok_g == tok_e,
                  f"{what}: graphed and eager padded steps differ")
            diff = float(np.abs(logits_g - logits_u).max())
            scale = float(np.abs(logits_u).max())
            check(diff <= PARITY_LOGITS_REL_TOL * scale,
                  f"{what}: padded vs unpadded logits max|d| {diff} > "
                  f"{PARITY_LOGITS_REL_TOL} x {scale}")
            check(tok_g == tok_u or _near_tie(logits_u) <= NEAR_TIE_NATS,
                  f"{what}: greedy token {tok_g} != unpadded {tok_u}")
            ways = {"graphed": [], "eager_padded": [], "eager_unpadded": []}
            for _ in range(3):
                replays = runner.graph_replays
                eager = dict(runner.eager_forwards)
                ways["graphed"].append(_wall_ms(
                    lambda: runner.prefill_chunk(*args)))
                check(runner.graph_replays == replays + 1
                      and runner.eager_forwards == eager,
                      f"{what}: a graphed chunk was not one replay")
                rc.cuda_graphs = False
                ways["eager_padded"].append(_wall_ms(
                    lambda: runner.prefill_chunk(*args)))
                rc.cuda_graphs = True
                ways["eager_unpadded"].append(_wall_ms(
                    lambda: _unpadded_prefill(runner, *args[:4])))
                unpadded += 1
            cases.append({
                "tokens": n, "cached": cached,
                "bucket": runner._bucket_for(n),
                "logits_max_abs_diff_unpadded": diff,
                "logits_max_abs": scale, "greedy_equal": tok_g == tok_u,
                **{f"{k}_ms": min(v) for k, v in ways.items()},
                **{f"{k}_ms_runs": v for k, v in ways.items()}})

    # one batched dispatch of four rows, fresh pages for each
    rows = []
    next_page = 2 * p + 1
    for i, n in enumerate(PREFILL_BATCH):
        table = np.zeros(p, np.int32)
        pages = -(-n // ps)
        table[:pages] = np.arange(next_page, next_page + pages)
        next_page += pages
        rows.append((rng.integers(1, cfg.vocab_size, n), 0, table, n,
                     (0.0, 1.0, 0, SEED + i)))
    batched = {}
    for graphs in (True, False):
        rc.cuda_graphs = graphs
        toks = runner.prefill_chunk_batch(rows, want_samples=True)
        batched[graphs] = (toks.cpu().numpy()[:len(rows)],
                           runner.last_prefill_samples)
    rc.cuda_graphs = True
    (tok_bg, samp_bg), (tok_be, samp_be) = batched[True], batched[False]
    check(np.array_equal(tok_bg, tok_be)
          and all(a[0] == b[0] and np.array_equal(a[2], b[2])
                  for a, b in zip(samp_bg, samp_be)),
          f"{label}: batched graphed and eager differ")
    singles = [runner.prefill_chunk(*row) for row in rows]
    for i, (tok, samp) in enumerate(zip(tok_bg, samp_bg)):
        check(tok == singles[i] or samp[2][0] - samp[2][1] <= NEAR_TIE_NATS,
              f"{label}: batched row {i} token {tok} != alone {singles[i]}")
    ways = {"batched_graphed": [], "one_at_a_time_graphed": [],
            "batched_eager": []}
    for _ in range(3):
        replays = runner.graph_replays
        ways["batched_graphed"].append(_wall_ms(
            lambda: runner.prefill_chunk_batch(rows).cpu()))
        check(runner.graph_replays == replays + 1,
              f"{label}: the batched dispatch was not one replay")
        ways["one_at_a_time_graphed"].append(_wall_ms(
            lambda: [runner.prefill_chunk(*row) for row in rows]))
        rc.cuda_graphs = False
        ways["batched_eager"].append(_wall_ms(
            lambda: runner.prefill_chunk_batch(rows).cpu()))
        rc.cuda_graphs = True
    torch.cuda.synchronize()
    launches = read_counts()
    want = expected_counts(runner, dev,
                           prefill=runner.prefill_steps + unpadded,
                           warm=runner.graph_warm_forwards)
    check(launches == want,
          f"{label}: kernel launches {launches} != expected {want} for "
          f"{runner.prefill_steps} padded and {unpadded} unpadded forwards, "
          f"warm-up {runner.graph_warm_forwards}")
    emit(label, model=cfg.name, weight_dtype=rc.weight_dtype,
         kv_dtype=rc.kv_dtype, nvidia_smi=nvidia_smi(),
         prefill_buckets=list(rc.prefill_buckets), max_batch=rc.max_batch,
         prefill_keys=len(prefill_keys), prefill_key_list=prefill_keys,
         prefill_keys_capture_s=prefill_keys_s,
         prefill_graph_pool_GB=prefill_pool / 1e9,
         prewarm_rest_s=prewarm_rest_s, graph_keys_after_prewarm=keys_all,
         tolerance_rel=PARITY_LOGITS_REL_TOL, near_tie_nats=NEAR_TIE_NATS,
         chunks=cases, batch_rows=list(PREFILL_BATCH),
         batch_key=[4, runner._bucket_for(max(PREFILL_BATCH))],
         batch_tokens_equal_one_at_a_time=[
             int(a) == b for a, b in zip(tok_bg, singles)],
         **{f"{k}_ms": min(v) for k, v in ways.items()},
         **{f"{k}_ms_runs": v for k, v in ways.items()},
         unpadded_forwards=unpadded, kernel_launches=launches,
         **graph_report(runner), seconds=time.perf_counter() - t_phase)
    del runner
    free_memory()
    return launches


# ---------------------------------------------------------------------------
# The serving edge: the same traffic over HTTP through the port's frontend,
# request plane and discovery, beside the direct TorchWorker.generate path


async def _http(port: int, method: str, path: str, body=None,
                cut_after_events: int = 0,
                headers: dict | None = None) -> dict:
    """One HTTP/1.1 exchange on 127.0.0.1 with asyncio streams (the card's
    machine has no aiohttp), sending `headers` besides the usual ones. A
    chunked (SSE) answer is read event by event, each stamped on arrival;
    with `cut_after_events` the socket is closed after that many events, as
    a client that goes away. The answer's headers come back lower-cased."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        data = b"" if body is None else json.dumps(body).encode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     "Connection: close\r\nContent-Type: application/json\r\n"
                     f"{extra}Content-Length: {len(data)}\r\n\r\n".encode()
                     + data)
        await writer.drain()
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
        status = int(head.split(" ", 2)[1])
        headers = {k.strip().lower(): v.strip() for k, _, v in (
            line.partition(":") for line in head.split("\r\n")[1:] if line)}
        if headers.get("transfer-encoding") != "chunked":
            text = (await reader.readexactly(
                int(headers["content-length"]))).decode()
            return {"status": status, "text": text, "t0": t0,
                    "t_end": time.perf_counter(), "headers": headers}
        events, buf = [], b""
        while True:
            n = int((await reader.readuntil(b"\r\n")).strip(), 16)
            if n == 0:
                break
            buf += (await reader.readexactly(n + 2))[:-2]
            now = time.perf_counter()
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                events.append((now, event.decode()[len("data: "):]))
            if cut_after_events and len(events) >= cut_after_events:
                return {"status": status, "events": events, "t0": t0,
                        "headers": headers}
        return {"status": status, "events": events, "t0": t0,
                "t_end": time.perf_counter(), "headers": headers}
    finally:
        writer.close()


def _sse_outcome(res: dict) -> dict:
    """Text, finish reason, usage and token-event stamps of an SSE answer."""
    check(res["events"] and res["events"][-1][1] == "[DONE]",
          "an SSE stream did not end with data: [DONE]")
    text, finish, usage, stamps, calls = [], None, None, [], []
    for at, event in res["events"][:-1]:
        chunk = json.loads(event)
        check("error" not in chunk, f"in-band error {chunk}")
        usage = chunk.get("usage") or usage
        for choice in chunk["choices"]:
            piece = choice.get("text", choice.get("delta", {}).get("content",
                                                                   ""))
            called = choice.get("delta", {}).get("tool_calls")
            if piece:
                text.append(piece)
            if called:
                calls += called
            if piece or called:
                stamps.append(at)
            finish = choice["finish_reason"] or finish
    return {"text": "".join(text), "finish": finish, "usage": usage,
            "stamps": stamps, "t0": res["t0"], "tool_calls": calls}


def _aggregate_outcome(res: dict) -> dict:
    check(res["status"] == 200, f"HTTP {res['status']}: {res['text']}")
    data = json.loads(res["text"])
    choice = data["choices"][0]
    text = choice["text"] if "text" in choice else choice["message"][
        "content"]
    return {"text": text, "finish": choice["finish_reason"],
            "usage": data["usage"], "stamps": [], "t0": res["t0"]}


def _frontend_requests(metrics_text: str, model: str) -> float:
    """dynamo_requests_total of the frontend for `model`, all statuses."""
    total = 0.0
    prefix = ('dynamo_requests_total{namespace="http",component="frontend",'
              f'endpoint="{model}",')
    for line in metrics_text.splitlines():
        if line.startswith(prefix):
            total += float(line.rsplit(" ", 1)[1])
    return total


class _LayerClock:
    """CPU seconds spent in named functions, by layer. `targets` are
    (owner, attribute, layer); a coroutine function is timed from its call
    to its return, so it must not wait on anything. By default the request
    plane's msgpack codec and the frontend's request lowering and response
    building. Installed around the turns it measures only."""

    def __init__(self, targets=None) -> None:
        if targets is None:
            from dynamo_tpu_torch.llm import http_service, preprocessor
            from dynamo_tpu_torch.runtime import msgpack

            targets = [
                (msgpack, "packb", "request_plane"),
                (msgpack, "unpackb", "request_plane"),
                (preprocessor.OpenAIPreprocessor, "preprocess_completions",
                 "frontend"),
                (preprocessor.OpenAIPreprocessor, "preprocess_chat",
                 "frontend"),
                (preprocessor.DeltaGenerator, "on_output", "frontend"),
                (preprocessor.DeltaGenerator, "final_response", "frontend"),
                (http_service, "_sse", "frontend"),
            ]
        self._targets = targets
        self.seconds = {layer: 0.0 for _, _, layer in targets}
        self._saved = []

    def _timed(self, fn, layer: str):
        import inspect

        if inspect.iscoroutinefunction(fn):
            async def timed_async(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return await fn(*args, **kwargs)
                finally:
                    self.seconds[layer] += time.perf_counter() - t
            return timed_async

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[layer] += time.perf_counter() - t
        return timed

    def __enter__(self):
        for owner, name, layer in self._targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._timed(fn, layer))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()


def _reclaimable_pages(pool) -> int:
    """Free pages plus prefix-cache pages that no sequence pins."""
    return pool.free_count() + sum(1 for h in pool._cached
                                   if pool._refcount.get(h, 0) == 0)


def phase_serve(dev: torch.device, worker, label: str) -> None:
    """The serving edge on a served runner (its scheduler stopped): the
    port's DistributedRuntime (file discovery in a temporary directory, the
    TCP request plane on 127.0.0.1), `worker.serve()` and the port's
    Frontend, in this process. The standard 8 requests go as
    /v1/completions with token-id prompts, even ones streamed (SSE) and odd
    ones aggregate, with the direct run's seeds, temperatures, max_tokens
    and ignore_eos; one warm HTTP turn, then three direct and three HTTP
    turns in turns. Each turn runs on a new scheduler (an empty prefix
    cache) whose thread starts once the 8 requests are in, submitted in
    order, so every turn drives the runner through the same calls. Checks:
    every HTTP completion's text is the ByteTokenizer decode of the direct
    stream, usage and finish reasons match, every stream ends in
    [DONE], the frontend's dynamo_requests_total moves by the requests
    sent, no graphable forward ran eagerly, the kernels launched once per
    layer (projection) of each forward, one chat stream equals a direct
    run of its rendered prompt, and a stream its client cuts mid-decode
    frees its sequence and pages. TTFT and ITL are taken at the client,
    over the streamed requests, beside the same four requests' direct
    streams; the frontend's and the request plane's shares are the CPU
    seconds `_LayerClock` counts over the HTTP turns' wall."""
    import tempfile

    from dynamo_tpu_torch.engine import InferenceScheduler
    from dynamo_tpu_torch.frontend import Frontend
    from dynamo_tpu_torch.llm.chat_template import ChatTemplate
    from dynamo_tpu_torch.llm.preprocessor import DEFAULT_CHAT_TEMPLATE
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    t_phase = time.perf_counter()
    runner = worker.runner
    model = worker.card.name
    _, prompts = standard_traffic(worker.model_config.vocab_size)
    bodies = _bodies(prompts, "req")
    tok = ByteTokenizer()

    def http_body(i: int) -> dict:
        s = bodies[i]["sampling"]
        out = {"model": model, "prompt": bodies[i]["token_ids"],
               "max_tokens": s["max_tokens"],
               "temperature": s["temperature"], "top_p": s["top_p"],
               "seed": s["seed"], "ignore_eos": True}
        if i % 2 == 0:
            out.update(stream=True, stream_options={"include_usage": True})
        return out

    def fresh_scheduler():
        worker.scheduler.stop()
        worker.scheduler = InferenceScheduler(runner)
        return worker.scheduler

    async def wait_submitted(sched, n: int) -> None:
        while sched._incoming.qsize() < n:
            await asyncio.sleep(0.0005)

    async def direct_turn() -> dict:
        sched = fresh_scheduler()
        start = time.perf_counter()
        results = await _serve_wave(worker, bodies, hold=True)
        wall = time.perf_counter() - start
        check(sched.error is None, f"{label}: scheduler error {sched.error!r}")
        return {"wall": wall, "streams": [r["tokens"] for r in results],
                "results": results}

    async def http_turn(port: int) -> dict:
        sched = fresh_scheduler()
        start = time.perf_counter()
        tasks = []
        for i in range(len(bodies)):
            tasks.append(asyncio.ensure_future(
                _http(port, "POST", "/v1/completions", http_body(i))))
            await asyncio.wait_for(wait_submitted(sched, i + 1), 60)
        sched.start()
        answers = await asyncio.wait_for(asyncio.gather(*tasks), 300)
        wall = time.perf_counter() - start
        check(sched.error is None, f"{label}: scheduler error {sched.error!r}")
        outs = [_sse_outcome(a) if i % 2 == 0 else _aggregate_outcome(a)
                for i, a in enumerate(answers)]
        return {"wall": wall, "outcomes": outs}

    def latency(pairs) -> dict:
        """Mean TTFT / ITL (ms) over (t0, stamps, n_tokens) of the streamed
        requests."""
        ttft = [(st[0] - t0) * 1e3 for t0, st, _ in pairs]
        itl = [(st[-1] - st[0]) * 1e3 / (n - 1) for _, st, n in pairs]
        return {"ttft_ms_mean": float(np.mean(ttft)),
                "itl_ms_mean": float(np.mean(itl))}

    async def serve() -> dict:
        root = tempfile.mkdtemp(prefix="chip_smoke_discovery_")
        cfg = RuntimeConfig(discovery_backend="file", discovery_path=root,
                            tcp_host="127.0.0.1", system_enabled=False)
        rt = await DistributedRuntime(cfg).start()
        frontend = Frontend(rt, host="127.0.0.1", port=0)
        out = {"direct": [], "http": []}
        try:
            await worker.serve(rt)
            await frontend.start()
            port = frontend.port
            listed = []
            t_list = time.perf_counter()
            while model not in listed:
                check(time.perf_counter() - t_list < 30,
                      f"{label}: /v1/models never listed {model}")
                res = await _http(port, "GET", "/v1/models")
                listed = [m["id"] for m in json.loads(res["text"])["data"]]
                await asyncio.sleep(0.05)
            before = _frontend_requests(
                (await _http(port, "GET", "/metrics"))["text"], model)
            sent = 0
            # counts to zero just before the main path
            reset_counts()
            reset_runner_counts(runner)
            clock = _LayerClock()
            out["warm"] = await http_turn(port)
            sent += len(bodies)
            for _ in range(3):
                out["direct"].append(await direct_turn())
                with clock:
                    out["http"].append(await http_turn(port))
                sent += len(bodies)
            out["layer_seconds"] = dict(clock.seconds)
            # one chat stream, greedy, against a direct run of its prompt
            chat = {"model": model, "max_tokens": 64, "temperature": 0.0,
                    "ignore_eos": True, "stream": True,
                    "stream_options": {"include_usage": True},
                    "messages": [{"role": "user", "content": "héllo"}]}
            prompt_ids = tok.encode(
                ChatTemplate(DEFAULT_CHAT_TEMPLATE).render(
                    messages=chat["messages"], add_generation_prompt=True))
            sched = fresh_scheduler()
            sched.start()
            res = await _http(port, "POST", "/v1/chat/completions", chat)
            out["chat"] = _sse_outcome(res)
            sent += 1
            sched = fresh_scheduler()
            sched.start()
            direct = await _stream(worker,
                                   _body("chat-0", prompt_ids, 0.0, 1.0))
            out["chat_direct"] = direct["tokens"]
            out["chat_prompt_tokens"] = len(prompt_ids)
            # a stream its client cuts mid-way: after its third event (the
            # prefill's token, then two blocks of decode tokens)
            pages_before = _reclaimable_pages(sched.pool)
            tokens_before = sched.stats.decode_tokens
            cut = {"model": model, "prompt": bodies[2]["token_ids"],
                   "max_tokens": 1024, "temperature": 0.0,
                   "ignore_eos": True, "stream": True}
            res = await _http(port, "POST", "/v1/completions", cut,
                              cut_after_events=3)
            sent += 1
            check(res["status"] == 200, f"{label}: cut stream {res}")
            t_cut = time.perf_counter()
            while (sched._waiting or any(s is not None for s in sched._slots)
                   or _reclaimable_pages(sched.pool) != pages_before):
                check(time.perf_counter() - t_cut < 30,
                      f"{label}: the cut stream's sequence was not released "
                      f"(waiting {len(sched._waiting)}, live "
                      f"{sum(s is not None for s in sched._slots)}, pages "
                      f"{_reclaimable_pages(sched.pool)} of {pages_before})")
                await asyncio.sleep(0.005)
            out["cut"] = {"release_s": time.perf_counter() - t_cut,
                          "pages_before": pages_before,
                          "pages_after": _reclaimable_pages(sched.pool),
                          "decode_tokens": (sched.stats.decode_tokens
                                            - tokens_before)}
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out["launches"] = read_counts()
            after = _frontend_requests(
                (await _http(port, "GET", "/metrics"))["text"], model)
            out["requests_counted"] = after - before
            out["requests_sent"] = sent
        finally:
            await frontend.close()
            await worker.shutdown()
            await rt.shutdown()
            shutil.rmtree(root, ignore_errors=True)
        return out

    out = asyncio.run(serve())
    streams = out["direct"][0]["streams"]
    for turn in out["direct"][1:]:
        check(turn["streams"] == streams,
              f"{label}: a direct turn's streams differ from the first's")
    for turn in [out["warm"]] + out["http"]:
        for i, got in enumerate(turn["outcomes"]):
            want_text = tok.decode(streams[i])
            check(got["text"] == want_text,
                  f"{label}: req-{i} HTTP text differs from the direct "
                  "stream's decode")
            check(got["finish"] == "length",
                  f"{label}: req-{i} finish {got['finish']}")
            check(got["usage"] == {
                "prompt_tokens": len(prompts[i]), "completion_tokens": 64,
                "total_tokens": len(prompts[i]) + 64},
                f"{label}: req-{i} usage {got['usage']}")
    chat = out["chat"]
    check(chat["text"] == tok.decode(out["chat_direct"])
          and chat["finish"] == "length"
          and chat["usage"]["completion_tokens"] == 64
          and chat["usage"]["prompt_tokens"] == out["chat_prompt_tokens"],
          f"{label}: the chat stream differs from the direct run of its "
          f"prompt: {chat}")
    check(0 < out["cut"]["decode_tokens"] < 1023,
          f"{label}: the stream was not cut mid-way: {out['cut']}")
    check(out["requests_counted"] == out["requests_sent"],
          f"{label}: dynamo_requests_total moved by "
          f"{out['requests_counted']}, {out['requests_sent']} sent")
    check_graphed(runner, label)
    want = expected_counts(runner, dev, decode=runner.decode_steps,
                           prefill=runner.prefill_steps,
                           warm=runner.graph_warm_forwards)
    check(runner.decode_steps > 0 and out["launches"] == want,
          f"{label}: kernel launches {out['launches']} != expected {want}")
    streamed = [i for i in range(len(bodies)) if i % 2 == 0]
    http_lat = [latency([(o["t0"], o["stamps"], 64)
                         for i, o in enumerate(turn["outcomes"])
                         if i in streamed]) for turn in out["http"]]
    direct_lat = [latency([(r["t0"], r["stamps"], 64)
                           for i, r in enumerate(turn["results"])
                           if i in streamed]) for turn in out["direct"]]

    def mean(rows, key):
        return float(np.mean([r[key] for r in rows]))

    http_wall = sum(t["wall"] for t in out["http"])
    emit(label, model=model, weight_dtype=runner.config.weight_dtype,
         kv_dtype=runner.config.kv_dtype, requests_per_turn=len(bodies),
         turns={"http": len(out["http"]) + 1, "direct": len(out["direct"])},
         http_ttft_ms_mean=mean(http_lat, "ttft_ms_mean"),
         direct_ttft_ms_mean=mean(direct_lat, "ttft_ms_mean"),
         http_itl_ms_mean=mean(http_lat, "itl_ms_mean"),
         direct_itl_ms_mean=mean(direct_lat, "itl_ms_mean"),
         http_turn_wall_s=[t["wall"] for t in out["http"]],
         direct_turn_wall_s=[t["wall"] for t in out["direct"]],
         frontend_s=out["layer_seconds"]["frontend"],
         request_plane_codec_s=out["layer_seconds"]["request_plane"],
         frontend_share=out["layer_seconds"]["frontend"] / http_wall,
         request_plane_share=out["layer_seconds"]["request_plane"]
         / http_wall,
         texts_equal_direct=True, chat=chat["finish"], cut_stream=out["cut"],
         requests_counted=out["requests_counted"],
         decode_forwards=runner.decode_steps,
         prefill_forwards=runner.prefill_steps, kernel_launches=out[
             "launches"], **graph_report(runner),
         seconds=time.perf_counter() - t_phase)


DISAGG_RUNS = (("streamed", 1), ("serial", 0))  # DYNT_DISAGG_PIPELINE
PROFILE_MS = 200  # the comesh phase's /debug/profile capture
PROFILE_TOKENS = 384  # output tokens of the requests it captures


def _fresh_scheduler(worker) -> None:
    """A new, started scheduler (an empty page pool and prefix cache) on a
    worker, wired to its KV events as the worker wires its own."""
    from dynamo_tpu_torch.engine import InferenceScheduler

    worker.scheduler.stop()
    old = worker.scheduler
    worker.scheduler = InferenceScheduler(
        worker.runner, on_stored=worker.events.on_stored,
        on_removed=worker.events.on_removed)
    worker.scheduler.logits_tokenizer = old.logits_tokenizer
    worker.events.on_cleared()
    worker.scheduler.start()


def _near_tie_gap(worker, context: list, a: int, b: int) -> float:
    """How far below the top logit the lower of tokens a and b sits after
    `context`: one eager unpadded forward on the worker's runner, into
    pages 1.. of a fresh scheduler's pool (fresh again after)."""
    _fresh_scheduler(worker)
    ps = worker.runner.config.page_size
    table = np.arange(1, -(-len(context) // ps) + 1, dtype=np.int32)
    logits, _ = _unpadded_prefill(worker.runner, context, 0, table,
                                  len(context))
    row = logits.float().cpu().numpy()
    _fresh_scheduler(worker)
    return float(row.max() - min(row[a], row[b]))


def _prefill_worker(dev: torch.device, worker):
    """A TorchWorker in mode "prefill" on `worker`'s weight tensors, its
    prefill keys captured up front. Returns it and the seconds it took."""
    from dynamo_tpu_torch.engine import TorchWorker

    t0 = time.perf_counter()
    prefill = TorchWorker(worker.model_config, worker.runner_config,
                          device=dev, params=worker.runner.model,
                          mode="prefill", component="prefill")
    pcfg = prefill.runner.config
    for rows, bucket in prefill.runner.prefill_keys():
        row = (np.zeros(bucket, np.int32), 0,
               np.zeros(pcfg.max_pages_per_seq, np.int32),
               min(bucket, pcfg.max_context), (0.0, 1.0, 0, 0))
        prefill.runner.prefill_chunk_batch([row] * rows)
    return prefill, time.perf_counter() - t0


def _timeline_split(rid: str) -> dict:
    """A disaggregated request's TTFT split from the flight recorder's
    timelines: the frontend's (and decode worker's) `rid` and the prefill
    leg's `rid#prefill`. ttft: received -> the decode side's first token;
    prefill_leg: the leg's received -> its first token; pull: the kv_pull
    event's duration (with its split: wait / frames / assemble / stage on
    the dcn link, wait / gather / copy on the ici link); onboard: the
    pull's end -> the decode side's first token (admission and the scatter;
    on dcn the staged upload too)."""
    from dynamo_tpu_torch.runtime.flight_recorder import get_recorder

    rec = get_recorder()
    tl, leg = rec.get(rid), rec.get(f"{rid}#prefill")
    check(tl is not None and leg is not None,
          f"{rid}: its timelines are not in the flight recorder")
    pulls = [e for e in tl.events if e["event"] == "kv_pull"]
    check(len(pulls) == 1, f"{rid}: {len(pulls)} kv_pull events")
    pull = pulls[0]
    first = tl.phases["first_token"]
    split = {k: v for k, v in pull.items()
             if k.endswith("_ms") and k != "duration_ms"}
    return {"link": pull["link"],
            "ttft_ms": (first - tl.phases["received"]) * 1e3,
            "prefill_leg_ms": (leg.phases["first_token"]
                               - leg.phases["received"]) * 1e3,
            "pull_ms": pull["duration_ms"],
            "onboard_ms": (first - pull["ts"]) * 1e3
            + split.get("stage_ms", 0.0),
            "pull_split": split, "phases": sorted(tl.phases),
            "status": tl.status}


def _steptrace_windows(label: str, samples: list, kind: str) -> dict:
    """Every committed step of `samples` (StepSamples of one scheduler)
    splits into host + device == wall; at least one is of `kind`
    (decode-only, or prefill-carrying). Returns counts and means."""
    bad = [s for s in samples
           if abs(s.host_ms + s.device_ms - s.wall_ms) > 1e-6 * max(
               1.0, s.wall_ms)]
    check(samples and not bad,
          f"{label}: {len(bad)} of {len(samples)} steps break host + device "
          "== wall")
    if kind == "decode":
        of_kind = [s for s in samples if set(s.device_by_phase) == {"decode"}]
    else:
        of_kind = [s for s in samples if "prefill" in s.device_by_phase]
    check(of_kind, f"{label}: no {kind} step committed")
    return {"steps": len(samples), f"{kind}_steps": len(of_kind),
            "device_ms_mean": float(np.mean([s.device_ms for s in of_kind])),
            "host_ms_mean": float(np.mean([s.host_ms for s in of_kind])),
            "wall_ms_mean": float(np.mean([s.wall_ms for s in of_kind]))}


class _DecodeEvents:
    """An independent reading of the step trace's decode windows: CUDA
    events recorded on the step stream around each decode dispatch of a
    worker's runner (`decode_multi`, `decode`), grouped by the step that
    dispatched them. Recording adds no sync; the events are read after the
    traffic. A context manager around the traffic (a no-op on the CPU)."""

    def __init__(self, worker) -> None:
        self.runner = worker.runner
        self.trace = worker.scheduler.steptrace
        self.pending: list = []
        self.steps: list = []  # (StepSample, [(start, end) events])
        self._commit = None

    def __enter__(self) -> "_DecodeEvents":
        if self.runner.device.type != "cuda":
            return self
        for name in ("decode_multi", "decode"):
            def timed(*args, _fn=getattr(self.runner, name), **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args, **kwargs)
                end.record()
                self.pending.append((start, end))
                return out
            setattr(self.runner, name, timed)
        self._commit = self.trace.__dict__.get("commit")
        commit = self.trace.commit

        def committing(wall_ms):
            sample = commit(wall_ms)
            self.steps.append((sample, self.pending))
            self.pending = []
            return sample

        self.trace.commit = committing
        return self

    def __exit__(self, *exc) -> None:
        if self.runner.device.type != "cuda":
            return
        del self.runner.decode_multi, self.runner.decode
        if self._commit is None:
            del self.trace.commit
        else:
            self.trace.commit = self._commit


def _check_decode_windows(label: str, events: _DecodeEvents) -> dict:
    """Each decode-only step's device window (perf/steptrace.py: the decode
    submit's end to its readback's end, host clock) against the card's own
    clock: its dispatches' CUDA events, the first one's start to the last
    one's end. The card cannot start that work before the first submit
    began nor end it after the readback, so in every step gpu <= dispatch +
    device (+0.5 ms for two clocks): the window misses at most what ran
    during the submit. In a decode-only step the host runs nothing long
    between submit and readback, so the window holds little besides the
    card's time: its median is at most 10% + 1 ms above the card's.
    Returns the medians and the counts."""
    if events.runner.device.type != "cuda":
        return {}
    torch.cuda.synchronize()
    rows = [(sample, evs[0][0].elapsed_time(evs[-1][1]))
            for sample, evs in events.steps
            if evs and set(sample.device_by_phase) == {"decode"}]
    check(rows, f"{label}: no decode-only step with its dispatch events")
    late = [(round(s.dispatch_ms, 3), round(s.device_ms, 3), round(g, 3))
            for s, g in rows if g > s.dispatch_ms + s.device_ms + 0.5]
    check(not late, f"{label}: {len(late)} of {len(rows)} decode steps ran "
                    f"longer on the card than their dispatch + device "
                    f"window (dispatch, device, card ms): {late[:6]}")
    device = float(np.median([s.device_ms for s, _ in rows]))
    card = float(np.median([g for _, g in rows]))
    check(device <= 1.1 * card + 1.0,
          f"{label}: the median decode window {device:.3f} ms exceeds the "
          f"card's {card:.3f} ms (CUDA events)")
    return {"decode_steps": len(rows), "device_ms_median": device,
            "card_ms_median": card,
            "dispatch_ms_median": float(np.median(
                [s.dispatch_ms for s, _ in rows]))}


BRIDGE_PAGES = 94  # a 1,500-token prompt's pages at page size 16


def _bridge_device_work(worker, prefill) -> dict:
    """The device work of one bridged pull of BRIDGE_PAGES pages, alone:
    the gather from the prefill pool into a fresh bundle and the in-place
    scatter into the decode pool (on one card the copy between them moves
    nothing), timed by `perf.steptrace.measure_device` with both schedulers
    idle, into pages the decode side's fresh scheduler then forgets. The
    bound: the bundle read and written twice at the H100's 3,350 GB/s."""
    from dynamo_tpu_torch.perf.steptrace import measure_device

    ids = list(range(1, BRIDGE_PAGES + 1))
    nbytes = prefill.runner.gather_pages_device(ids).tensor.nbytes

    def pull() -> None:
        worker.runner.scatter_pages(
            ids, prefill.runner.gather_pages_device(ids))

    timed = measure_device(pull, steps=8, trials=3, device=worker.device)
    _fresh_scheduler(worker)
    out = {"pages": BRIDGE_PAGES, "bundle_bytes": nbytes,
           "ms": timed["median_s"] * 1e3,
           "trials_ms": [t * 1e3 for t in timed["trials_s"]],
           "bound_ms": 4 * nbytes / 3350e9 * 1e3}
    emit("comesh_bridge_device", **out)
    return out


def _disagg_runs(dev: torch.device, worker, prefill, label: str,
                 bridge=None) -> dict:
    """The disaggregated main path at full width: `worker` decodes and
    `prefill` (a prefill-mode worker on its weight tensors) prefills, both
    on one port DistributedRuntime (file discovery, the TCP request plane,
    the status server on), a port Frontend in front with the prefill pool
    active. The standard 8 requests (32-1,500 prompt tokens, 64 out, half
    greedy) as streamed /v1/completions, each over an empty prefix cache on
    both workers, once with the streamed handoff (DYNT_DISAGG_PIPELINE=1)
    and once serial (0). With `bridge` (an IciKvBridge both workers hold)
    every pull takes the in-process device link; without, the host relay.

    Per request: the prefill leg's wall and its first kv_transfer_params,
    the pull (ms, bytes, GB/s, link), TTFT and ITL at the client, and the
    TTFT split from the flight-recorder timelines. Checks: the decode worker
    prefills 0 tokens; req-0's pulled pages equal the prefill worker's
    pages byte for byte; every pull takes the expected link; greedy streams
    equal the same requests served aggregated, or part only at a near-tie;
    every transfer is claimed and the prefill pool returns to its free
    count; the streamed run parks pages mid-prefill and the serial one
    none. With the bridge, also: hits == pulls == 8 in each run; every
    committed step of the decode worker (decode-only) and of the prefill
    worker (prefill-carrying) splits into host + device == wall;
    /debug/requests returns every request's timeline; one /debug/profile
    capture writes a trace naming the decode scope. Returns the runs,
    their launches and expected launches."""
    import tempfile

    from dynamo_tpu_torch.frontend import Frontend
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    link = "dcn" if bridge is None else "ici"
    pcfg = prefill.runner.config
    model = worker.card.name
    tok = ByteTokenizer()
    _, prompts = standard_traffic(worker.model_config.vocab_size)
    bodies = _bodies(prompts, "req")
    workers = {"prefill": prefill, "decode": worker}
    originals = {k: w.generate for k, w in workers.items()}
    legs: dict = {}  # (kind, request id) -> what the worker saw
    check_pages = 600  # req-0's prompt: its pages are held byte for byte
    seen: dict = {}

    def recording(kind: str):
        async def gen(body, ctx=None):
            rec = {"t_arrive": time.perf_counter(), "t_params": None,
                   "t_end": None, "tokens": [],
                   "disagg": bool(body.get("disaggregated_params"))}
            legs[(kind, body["request_id"])] = rec
            async with contextlib.aclosing(
                    originals[kind](body, ctx)) as stream:
                async for item in stream:
                    if item.get("kv") is not None and rec["t_params"] is None:
                        rec["t_params"] = time.perf_counter()
                    rec["tokens"] += item.get("t") or []
                    if "f" in item:
                        rec["t_end"] = time.perf_counter()
                    yield item
        return gen

    for kind, w in workers.items():
        w.generate = recording(kind)
    n_check = -(-check_pages // pcfg.page_size)

    def hook_pages() -> None:
        """Hold one request's pages on both sides: the prefill worker's,
        gathered as their transfer releases them, and the decode worker's
        pulled bundle (the relay's staged upload, or the bridge's)."""
        release = prefill.scheduler.release_transfer_pages

        def gather_then_release(seq):
            if seq.prompt_len == check_pages and "src" not in seen:
                seen["src"] = prefill.runner.gather_pages(
                    [int(p) for p in seq.block_table[:n_check]])
            release(seq)

        prefill.scheduler.release_transfer_pages = gather_then_release
        if bridge is None:
            stage = worker.runner.stage_bundle

            def keep(blocks):
                if blocks.shape[0] == n_check and "pulled" not in seen:
                    seen["pulled"] = blocks.clone()
                return stage(blocks)

            worker.runner.stage_bundle = keep
            return
        pull = bridge.pull

        async def keep_bridged(*args, **kwargs):
            bundle, first = await pull(*args, **kwargs)
            if (bundle is not None and bundle.tensor.shape[0] == n_check
                    and "pulled" not in seen):
                seen["pulled"] = bundle.tensor.cpu()
            return bundle, first

        bridge.pull = keep_bridged

    def unhook() -> None:
        del prefill.scheduler.release_transfer_pages
        if bridge is None:
            del worker.runner.stage_bundle
        else:
            del bridge.pull

    def http_body(i: int) -> dict:
        s = bodies[i]["sampling"]
        return {"model": model, "prompt": bodies[i]["token_ids"],
                "max_tokens": s["max_tokens"],
                "temperature": s["temperature"], "top_p": s["top_p"],
                "seed": s["seed"], "ignore_eos": True, "stream": True,
                "stream_options": {"include_usage": True}}

    async def until(pred, what: str, timeout: float = 60.0) -> None:
        t = time.perf_counter()
        while not pred():
            check(time.perf_counter() - t < timeout, f"{label}: {what}")
            await asyncio.sleep(0.002)

    def kept_steps(w) -> list:
        """Every step the worker's scheduler commits from here (a serving
        worker's metrics tick drains the trace's own buffer)."""
        trace = w.scheduler.steptrace
        commit, kept = trace.commit, []

        def keeping(wall_ms):
            kept.append(commit(wall_ms))
            return kept[-1]

        trace.commit = keeping
        return kept

    async def one_run(port: int, name: str, pipeline: int) -> dict:
        prefill.disagg_pipeline = pipeline
        _fresh_scheduler(prefill)
        _fresh_scheduler(worker)
        steps = {"decode": kept_steps(worker), "prefill": kept_steps(prefill)}
        if name == "streamed":
            hook_pages()
        streamed0 = prefill.scheduler.stats.disagg_streamed_pages
        pulls0 = len(worker.pulls)
        bridged0 = (bridge.pulls, bridge.hits) if bridge else (0, 0)
        events = _DecodeEvents(worker)
        with events if bridge is not None else contextlib.nullcontext():
            start = time.perf_counter()
            answers = await asyncio.wait_for(asyncio.gather(*[
                _http(port, "POST", "/v1/completions", http_body(i))
                for i in range(len(bodies))]), 600)
            wall = time.perf_counter() - start
            pool = prefill.scheduler.pool
            await until(lambda: len(prefill.transfers) == 0
                        and _reclaimable_pages(pool) == pool.num_pages - 1,
                        f"{name}: transfers unclaimed or pages held")
            if name == "streamed":
                unhook()
            # every step the schedulers ran has committed (the finish frames
            # go out inside a step, its commit after)
            await until(lambda: all(
                w.scheduler.steptrace.steps == w.scheduler.stats.steps
                and w.scheduler.queue_depth() == (0, 0)
                for w in workers.values()), f"{name}: steps uncommitted")
        pulls = {p["request_id"]: p for p in list(worker.pulls)[pulls0:]}
        rows = []
        for i, res in enumerate(answers):
            o = _sse_outcome(res)
            rid = res["headers"]["x-request-id"]
            check(o["finish"] == "length"
                  and o["usage"]["completion_tokens"] == 64
                  and o["usage"]["prompt_tokens"] == len(prompts[i]),
                  f"{name}: req-{i} {o['finish']} {o['usage']}")
            leg_p, leg_d = legs[("prefill", rid)], legs[("decode", rid)]
            check(leg_d["disagg"] and rid in pulls,
                  f"{name}: req-{i} was not pulled")
            check(tok.decode(leg_d["tokens"]) == o["text"],
                  f"{name}: req-{i} text differs from the decode worker's")
            pull = pulls[rid]
            check(pull["link"] == link,
                  f"{name}: req-{i} pulled over {pull['link']}, not {link}")
            split = _timeline_split(rid)
            check(split["link"] == link and split["status"] == "ok",
                  f"{name}: req-{i} timeline {split['link']} "
                  f"{split['status']}")
            rows.append({
                "rid": f"req-{i}", "request_id": rid,
                "prompt": len(prompts[i]),
                "tokens": leg_d["tokens"],
                "prefill_leg_ms": (leg_p["t_end"] - leg_p["t_arrive"]) * 1e3,
                "params_ms": (leg_p["t_params"] - leg_p["t_arrive"]) * 1e3,
                "pull_ms": pull["pull_ms"], "pull_bytes": pull["bytes"],
                "pull_pages": pull["pages"],
                "pull_GB_per_s": pull["bytes"] / pull["pull_ms"] / 1e6,
                "ttft_ms": (o["stamps"][0] - o["t0"]) * 1e3,
                "itl_ms": (o["stamps"][-1] - o["stamps"][0]) * 1e3 / 63,
                "timeline": split})
        out = {"wall_s": wall, "rows": rows,
               "streamed_pages": (prefill.scheduler.stats
                                  .disagg_streamed_pages - streamed0),
               "decode_prefill_tokens": worker.scheduler.stats.prefill_tokens,
               "prefill_prefill_tokens": (prefill.scheduler.stats
                                          .prefill_tokens)}
        if bridge is not None:
            out["bridge"] = {"pulls": bridge.pulls - bridged0[0],
                             "hits": bridge.hits - bridged0[1]}
            out["steptrace"] = {kind: _steptrace_windows(
                f"{label}: {name}", kept, kind) for kind, kept in steps.items()}
            out["steptrace"]["decode_windows"] = _check_decode_windows(
                f"{label}: {name}", events)
        return out

    async def capture(status_port: int, ms: int) -> tuple:
        """One /debug/profile capture: its answer and the seconds it took.
        A capture that has not answered in 120 s prints every thread's
        stack and fails the phase."""
        t = time.perf_counter()
        try:
            res = await asyncio.wait_for(_http(
                status_port, "GET", f"/debug/profile?duration_ms={ms}"), 120)
        except asyncio.TimeoutError:
            faulthandler.dump_traceback(all_threads=True)
            check(False, f"{label}: a {ms} ms /debug/profile capture hung")
        check(res["status"] == 200, f"{label}: /debug/profile "
                                    f"{res['status']} {res['text'][:300]}")
        return json.loads(res["text"]), time.perf_counter() - t

    async def debug_routes(fe_port: int, status_port: int,
                           rids: list) -> dict:
        """/debug/requests holds every request's timelines; /debug/profile
        captures of 1 ms and PROFILE_MS on idle schedulers each write a
        trace; one of PROFILE_MS, taken while the 8 requests decode, writes
        a Chrome trace that names the decode scope."""
        res = await _http(status_port, "GET", "/debug/requests?limit=512")
        check(res["status"] == 200,
              f"{label}: /debug/requests {res['status']}")
        listed = {t["request_id"]: t
                  for t in json.loads(res["text"])["completed"]}
        missing = [r for r in rids
                   if r not in listed or f"{r}#prefill" not in listed]
        check(not missing, f"{label}: /debug/requests lacks {missing}")
        check(all(any(e["event"] == "kv_pull" and e["link"] == link
                      for e in listed[r]["events"]) for r in rids),
              f"{label}: a timeline has no {link} kv_pull event")
        # Idle schedulers: the operator's first capture of a quiet worker
        # (the profiler's first start in a process takes seconds on the
        # card's machine: CUPTI and Kineto set up)
        idle = []
        for ms in (1, PROFILE_MS):
            got, took = await capture(status_port, ms)
            check("trace.json" in got["files"],
                  f"{label}: an idle capture wrote {got['files']}")
            idle.append({"duration_ms": ms, "request_s": took,
                         **{k: got[k] for k in ("start_s", "stop_s",
                                                "export_s")}})
        emit(f"{label}_profile_idle", captures=idle)
        # Waves of long streams until the capture returns: its window must
        # find the decode worker stepping. A token per dispatch: a fused,
        # pipelined dispatch of 16 tokens lasts about as long as the window
        # itself.
        with knobs(DYNT_DECODE_BLOCK="1"):
            _fresh_scheduler(worker)
        done = asyncio.Event()

        async def waves() -> int:
            n = 0
            while not done.is_set():
                await asyncio.gather(*[
                    _http(fe_port, "POST", "/v1/completions",
                          {**http_body(i), "max_tokens": PROFILE_TOKENS})
                    for i in range(len(bodies))])
                n += 1
            return n

        traffic = asyncio.ensure_future(waves())
        steps0 = worker.runner.decode_steps
        await until(lambda: worker.runner.decode_steps > steps0 + 8,
                    "the capture's requests never decoded")
        capture_res, capture_s = await capture(status_port, PROFILE_MS)
        steps_during = worker.runner.decode_steps - steps0
        done.set()
        n_waves = await asyncio.wait_for(traffic, 600)
        path = Path(capture_res["trace_dir"]) / "trace.json"
        events = json.loads(path.read_text()).get("traceEvents", [])
        names = [e.get("name") for e in events]
        emit(f"{label}_profile", request_s=capture_s, waves=n_waves,
             decode_forwards=steps_during,
             **{k: capture_res[k] for k in ("start_s", "stop_s", "export_s")})
        check("decode" in names,
              f"{label}: the profile names no decode scope: "
              f"{collections.Counter(names).most_common(12)}")
        out = {"timelines": len(listed), "idle_captures": idle,
               "profile": {"duration_ms": capture_res["duration_ms"],
                           "request_s": capture_s, "waves": n_waves,
                           "start_s": capture_res["start_s"],
                           "decode_forwards_by_its_end": steps_during,
                           "trace_bytes": path.stat().st_size,
                           "decode_scopes": names.count("decode"),
                           "prefill_scopes": names.count("prefill"),
                           "kernel_events": sum(
                               1 for e in events
                               if e.get("cat") == "kernel")}}
        shutil.rmtree(capture_res["trace_dir"], ignore_errors=True)
        return out

    async def serve() -> dict:
        root = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
        cfg = RuntimeConfig(discovery_backend="file", discovery_path=root,
                            tcp_host="127.0.0.1", system_enabled=False)
        # the workers' runtime serves the status server (the debug routes)
        # on the comesh run
        rt_w = await DistributedRuntime(dataclasses.replace(
            cfg, system_enabled=bridge is not None, system_port=0)).start()
        rt_fe = await DistributedRuntime(dataclasses.replace(cfg)).start()
        fe = Frontend(rt_fe, host="127.0.0.1", port=0)
        out = {}
        try:
            for w in workers.values():
                w._served, w._tasks = [], []
                await w.serve(rt_w)
            await fe.start()
            await until(lambda: fe.manager.get(model) is not None
                        and (fe.watcher._prefill_pools.get(model) is not None)
                        and fe.watcher._prefill_pools[model].active(),
                        "the model and its prefill pool listed")
            # counts to zero just before the main path
            reset_counts()
            for w in workers.values():
                reset_runner_counts(w.runner)
            for name, pipeline in DISAGG_RUNS:
                out[name] = await one_run(fe.port, name, pipeline)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out["launches"] = read_counts()
            out["want"] = {}
            for w in workers.values():
                r = w.runner
                for name, n in expected_counts(
                        r, dev, decode=r.decode_steps,
                        prefill=r.prefill_steps,
                        warm=r.graph_warm_forwards).items():
                    out["want"][name] = out["want"].get(name, 0) + n
            out["forwards"] = {k: launched_forwards(w.runner) | {
                "prefill": w.runner.prefill_steps}
                for k, w in workers.items()}
            if bridge is not None:
                # after the counted runs: the capture's traffic is extra
                out["bridge_device"] = _bridge_device_work(worker, prefill)
                with knobs(DYNT_PROF_DIR=prof_dir):
                    out["debug"] = await debug_routes(
                        fe.port, rt_w.status_server.port,
                        [r["request_id"] for name, _ in DISAGG_RUNS
                         for r in out[name]["rows"]])
        finally:
            await fe.close()
            for w in workers.values():
                await w.shutdown()
                del w.generate
            await rt_fe.shutdown()
            await rt_w.shutdown()
            shutil.rmtree(root, ignore_errors=True)
            shutil.rmtree(prof_dir, ignore_errors=True)
        return out

    # the captures' traces go under TMPDIR, not the knob's shared default
    prof_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_profiles_")
    out = asyncio.run(serve())
    out.update(prompts=prompts, bodies=bodies, seen=seen)
    return out


def _check_disagg(worker, label: str, out: dict, aggregated: dict) -> dict:
    """The checks both disaggregated phases share (see `_disagg_runs`);
    returns each greedy stream's first divergence from the aggregated one
    and its near-tie gap."""
    prompts, bodies, seen = out["prompts"], out["bodies"], out["seen"]
    for name, _ in DISAGG_RUNS:
        run = out[name]
        check(run["decode_prefill_tokens"] == 0,
              f"{label}: {name}: the decode worker prefilled "
              f"{run['decode_prefill_tokens']} tokens")
        # req-1 hits req-0's 512-token prefix only if req-0's transfer
        # released its pages into the cache before req-1 was admitted
        total = sum(len(p) for p in prompts)
        check(total - 512 <= run["prefill_prefill_tokens"] <= total,
              f"{label}: {name}: the prefill worker prefilled "
              f"{run['prefill_prefill_tokens']} tokens of {total}")
        check((run["streamed_pages"] > 0) == (name == "streamed"),
              f"{label}: {name}: {run['streamed_pages']} pages streamed")
    check("src" in seen and "pulled" in seen
          and seen["src"].shape == seen["pulled"].shape
          and torch.equal(seen["src"].view(torch.uint8),
                          seen["pulled"].view(torch.uint8)),
          f"{label}: the pulled pages differ from the prefill worker's")
    # greedy streams against the aggregated run, parting only at a near-tie
    continuations = {}
    for name, _ in DISAGG_RUNS:
        for i, row in enumerate(out[name]["rows"]):
            rid = row["rid"]
            if not _greedy(rid):
                continue
            want, got = aggregated[rid], row["tokens"]
            d = _first_divergence(want, got)
            gap = None
            if d < len(want):
                gap = _near_tie_gap(worker, list(bodies[i]["token_ids"])
                                    + want[:d], want[d], got[d])
                check(gap <= NEAR_TIE_NATS,
                      f"{label}: {name}: {rid} parts from the aggregated "
                      f"stream at token {d}, {gap:.3f} nats below the top "
                      f"(not a near-tie, <= {NEAR_TIE_NATS})")
            continuations[f"{name}/{rid}"] = (d if d < len(want) else None,
                                              gap)
    check(out["launches"] == out["want"] and (
        worker.device.type != "cuda"
        or out["launches"]["paged_decode_attention_pool"] > 0),
          f"{label}: kernel launches {out['launches']} != expected "
          f"{out['want']}")
    return continuations


def _disagg_summary(out: dict) -> dict:
    """Per run: means over the 8 requests (client-side and timeline
    splits) and each request's row."""
    def means(rows) -> dict:
        keys = ("prefill_leg_ms", "params_ms", "pull_ms", "pull_GB_per_s",
                "ttft_ms", "itl_ms")
        m = {k: float(np.mean([r[k] for r in rows])) for k in keys}
        tl = [r["timeline"] for r in rows]
        m["timeline"] = {k: float(np.mean([t[k] for t in tl]))
                         for k in ("ttft_ms", "prefill_leg_ms", "pull_ms",
                                   "onboard_ms")}
        m["timeline"]["pull_split"] = {
            k: float(np.mean([t["pull_split"].get(k, 0.0) for t in tl]))
            for k in tl[0]["pull_split"]}
        return m

    return {name: {"wall_s": out[name]["wall_s"],
                   "streamed_pages": out[name]["streamed_pages"],
                   "pulled_bytes": sum(r["pull_bytes"]
                                       for r in out[name]["rows"]),
                   "mean": means(out[name]["rows"]),
                   **{k: out[name][k] for k in ("bridge", "steptrace")
                      if k in out[name]},
                   "requests": [{k: v for k, v in r.items()
                                 if k != "tokens"}
                                for r in out[name]["rows"]]}
            for name, _ in DISAGG_RUNS}


def phase_disagg(dev: torch.device, worker) -> tuple:
    """Disaggregated prefill/decode through the host relay (the `dcn` link):
    `_disagg_runs` without a bridge. Returns the phase's launches, the
    prefill worker (the comesh phase reuses it) and the aggregated greedy
    streams the runs were held against."""
    label = "disagg"
    t_phase = time.perf_counter()
    # the same requests served aggregated on the decode worker
    aggregated = _held_streams(dev, worker, f"{label}_aggregated")["streams"]
    prefill, prefill_setup_s = _prefill_worker(dev, worker)
    out = _disagg_runs(dev, worker, prefill, label)
    continuations = _check_disagg(worker, label, out, aggregated)
    for w in (worker, prefill):
        check_graphed(w.runner, label)
    emit(label, model=worker.card.name,
         nvidia_smi=nvidia_smi() if dev.type == "cuda" else None,
         kv_dtype=worker.runner.config.kv_dtype, link="dcn",
         prefill_setup_s=prefill_setup_s,
         prefill_keys=len(prefill.runner.prefill_keys()),
         runs=_disagg_summary(out), pulled_pages_byte_equal=True,
         greedy_vs_aggregated=continuations, forwards=out["forwards"],
         kernel_launches=out["launches"],
         seconds=time.perf_counter() - t_phase)
    return out["launches"], prefill, aggregated


def phase_comesh(dev: torch.device, worker, prefill, aggregated) -> dict:
    """Co-located disaggregation on one card (`--mode comesh`'s in-process
    KV bridge, the `ici` link): the disagg phase's decode and prefill
    workers share one IciKvBridge, so every pull is a gather from the
    prefill pool, a device-to-device copy (none on one card) and an
    in-place scatter into the decode pool at admission, with no host copy.
    `_disagg_runs` with the bridge: hits == pulls == 8 in each run, the
    decode worker prefills 0 tokens, req-0's bridged pages equal the prefill
    pool's byte for byte, greedy streams equal the aggregated ones or part
    at a near-tie, the step-trace invariant on both workers' steps, and the
    debug routes. Prints the TTFT split (prefill leg, bridge pull,
    onboard) from the timelines. Returns the phase's launches."""
    from dynamo_tpu_torch.engine.ici_transfer import IciKvBridge

    label = "comesh"
    t_phase = time.perf_counter()
    bridge = IciKvBridge()
    # the CLI builds the pair with ici_bridge=; here the two live workers
    # join one bridge
    bridge.attach_prefill(prefill)
    prefill.ici_bridge = worker.ici_bridge = bridge
    try:
        out = _disagg_runs(dev, worker, prefill, label, bridge=bridge)
    finally:
        prefill.ici_bridge = worker.ici_bridge = None
    for name, _ in DISAGG_RUNS:
        got = out[name]["bridge"]
        check(got["pulls"] == got["hits"] == len(out["bodies"]),
              f"{label}: {name}: bridge pulls {got['pulls']}, hits "
              f"{got['hits']} (a pull fell back to recompute)")
    continuations = _check_disagg(worker, label, out, aggregated)
    for w in (worker, prefill):
        check_graphed(w.runner, label)
    emit(label, model=worker.card.name,
         nvidia_smi=nvidia_smi() if dev.type == "cuda" else None,
         kv_dtype=worker.runner.config.kv_dtype, link="ici",
         runs=_disagg_summary(out), pulled_pages_byte_equal=True,
         greedy_vs_aggregated=continuations, forwards=out["forwards"],
         debug=out["debug"], kernel_launches=out["launches"],
         seconds=time.perf_counter() - t_phase)
    prefill.close()
    return out["launches"]


# Decode attention against the batch: one greedy sequence decoded at batch 1
# and batch 8, at table widths 32 and 128, with the port's split plan (a
# span fixed by the page size) and with the plan it had before (a span that
# followed the batch and the table width)
INVARIANCE_WIDTHS = (32, 128)
INVARIANCE_BATCHES = (1, 8)
INVARIANCE_STEPS = 32
INVARIANCE_LENGTHS = (300, 64, 200, 350, 90, 400, 128, 256)  # slot 0 first
TARGET_BLOCKS = 4 * 132  # the earlier plan's aim: 4 blocks per SM


def _batch_following_plan(batch: int, kh: int, rows: int, max_pages: int,
                          ps: int):
    """The decode kernel's split plan before this port fixed its span: the
    shortest span that cuts the table into no more splits than it takes
    for the grid to reach TARGET_BLOCKS blocks, so it follows the batch and
    the table width."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    row_tile = 16 if rows <= 16 else 32
    row_tiles = -(-rows // row_tile)
    unit = pa.TILE * ps // math.gcd(pa.TILE, ps)
    units = -(-(max_pages * ps) // unit)
    want = -(-TARGET_BLOCKS // (batch * kh * row_tiles))
    per = max(1, min(-(-units // want), pa.MAX_SPAN // unit))
    n_split = -(-units // per)
    return pa.SplitPlan(row_tile, row_tiles, per * unit, n_split,
                        (n_split, kh * row_tiles, batch))


def _greedy_at(runner, prompts: list, tables: np.ndarray, firsts: list,
               batch: int, width: int) -> tuple:
    """Slot 0's greedy tokens and raw logits rows over INVARIANCE_STEPS
    decode steps (graph replays of the decode_logits key) with the first
    `batch` sequences live, at table width `width`."""
    b = batch
    toks = np.array(firsts[:b], np.int32)
    lens = np.array([len(p) for p in prompts[:b]], np.int32)
    zeros_f, ones_f = np.zeros(b, np.float32), np.ones(b, np.float32)
    tokens, rows = [int(toks[0])], []
    for step in range(INVARIANCE_STEPS):
        nxt = runner.decode(toks, lens.copy(), tables[:b, :width],
                            lens + 1, np.ones(b, bool), zeros_f, ones_f,
                            np.zeros(b, np.int32), np.zeros(b, np.uint32),
                            np.full(b, step, np.int32), want_logits=True,
                            logits_slots=[0])
        rows.append(runner.last_decode_logits[0].astype(np.float32))
        toks = nxt.astype(np.int32)
        lens = lens + 1
        tokens.append(int(toks[0]))
    return tokens, np.stack(rows)


def phase_batch_invariance(dev: torch.device, worker) -> None:
    """Does slot 0's decode depend on the batch it is in? The bf16 runner
    prefills 8 sequences (slot 0: 300 tokens), then decodes slot 0 greedily
    at batch 1 and batch 8 and table widths 32 and 128, with the port's
    split plan (`ops.paged_attention.split_plan`, span fixed by the page
    size) and with the earlier, batch-following one. Per configuration: the
    max |delta logits| against batch 1 / width 32 of the same plan over the
    steps before the streams part, and the first token at which they part;
    the port's plan must give the same logits, bit for bit, in all four.
    Then rows 1 and 2 timed at the engine's shapes (16 slots, 8 live, widths
    32 and 128) with each plan, in turns (port's, earlier, earlier,
    port's)."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    t_phase = time.perf_counter()
    runner = worker.runner
    ps = runner.config.page_size
    vocab = worker.model_config.vocab_size
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(1, vocab, n) for n in INVARIANCE_LENGTHS]
    _fresh_scheduler(worker)  # an idle scheduler over an empty pool
    tables = np.zeros((len(prompts), max(INVARIANCE_WIDTHS)), np.int32)
    firsts = []
    for i, p in enumerate(prompts):
        need = -(-(len(p) + INVARIANCE_STEPS + 1) // ps)
        check(need <= min(INVARIANCE_WIDTHS), "invariance: a sequence "
              "outgrows the narrow table")
        tables[i, :need] = 1 + i * min(INVARIANCE_WIDTHS) + np.arange(need)
        firsts.append(runner.prefill_chunk(np.asarray(p, np.int32), 0,
                                           tables[i], len(p),
                                           (0.0, 1.0, 0, 0)))
    plans = {"fixed": pa.split_plan, "batch_following": _batch_following_plan}
    results: dict = {}
    try:
        for plan_name, plan in plans.items():
            pa.split_plan = plan
            runner.step_graphs.clear()  # the graphs captured the old plan
            base = None
            for width in INVARIANCE_WIDTHS:
                for batch in INVARIANCE_BATCHES:
                    tokens, logits = _greedy_at(runner, prompts, tables,
                                                firsts, batch, width)
                    key = f"{plan_name}/B={batch}/W={width}"
                    if base is None:
                        base = (tokens, logits)
                    d = _first_divergence(base[0], tokens)
                    # logits rows before the streams part see one context
                    upto = min(d, INVARIANCE_STEPS)
                    delta = (float(np.abs(logits[:upto]
                                          - base[1][:upto]).max())
                             if upto else 0.0)
                    results[key] = {
                        "max_abs_delta_logits": delta,
                        "first_parting_token": (d if d < len(tokens)
                                                else None),
                        "split": pa.split_plan(batch, runner.model_config
                                               .n_kv_heads,
                                               runner.model_config.n_q_heads
                                               // runner.model_config
                                               .n_kv_heads, width,
                                               ps)._asdict()}
    finally:
        pa.split_plan = plans["fixed"]
        runner.step_graphs.clear()
    _fresh_scheduler(worker)
    # (on the CPU the plain versions run: their sums follow the gathered
    # width, so only the card's kernel is held to it)
    bad = {k: v for k, v in results.items() if k.startswith("fixed/")
           and (v["max_abs_delta_logits"] or v["first_parting_token"])}
    check(dev.type != "cuda" or not bad,
          f"batch_invariance: the port's plan depends on the batch or the "
          f"width: {bad}")

    # rows 1 and 2 at the engine's shapes with each plan, in turns
    hist = [0, 1, 15, 16, 17, 1000, 2047, 1500] + [0] * 8
    st = _attention_setup(dev, hist, n_layers=8, n_pages=320)
    q = torch.randn((len(hist), st["cfg"].n_q_heads, st["hd"]),
                    generator=st["gen"], device=dev).to(torch.bfloat16)
    times: dict = {}
    for name, quantized in (("paged_decode_attention_pool", False),
                            ("paged_decode_attention_pool_int8", True)):
        kv = st["values"] if quantized else st["pool"]
        scales = st["scales"] if quantized else None
        for width in INVARIANCE_WIDTHS:
            lens = (st["lens"] if width == 128 else
                    torch.clamp(st["lens"], max=width * st["ps"]))
            tables_w = st["tables"][:, :width].contiguous()

            def call(i, kv=kv, scales=scales, tables_w=tables_w, lens=lens):
                return pa.paged_decode_attention_pool(
                    q, kv, i % st["n_layers"], tables_w, lens,
                    kv_scales=scales)

            ms = {"fixed": [], "batch_following": []}
            for plan_name in ("fixed", "batch_following", "batch_following",
                              "fixed"):
                pa.split_plan = plans[plan_name]
                try:
                    ms[plan_name].append(gpu_time_ms(call, 200))
                finally:
                    pa.split_plan = plans["fixed"]
            times[f"{name}[W={width}]"] = {
                "fixed_ms": ms["fixed"],
                "batch_following_ms": ms["batch_following"],
                "fixed_over_batch_following": float(
                    np.mean(ms["fixed"]) / np.mean(ms["batch_following"]))}
    del st, q
    free_memory()
    emit("batch_invariance", model=worker.card.name,
         nvidia_smi=nvidia_smi() if dev.type == "cuda" else None,
         steps=INVARIANCE_STEPS, lengths=list(INVARIANCE_LENGTHS),
         span=pa.SPAN, results=results, times=times,
         seconds=time.perf_counter() - t_phase)


# An HF checkpoint directory: written by the port, served from disk

CKPT_SHARD_BYTES = 5 * 10**9  # the HF writers' default shard size ("5GB")
CKPT_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
              r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
              r"|\s+")
# Llama-3's named special tokens among its 256 (ids 128,000 + offset)
CKPT_SPECIALS = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
                 6: "<|start_header_id|>", 7: "<|end_header_id|>",
                 8: "<|eom_id|>", 9: "<|eot_id|>"}
CKPT_TEMPLATE = (
    "{{- bos_token }}"
    "{%- if messages[0]['role'] == 'system' %}"
    "{%- set system_message = messages[0]['content']|trim %}"
    "{%- set messages = messages[1:] %}"
    "{%- else %}{%- set system_message = '' %}{%- endif %}"
    "{{- '<|start_header_id|>system<|end_header_id|>\\n\\n' }}"
    "{{- system_message }}{{- '<|eot_id|>' }}"
    "{%- for message in messages %}"
    "{{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'"
    " + message['content'] | trim + '<|eot_id|>' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}"
    "{{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}"
    "{%- endif %}")
CKPT_CHATS = (
    [{"role": "user", "content": "héllo"}],
    [{"role": "system", "content": " You are terse. "},
     {"role": "user", "content": "Name three colors, then 42."}],
    [{"role": "user", "content": "a"}, {"role": "assistant", "content": "b"},
     {"role": "user", "content": "日本語 and emoji 😀 — ok?"}],
)


def llama3_tokenizer_json(vocab_size: int) -> dict:
    """A byte-level BPE `tokenizer.json` in Llama-3's form (the Split regex,
    then ByteLevel; ignore_merges) with exactly `vocab_size` ids: the 256
    byte tokens, merges from a fixed rule up to vocab_size - 256 (every pair
    of printable-ASCII byte tokens, then each pair with one more, in order),
    and 256 special tokens after them."""
    from dynamo_tpu_torch.llm.hf_tokenizer import bytes_to_unicode

    table = bytes_to_unicode()
    vocab = {table[b]: b for b in range(256)}
    n_regular = vocab_size - 256
    printable = [table[b] for b in range(32, 127)]
    merges = []
    pairs = [(a, b) for a in printable for b in printable]
    rule = pairs + [(a + b, c) for a, b in pairs for c in printable]
    for a, b in rule[:n_regular - len(vocab)]:
        vocab[a + b] = len(vocab)
        merges.append(f"{a} {b}")
    check(len(vocab) == n_regular, "the merge rule ran out of tokens")
    reserved = iter(range(256))
    added = []
    for k in range(256):
        name = CKPT_SPECIALS.get(k)
        if name is None:
            name = f"<|reserved_special_token_{next(reserved)}|>"
        added.append({"id": n_regular + k, "content": name,
                      "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False, "special": True})
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": False}
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": added, "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": CKPT_SPLIT},
                 "behavior": "Isolated", "invert": False}, byte_level]},
            "post_processor": byte_level, "decoder": byte_level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": True,
                      "vocab": vocab, "merges": merges}}


def _view_model(model, config):
    """A Transformer over the first config.n_layers layers of `model`,
    sharing its tensors (quantizing it replaces its leaves, not
    `model`'s)."""
    from dynamo_tpu_torch.models import Transformer

    tree = {"embed": model.embed, "final_norm": model.final_norm,
            "lm_head": model.lm_head,
            "layers": [{k: layer[k] for k in layer.keys()}
                       for layer in model.layers[:config.n_layers]]}
    return Transformer(config, tree)


class _RssPeak:
    """The process's resident set, sampled every 20 ms from /proc while
    the block runs; `peak` in bytes."""

    def __init__(self) -> None:
        import threading

        self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self.start = self._rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def _timed_load(label: str, path: str, make_worker) -> tuple:
    """Build a worker from `path` through `make_worker()`, timing the
    checkpoint load inside it (`models.checkpoint.load_params`, as the
    worker calls it): seconds, GB/s, host RSS peak above the start, device
    memory peak above the weights' bytes."""
    import resource

    from dynamo_tpu_torch.engine import worker as worker_mod

    stats = {}
    load = worker_mod.load_params

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            model = load(*args, **kwargs)
            torch.cuda.synchronize()
            stats["load_s"] = time.perf_counter() - t0
        weights = sum(t.numel() * t.element_size() for t in model.parameters())
        stats.update(
            weights_GB=weights / 1e9,
            load_GB_per_s=weights / 1e9 / stats["load_s"],
            host_rss_peak_above_start_GB=(rss.peak - rss.start) / 1e9,
            host_rss_peak_GB=rss.peak / 1e9,
            device_peak_above_weights_GB=(torch.cuda.max_memory_allocated()
                                          - before - weights) / 1e9)
        return model

    worker_mod.load_params = timed
    try:
        t0 = time.perf_counter()
        worker = make_worker()
        stats["worker_s"] = time.perf_counter() - t0
    finally:
        worker_mod.load_params = load
    stats["ru_maxrss_GB"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    emit(f"{label}_load", path=path, **stats)
    return worker, stats


def _held_streams(dev: torch.device, worker, label: str) -> dict:
    """The standard 8 requests through `worker` on a new scheduler whose
    thread starts once all are in (one admission, so two workers with the
    same weights make the same calls); launches checked against the
    forwards run. Returns streams by request id and the launches."""
    from dynamo_tpu_torch.engine import InferenceScheduler
    from dynamo_tpu_torch.ops.gumbel import gumbel_noise

    runner = worker.runner
    _, prompts = standard_traffic(worker.model_config.vocab_size)
    worker.scheduler.stop()
    worker.scheduler = InferenceScheduler(runner)
    reset_counts()
    reset_runner_counts(runner)
    gumbel_noise.launches = 0
    try:
        results = asyncio.run(_serve_wave(worker, _bodies(prompts, "req"),
                                          hold=True))
        torch.cuda.synchronize()
    finally:
        worker.scheduler.stop()
    launches = read_counts()
    check(worker.scheduler.error is None,
          f"{label}: scheduler error {worker.scheduler.error!r}")
    want = expected_counts(runner, dev, decode=runner.decode_steps,
                           prefill=runner.prefill_steps,
                           warm=runner.graph_warm_forwards)
    check(runner.decode_steps > 0 and launches == want,
          f"{label}: kernel launches {launches} != expected {want}")
    check(dev.type != "cuda" or gumbel_noise.launches > 0,
          f"{label}: the noise pass never ran")
    return {"streams": {f"req-{i}": r["tokens"]
                        for i, r in enumerate(results)},
            "launches": launches, "noise_launches": gumbel_noise.launches}


def _compare_streams(label: str, got: dict, want: dict) -> dict:
    divergence = {rid: _first_divergence(got[rid], want[rid])
                  for rid in want}
    check(all(at == 64 for rid, at in divergence.items() if _greedy(rid)),
          f"{label}: greedy streams differ from the in-memory worker's at "
          f"{divergence}")
    return {"greedy_equal": True, "sampled_equal": all(
        at == 64 for rid, at in divergence.items() if not _greedy(rid))}


def _seeded_twice(worker, label: str) -> list:
    """One seeded temperature request, twice, each on a new scheduler:
    the same ids both times."""
    from dynamo_tpu_torch.engine import InferenceScheduler

    prompt = np.random.default_rng(SEED + 12).integers(
        1, worker.model_config.vocab_size, 300)
    runs = []
    for _ in range(2):
        worker.scheduler.stop()
        worker.scheduler = InferenceScheduler(worker.runner)
        worker.scheduler.start()
        try:
            runs.append(asyncio.run(_stream(
                worker, _body("seeded-7", prompt, 0.8, 0.9)))["tokens"])
        finally:
            worker.scheduler.stop()
    check(runs[0] == runs[1] and len(runs[0]) == 64,
          f"{label}: a seeded temperature request drew different ids twice")
    return runs[0]


def _checkpoint_http(dev: torch.device, worker, tok, template) -> dict:
    """The port's frontend in front of `worker` (served from the checkpoint
    directory, its card naming the hf tokenizer): chat requests rendered
    through the directory's template, one at a time, and a json_schema
    request. The prompt ids the worker receives must equal
    encode(render(messages)), and each text the decode of the ids the
    worker streamed."""
    import tempfile

    from dynamo_tpu_torch.engine import InferenceScheduler
    from dynamo_tpu_torch.frontend import Frontend
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    model = worker.card.name
    seen = []
    generate = worker.generate

    async def recording(body, ctx=None):
        rec = {"prompt": list(body["token_ids"]), "out": []}
        seen.append(rec)
        async with contextlib.aclosing(generate(body, ctx)) as stream:
            async for frame in stream:
                rec["out"] += frame.get("t") or []
                yield frame

    worker.generate = recording
    worker.scheduler.stop()
    worker.scheduler = InferenceScheduler(worker.runner)
    worker.scheduler.logits_tokenizer = tok
    worker.scheduler.start()

    async def serve() -> dict:
        root = tempfile.mkdtemp(prefix="chip_smoke_discovery_")
        cfg = RuntimeConfig(discovery_backend="file", discovery_path=root,
                            tcp_host="127.0.0.1", system_enabled=False)
        rt = await DistributedRuntime(cfg).start()
        frontend = Frontend(rt, host="127.0.0.1", port=0)
        out = {"chats": []}
        try:
            await worker.serve(rt)
            t0 = time.perf_counter()
            await frontend.start()
            listed = []
            while model not in listed:
                check(time.perf_counter() - t0 < 60,
                      f"checkpoint: /v1/models never listed {model}")
                res = await _http(frontend.port, "GET", "/v1/models")
                listed = [m["id"] for m in json.loads(res["text"])["data"]]
                await asyncio.sleep(0.05)
            out["listed_s"] = time.perf_counter() - t0
            for i, messages in enumerate(CKPT_CHATS):
                body = {"model": model, "messages": messages,
                        "max_tokens": 32, "temperature": 0.0,
                        "ignore_eos": True}
                if i % 2 == 0:
                    body.update(stream=True,
                                stream_options={"include_usage": True})
                res = await _http(frontend.port, "POST",
                                  "/v1/chat/completions", body)
                out["chats"].append(_sse_outcome(res) if i % 2 == 0
                                    else _aggregate_outcome(res))
            body = {"model": model, "max_tokens": 64, "temperature": 0.0,
                    "messages": [{"role": "user", "content": "json"}],
                    "response_format": {"type": "json_schema", "json_schema": {
                        "name": "answer", "schema": LOGITS_SCHEMA}}}
            out["json"] = _aggregate_outcome(await _http(
                frontend.port, "POST", "/v1/chat/completions", body))
        finally:
            await frontend.close()
            await worker.shutdown()
            await rt.shutdown()
            shutil.rmtree(root, ignore_errors=True)
        return out

    out = asyncio.run(serve())
    del worker.generate  # the class's method again
    check(len(seen) == len(CKPT_CHATS) + 1,
          f"checkpoint: the worker saw {len(seen)} requests")
    for i, (messages, got, rec) in enumerate(zip(CKPT_CHATS, out["chats"],
                                                 seen)):
        want_ids = tok.encode(template.render(messages=[dict(m) for m in
                                                        messages],
                                              add_generation_prompt=True))
        check(rec["prompt"] == want_ids,
              f"checkpoint: chat {i}'s prompt ids differ from "
              "encode(render(messages))")
        check(got["text"] == tok.decode(rec["out"])
              and got["usage"]["prompt_tokens"] == len(want_ids)
              and got["usage"]["completion_tokens"] == 32 == len(rec["out"]),
              f"checkpoint: chat {i}: text or usage differ from the "
              f"worker's stream: {got}")
    answer = json.loads(out["json"]["text"])
    check(set(answer) == {"ok", "color"} and isinstance(answer["ok"], bool)
          and answer["color"] in ("red", "green", "blue")
          and out["json"]["finish"] == "stop",
          f"checkpoint: the json_schema answer {out['json']}")
    return {"listed_s": out["listed_s"], "json": answer,
            "chat_prompt_tokens": [c["usage"]["prompt_tokens"]
                                   for c in out["chats"]]}


def phase_checkpoint(dev: torch.device, worker) -> dict:
    """An HF checkpoint directory, written by the port and served from disk
    (llama3-8b at full width):

    - write: the bf16 engine worker's weights as safetensors shards of at
      most 5 GB with model.safetensors.index.json and config.json
      (`hf_config_dict`), all 32 layers unless the disk is short (then the
      first N layers, N and the reason printed); beside them a generated
      Llama-3-form tokenizer.json of exactly 128,256 ids, a
      tokenizer_config.json with a Llama-3-form chat template and
      eos_token, and a generation_config.json;
    - tokenizer: its load seconds, us a token encoding a 1,500-token
      prompt (cold and cached), the template's render ms, and a json_schema
      guide's first mask over the 128,256 ids;
    - load bf16 (its shards first evicted from the page cache):
      `TorchWorker(model_path=dir)`; the config equals the
      preset but for the name, every leaf equals the in-memory one, and the
      standard traffic's greedy streams equal the in-memory worker's (one
      admission each); a seeded temperature request draws the same ids
      twice; load seconds, GB/s, host RSS and device memory peaks;
    - load int4 + int8 KV from the same directory: every q4 leaf equals
      `quantize_params_int4` of the in-memory weights, and the greedy
      streams equal a worker built from those with the same RunnerConfig;
    - over HTTP: the port's frontend in front of that worker, chat requests
      rendered through the directory's template and a json_schema request
      guided over the 128,256 ids.

    The directory is deleted in a `finally`. Returns the launches of rows
    1 (the bf16 load's run), 2 and 6 (the int4 load's)."""
    from dynamo_tpu_torch.engine import RunnerConfig, TorchWorker
    from dynamo_tpu_torch.llm import guided
    from dynamo_tpu_torch.llm.chat_template import ChatTemplate
    from dynamo_tpu_torch.llm.hf_tokenizer import HfTokenizer
    from dynamo_tpu_torch.models import get_config
    from dynamo_tpu_torch.models.checkpoint import save_params
    from dynamo_tpu_torch.models.quantize import quantize_params_int4

    t_phase = time.perf_counter()
    cfg = worker.model_config
    model = worker.runner.model
    root = ROOT / "build" / "checkpoint" / cfg.name
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out: dict = {}
    launches: dict = {}
    try:
        # -- write
        free = shutil.disk_usage(root).free
        nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)
        layer_bytes = nbytes(model.layers[0].parameters())
        other = nbytes([model.embed, model.final_norm]
                       + ([model.lm_head] if model.lm_head is not None
                          else []))
        need = other + cfg.n_layers * layer_bytes
        n_layers, reason = cfg.n_layers, None
        if free < need + 2**30:
            n_layers = int((free - 2**30 - other) // layer_bytes)
            check(n_layers >= 1, f"checkpoint: {free} bytes free cannot hold "
                  "one layer")
            reason = (f"{free} bytes free, {need} needed for all "
                      f"{cfg.n_layers} layers")
        ckpt_cfg = dataclasses.replace(cfg, n_layers=n_layers)
        emit("checkpoint_disk", path=str(root), free_bytes=free,
             need_bytes=need, layers_written=n_layers, reason=reason)
        source = _view_model(model, ckpt_cfg)
        t0 = time.perf_counter()
        save_params(source, ckpt_cfg, str(root),
                    max_shard_bytes=CKPT_SHARD_BYTES)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.sync()
        sync_s = time.perf_counter() - t0
        shards = sorted(root.glob("*.safetensors"))
        # evict the written shards from the page cache, so the bf16 load
        # reads the disk (the int4 load after it finds them cached)
        for f in shards:
            fd = os.open(f, os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
        written = sum(f.stat().st_size for f in shards)
        with open(root / "model.safetensors.index.json") as f:
            index = json.load(f)
        check(all(f.stat().st_size <= CKPT_SHARD_BYTES + 2**20
                  for f in shards) and len(set(index["weight_map"].values()))
              == len(shards), "checkpoint: shards and index disagree")
        t0 = time.perf_counter()
        (root / "tokenizer.json").write_text(json.dumps(
            llama3_tokenizer_json(cfg.vocab_size)))
        (root / "tokenizer_config.json").write_text(json.dumps(
            {"chat_template": CKPT_TEMPLATE, "eos_token": "<|eot_id|>",
             "bos_token": "<|begin_of_text|>"}))
        special = cfg.vocab_size - 256  # <|begin_of_text|>'s id
        (root / "generation_config.json").write_text(json.dumps(
            {"bos_token_id": special,
             "eos_token_id": [special + 1, special + 9]}))
        out["write"] = {"seconds": write_s, "sync_s": sync_s,
                        "bytes": written, "shards": len(shards),
                        "GB_per_s": written / 1e9 / write_s,
                        "tokenizer_files_s": time.perf_counter() - t0}

        # -- the tokenizer and the template, as a frontend loads them
        t0 = time.perf_counter()
        tok = HfTokenizer(str(root))
        tok_load_s = time.perf_counter() - t0
        check(tok.vocab_size == cfg.vocab_size
              and tok.eos_token_ids == [special + 9, special + 1],
              f"checkpoint: tokenizer vocab {tok.vocab_size}, eos "
              f"{tok.eos_token_ids}")
        rng = np.random.default_rng(SEED + 13)
        words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                    rng.integers(2, 10)))
                 for _ in range(1200)]
        text = " ".join(f"{w}{rng.choice(['', ',', '.', ' 42'])}"
                        for w in words)
        ids = tok.encode(text)
        while len(ids) > 1500:
            text = text[:int(len(text) * 1500 / len(ids))]
            ids = tok.encode(text)
        fresh = HfTokenizer(str(root))
        t0 = time.perf_counter()
        cold = fresh.encode(text)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = fresh.encode(text)
        warm_s = time.perf_counter() - t0
        check(cold == warm == ids and fresh.decode(ids) == text,
              "checkpoint: encode / decode do not round-trip")
        template = ChatTemplate(tok.chat_template)
        t0 = time.perf_counter()
        for messages in CKPT_CHATS:
            template.render(messages=messages, add_generation_prompt=True)
        render_ms = (time.perf_counter() - t0) * 1e3 / len(CKPT_CHATS)
        t0 = time.perf_counter()
        proc = guided.make_guided_processor(fresh, json_schema=LOGITS_SCHEMA)
        proc([], np.zeros(cfg.vocab_size, np.float32))
        mask_ms = (time.perf_counter() - t0) * 1e3
        out["tokenizer"] = {"load_s": tok_load_s, "prompt_tokens": len(ids),
                            "encode_us_per_token_cold": cold_s * 1e6
                            / len(ids),
                            "encode_us_per_token_cached": warm_s * 1e6
                            / len(ids),
                            "render_ms": render_ms,
                            "guided_first_mask_ms": mask_ms}
        emit("checkpoint_tokenizer", **out["tokenizer"])

        # -- the in-memory streams (the engine worker's, or for fewer
        #    layers a worker over the first N of them)
        if n_layers == cfg.n_layers:
            mem = worker
        else:
            mem = TorchWorker(ckpt_cfg, RunnerConfig(), params=source,
                              device=dev)
        want = _held_streams(dev, mem, "checkpoint in-memory")

        # -- load bf16
        loaded, load_stats = _timed_load(
            "checkpoint_bf16", str(root),
            lambda: TorchWorker(model_path=str(root), device=dev))
        got_cfg = loaded.model_config
        preset = get_config(cfg.name) if n_layers == cfg.n_layers else cfg
        check(dataclasses.replace(got_cfg, name=cfg.name,
                                  n_layers=preset.n_layers) == preset
              and got_cfg.n_layers == n_layers
              and loaded.card.name == root.name
              and loaded.card.tokenizer == {"kind": "hf", "path": str(root)},
              f"checkpoint: config {got_cfg} / card {loaded.card}")
        mine = dict(loaded.runner.model.named_parameters())
        ref_leaves = dict(source.named_parameters())
        check(mine.keys() == ref_leaves.keys() and all(
            mine[k].dtype == t.dtype and torch.equal(mine[k], t)
            for k, t in ref_leaves.items()),
            "checkpoint: a loaded bf16 leaf differs from the in-memory one")
        got = _held_streams(dev, loaded, "checkpoint bf16")
        out["bf16"] = {**load_stats, "leaves": len(mine),
                       **_compare_streams("checkpoint bf16", got["streams"],
                                          want["streams"]),
                       "launches": got["launches"],
                       "noise_launches": got["noise_launches"],
                       "seeded_ids_head": _seeded_twice(loaded,
                                                        "checkpoint bf16")[
                                                            :8]}
        launches["paged_decode_attention_pool"] = got["launches"][
            "paged_decode_attention_pool"]
        loaded.close()
        del loaded, mine
        if mem is not worker:
            mem.close()
        del mem
        free_memory()

        # -- load int4 + int8 KV
        qcfg = RunnerConfig(weight_dtype="int4", kv_dtype="int8")
        qref = TorchWorker(ckpt_cfg, qcfg, device=dev,
                           params=quantize_params_int4(
                               _view_model(model, ckpt_cfg)))
        qwant = _held_streams(dev, qref, "checkpoint int4 in-memory")
        loaded, load_stats = _timed_load(
            "checkpoint_q", str(root),
            lambda: TorchWorker(model_path=str(root), runner_config=qcfg,
                                device=dev))
        mine = loaded.runner.model.state_dict()
        ref_state = qref.runner.model.state_dict()
        check(mine.keys() == ref_state.keys() and all(
            torch.equal(mine[k], t) for k, t in ref_state.items()),
            "checkpoint: a loaded q4 leaf differs from quantize_params_int4 "
            "of the in-memory weights")
        qref.close()
        del qref, ref_state, mine
        free_memory()
        got = _held_streams(dev, loaded, "checkpoint int4")
        out["q"] = {**load_stats, **_compare_streams(
            "checkpoint int4", got["streams"], qwant["streams"]),
            "launches": got["launches"]}
        for name in ("paged_decode_attention_pool_int8", "q4_matmul_v2"):
            launches[name] = got["launches"][name]
            check(dev.type != "cuda" or launches[name] > 0,
                  f"checkpoint: {name} never launched")

        # -- over HTTP through the port's frontend
        out["http"] = _checkpoint_http(dev, loaded, tok, template)
        loaded.close()
        del loaded
        free_memory()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("checkpoint", model=cfg.name, layers_written=n_layers,
         **out, launches=launches, seconds=time.perf_counter() - t_phase)
    return launches


# Logits processors and structured outputs over HTTP: the host-sampling path

LOGITS_LENGTHS = (600, 700, 256, 1024, 300, 400, 900, 512)
LOGITS_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "color": {"enum": ["red", "green", "blue"]}}, "required": ["ok", "color"]}
LOGITS_CHOICES = ("alpha", "beta", "gamma")
LOGITS_TOOL = {"type": "function", "function": {
    "name": "get_weather",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}


def logits_traffic(vocab: int, model: str) -> list:
    """logits_q's 8 requests as (name, body without processors, the fields
    that add them). Prompts of 256-1,024 tokens from the standard traffic's
    seed; the two chat requests carry them as printable ASCII (one token a
    character under the byte tokenizer, plus the chat template's). All
    stream (SSE)."""
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, vocab, n) for n in LOGITS_LENGTHS]
    base = {"model": model, "stream": True,
            "stream_options": {"include_usage": True}, "temperature": 0.0,
            "max_tokens": 64}

    def completion(i, **kw):
        return {**base, "prompt": [int(t) for t in prompts[i]],
                "ignore_eos": True, **kw}

    def chat(i, **kw):
        text = "".join(chr(32 + int(t) % 95) for t in prompts[i])
        return {**base, "messages": [{"role": "user", "content": text}],
                **kw}

    eos = ByteTokenizer.EOS
    return [
        ("a-control", completion(0), {}),
        ("b-control", completion(1), {}),
        ("c-penalties", completion(2), {
            "repetition_penalty": 1.3, "frequency_penalty": 0.5,
            "presence_penalty": 0.5}),
        ("d-min-tokens", completion(3, ignore_eos=False), {
            "logit_bias": {str(eos): 100}, "min_tokens": 16}),
        ("e-min-p", completion(4, temperature=0.8, top_p=0.9, seed=7),
         {"min_p": 0.1}),
        ("f-json-schema", chat(5), {"response_format": {
            "type": "json_schema",
            "json_schema": {"name": "answer", "schema": LOGITS_SCHEMA}}}),
        ("g-choice", completion(6, ignore_eos=False), {
            "nvext": {"guided_decoding": {"choice": list(LOGITS_CHOICES)}}}),
        # the bias on '"' keeps the random model's free string short
        ("h-tool", chat(7, max_tokens=128), {
            "tools": [LOGITS_TOOL], "logit_bias": {"34": 8},
            "tool_choice": {"type": "function",
                            "function": {"name": "get_weather"}}}),
    ]


def _check_logits_outcome(label: str, name: str, out: dict) -> None:
    """What each logits_q request must give (see logits_traffic)."""
    usage, finish, text = out["usage"], out["finish"], out["text"]
    if name in ("a-control", "b-control", "c-penalties", "e-min-p"):
        check(finish == "length" and usage["completion_tokens"] == 64,
              f"{label}: {name} finish {finish}, usage {usage}")
    elif name == "d-min-tokens":
        # min_tokens bans EOS for 16 tokens, then the +100 bias picks it
        check(finish == "stop" and usage["completion_tokens"] == 17,
              f"{label}: {name} must stop after 16 non-EOS tokens: "
              f"{finish}, {usage}")
    elif name == "f-json-schema":
        check(finish == "stop", f"{label}: {name} finish {finish}")
        value = json.loads(text)
        check(set(value) == {"ok", "color"}
              and isinstance(value["ok"], bool)
              and value["color"] in ("red", "green", "blue"),
              f"{label}: {name} does not validate: {text!r}")
    elif name == "g-choice":
        check(finish == "stop" and text in LOGITS_CHOICES,
              f"{label}: {name} gave {text!r} ({finish})")
    elif name == "h-tool":
        calls = out["tool_calls"]
        check(finish == "tool_calls" and len(calls) == 1
              and calls[0]["function"]["name"] == "get_weather"
              and isinstance(json.loads(calls[0]["function"]["arguments"]),
                             dict),
              f"{label}: {name} finish {finish}, tool_calls {calls}, "
              f"text {text!r}")


def phase_logits_q(dev: torch.device, worker) -> dict:
    """Logits processors, penalties and structured outputs on a served,
    prewarmed runner (its scheduler stopped), over HTTP through the port's
    frontend as serve_q runs it, the card naming the hermes tool parser.
    The 8 requests of `logits_traffic`: two greedy controls, penalties,
    min_tokens with EOS biased up, seeded min_p, a chat json_schema
    response_format, a guided choice and a chat with tool_choice forcing.
    Turns, each on a new scheduler that starts once all 8 are in: the
    requests without processors (warm), with them, without them again, and
    with them on the same runner with CUDA graphs off. Checks: each
    request's outcome (logits_traffic), the processor turn's streams equal
    the eager turn's, the graphed turns ran no decode forward eagerly and
    captured nothing, and the kernels launched once per layer (projection)
    of each forward. Prints TTFT and ITL of each request, the controls' ITL
    with and without the processor slots beside them, the host milliseconds
    per logits step by processor and in host_sample, the bytes read back
    per logits step, and the logits keys' count, capture seconds and static
    outputs. Returns the graphed turns' launches."""
    import tempfile

    from dynamo_tpu_torch.engine import InferenceScheduler
    from dynamo_tpu_torch.frontend import Frontend
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    label = "logits_q"
    t_phase = time.perf_counter()
    runner = worker.runner
    model = worker.card.name
    worker.card.tool_parser = "hermes"  # published for this phase
    traffic = logits_traffic(worker.model_config.vocab_size, model)
    plain = [body for _, body, _ in traffic]
    processed = [{**body, **extra} for _, body, extra in traffic]

    def fresh_scheduler():
        worker.scheduler.stop()
        worker.scheduler = InferenceScheduler(runner)
        worker.scheduler.logits_tokenizer = load_tokenizer(
            worker.card.tokenizer)
        return worker.scheduler

    async def wait_submitted(sched, n: int) -> None:
        while sched._incoming.qsize() < n:
            await asyncio.sleep(0.0005)

    async def turn(port: int, bodies: list, graphs: bool = True) -> dict:
        sched = fresh_scheduler()
        runner.config.cuda_graphs = graphs
        reads, read_bytes = runner.logits_reads, runner.logits_bytes_read
        try:
            start = time.perf_counter()
            tasks = []
            for i, body in enumerate(bodies):
                tasks.append(asyncio.ensure_future(
                    _http(port, "POST", "/v1/chat/completions"
                          if "messages" in body else "/v1/completions",
                          body)))
                await asyncio.wait_for(wait_submitted(sched, i + 1), 60)
            sched.start()
            answers = await asyncio.wait_for(asyncio.gather(*tasks), 300)
            wall = time.perf_counter() - start
        finally:
            runner.config.cuda_graphs = True
        check(sched.error is None, f"{label}: scheduler error {sched.error!r}")
        for (name, _, _), a in zip(traffic, answers):
            check(a["status"] == 200, f"{label}: {name} HTTP {a['status']}")
        return {"wall": wall, "stats": sched.stats,
                "outcomes": [_sse_outcome(a) for a in answers],
                "logits_reads": runner.logits_reads - reads,
                "logits_bytes": runner.logits_bytes_read - read_bytes}

    async def serve() -> dict:
        root = tempfile.mkdtemp(prefix="chip_smoke_discovery_")
        cfg = RuntimeConfig(discovery_backend="file", discovery_path=root,
                            tcp_host="127.0.0.1", system_enabled=False)
        rt = await DistributedRuntime(cfg).start()
        frontend = Frontend(rt, host="127.0.0.1", port=0)
        out = {}
        try:
            await worker.serve(rt)
            await frontend.start()
            port = frontend.port
            t_list = time.perf_counter()
            while frontend.manager.get(model) is None:
                check(time.perf_counter() - t_list < 30,
                      f"{label}: the frontend never listed {model}")
                await asyncio.sleep(0.05)
            check(frontend.manager.get(model).preprocessor.card.tool_parser
                  == "hermes", f"{label}: the card's tool parser is not "
                  "hermes at the frontend")
            out["warm"] = await turn(port, plain)
            # counts to zero just before the main path
            reset_counts()
            reset_runner_counts(runner)
            out["processors"] = await turn(port, processed)
            out["plain"] = await turn(port, plain)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out["launches"] = read_counts()
            out["forwards"] = {"decode": runner.decode_steps,
                               "prefill": runner.prefill_steps,
                               "spec": runner.spec_steps}
            out["graphs"] = graph_report(runner)
            check_graphed(runner, label)
            check(runner.graph_captures == 0,
                  f"{label}: {runner.graph_captures} captures while serving")
            want = expected_counts(runner, dev, **out["forwards"],
                                   warm=runner.graph_warm_forwards)
            check(runner.decode_steps > 0 and out["launches"] == want,
                  f"{label}: kernel launches {out['launches']} != expected "
                  f"{want} for forwards {out['forwards']}")
            reset_runner_counts(runner)
            out["eager"] = await turn(port, processed, graphs=False)
            out["eager_forwards"] = dict(runner.eager_forwards)
        finally:
            await frontend.close()
            await worker.shutdown()
            await rt.shutdown()
            shutil.rmtree(root, ignore_errors=True)
        return out

    out = asyncio.run(serve())
    proc, eager, plain_turn = out["processors"], out["eager"], out["plain"]
    check(out["eager_forwards"]["decode"] > 0,
          f"{label}: the graphs-off turn ran no eager decode forward")
    names = [name for name, _, _ in traffic]
    for name, o in zip(names, proc["outcomes"]):
        _check_logits_outcome(label, name, o)
    for name, got, want in zip(names, eager["outcomes"], proc["outcomes"]):
        check((got["text"], got["tool_calls"] and [
            c["function"] for c in got["tool_calls"]], got["finish"],
            got["usage"]) == (want["text"], want["tool_calls"] and [
                c["function"] for c in want["tool_calls"]], want["finish"],
                want["usage"]),
              f"{label}: {name} differs with CUDA graphs off")
    stats = proc["stats"]
    steps = max(stats.logits_steps, 1)
    keys = [k for k in runner.step_graphs
            if k[0] in ("decode_logits", "decode_spec_logits")]

    def latency(o: dict) -> dict:
        st, n = o["stamps"], o["usage"]["completion_tokens"]
        return {"ttft_ms": (st[0] - o["t0"]) * 1e3,
                "itl_ms": ((st[-1] - st[0]) * 1e3 / (n - 1)
                           if len(st) > 1 and n > 1 else None)}

    emit(label, model=model, weight_dtype=runner.config.weight_dtype,
         kv_dtype=runner.config.kv_dtype, tool_parser="hermes",
         requests=names, prompt_lengths=list(LOGITS_LENGTHS),
         latency={name: latency(o)
                  for name, o in zip(names, proc["outcomes"])},
         controls_itl_ms_with_processors=[
             latency(o)["itl_ms"] for o in proc["outcomes"][:2]],
         controls_itl_ms_without=[
             latency(o)["itl_ms"] for o in plain_turn["outcomes"][:2]],
         outcomes={name: {"finish": o["finish"], "text": o["text"][:80],
                          "completion_tokens":
                          o["usage"]["completion_tokens"],
                          "tool_calls": [c["function"]
                                         for c in o["tool_calls"]]}
                   for name, o in zip(names, proc["outcomes"])},
         logits_steps=stats.logits_steps,
         decode_tokens=stats.decode_tokens,
         host_ms_per_logits_step={k: v / steps
                                  for k, v in sorted(stats.host_ms.items())},
         host_ms_total=dict(sorted(stats.host_ms.items())),
         bytes_read_per_logits_step=(proc["logits_bytes"]
                                     / max(proc["logits_reads"], 1)),
         logits_reads=proc["logits_reads"],
         turn_wall_s={"processors": proc["wall"], "plain": plain_turn["wall"],
                      "eager": eager["wall"]},
         streams_equal_graphs_off=True,
         eager_turn_forwards=out["eager_forwards"],
         logits_keys=len(keys),
         logits_keys_capture_s=sum(runner.step_graphs[k].capture_s
                                   for k in keys),
         logits_keys_output_MB=sum(
             t.numel() * t.element_size()
             for k in keys for t in runner.step_graphs[k].outputs) / 1e6,
         forwards=out["forwards"], kernel_launches=out["launches"],
         **out["graphs"], seconds=time.perf_counter() - t_phase)
    return out["launches"]


# KV-aware routing: two workers behind the port's kv-mode frontend

KV_PREFIX = 1024  # tokens of each shared prefix (64 pages of 16)
KV_OUT = 32  # output tokens of every request
KV_RUNS = 3  # serve_kv runs, each with its own second worker and frontends


def kv_traffic(vocab: int) -> dict:
    """4 prefixes of KV_PREFIX tokens; wave 1 one request per prefix with a
    64-token suffix; waves 2 and 3 the prefixes in the order 0, 0, 1, 1, 2,
    2, 3, 3, each with a fresh suffix of 32-128 tokens. Items are (prefix
    index, prompt)."""
    rng = np.random.default_rng(SEED + 9)
    prefixes = [rng.integers(1, vocab, KV_PREFIX) for _ in range(4)]

    def wave(order, lengths):
        return [(i, [int(t) for t in np.concatenate(
            [prefixes[i], rng.integers(1, vocab, n)])])
            for i, n in zip(order, lengths)]

    order = (0, 0, 1, 1, 2, 2, 3, 3)
    return {"w1": wave(range(4), [64] * 4),
            "w2": wave(order, rng.integers(32, 129, 8)),
            "w3": wave(order, rng.integers(32, 129, 8))}


def phase_serve_kv(dev: torch.device, worker_a, run: int = 0) -> dict:
    """KV-aware routing at full width: a second TorchWorker on `worker_a`'s
    weights (mistral-7b W4A16 + int8 KV, the default RunnerConfig, both
    prewarmed), each on its own port DistributedRuntime (file discovery in
    a temporary directory, the TCP request plane, the default zmq event
    plane), and port Frontends in kv and in round_robin mode over the two,
    in this process. `kv_traffic` goes as streamed /v1/completions with
    token-id prompts, greedy: wave 1 together (each worker's scheduler
    starts once the 4 requests are in, so a worker admits its requests
    whole), wave 2 one request at a time (each sent once the previous one
    finished and the router has its events and the workers' load), wave 3
    together (reported only). Then the same waves in round_robin on fresh
    schedulers after clear_kv_blocks, and a direct replay of waves 1 and 2:
    fresh schedulers, each request submitted to the worker the router
    chose, in the same order, wave 1 admitted whole.

    Checks: wave 1 splits 2 / 2; every wave-2 request goes to the worker
    that served its prefix in wave 1 with overlap >= 64 blocks, and that
    worker's prefix-cached tokens rise by >= 1024; the router's tree equals
    each worker's local index; clear_kv_blocks empties a worker's part of
    the tree; both workers' LoadMetrics reach the manager; a busy threshold
    below the workers' usage answers 503; every HTTP text of waves 1 and 2
    equals the direct replay's decode; no graph captured and no graphable
    forward ran eagerly (every prefill chunk a replay); rows 2 and 6
    launched once per layer (projection) of each forward of the kv run;
    wave 2 computes exactly its suffixes' prefill tokens in kv mode and 4
    prefixes more in round_robin (its 4 misses). `run` numbers the phase
    line when the phase runs more than once. Returns the kv run's
    launches."""
    import tempfile

    from dynamo_tpu_torch.engine import InferenceScheduler, TorchWorker
    from dynamo_tpu_torch.frontend import Frontend
    from dynamo_tpu_torch.kv_router import WorkerWithDpRank
    from dynamo_tpu_torch.kv_router.protocols import (
        LoadMetrics,
        RouterEvent,
    )
    from dynamo_tpu_torch.llm.manager import ModelWatcher
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
    from dynamo_tpu_torch.runtime import events as ev_mod
    from dynamo_tpu_torch.runtime import zmtp
    from dynamo_tpu_torch.engine.worker import KvEventBuffer
    from dynamo_tpu_torch.tokens import compute_block_hashes

    label = "serve_kv"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    worker_b = TorchWorker(worker_a.model_config, worker_a.runner_config,
                           device=worker_a.device,
                           params=worker_a.runner.model)
    worker_b.runner.prewarm()
    prewarm_b_s = time.perf_counter() - t0
    workers = [worker_a, worker_b]
    runners = [w.runner for w in workers]
    model = worker_a.card.name
    page = worker_a.runner_config.page_size
    traffic = kv_traffic(worker_a.model_config.vocab_size)
    tok = ByteTokenizer()
    prefix_hashes = {}
    for i, p in traffic["w1"]:
        prefix_hashes[i] = compute_block_hashes(p[:KV_PREFIX], page)

    recorded = {}  # (worker_id, event_id) -> (perf_counter, kind) at
    # registration on the scheduler thread
    applied = {}  # (worker_id, event_id) -> perf_counter at the router
    arrivals = []  # (worker index, prompt tuple), in arrival order

    def stamped(buf, fn, kind: str):
        def hook(*args):
            fn(*args)
            recorded[(buf.worker_id, buf._event_id - 1)] = (
                time.perf_counter(), kind)
        return hook

    def fresh(k: int):
        """A new scheduler (an empty page pool) on worker k, its pool's
        hooks stamped; the old pool's blocks are announced cleared."""
        w = workers[k]
        w.scheduler.stop()
        w.scheduler = InferenceScheduler(
            w.runner,
            on_stored=stamped(w.events, w.events.on_stored, "stored"),
            on_removed=stamped(w.events, w.events.on_removed, "removed"))
        w.events.on_cleared()
        return w.scheduler

    def recording(k: int, generate):
        async def gen(body, ctx=None):
            arrivals.append((k, tuple(body["token_ids"])))
            async with contextlib.aclosing(generate(body, ctx)) as stream:
                async for item in stream:
                    yield item
        return gen

    for k, w in enumerate(workers):
        w.generate = recording(k, w.generate)

    def idle(w) -> bool:
        s = w.scheduler
        return not (s._incoming.qsize() or s._waiting
                    or any(x is not None for x in s._slots))

    def body(prompt) -> dict:
        return {"model": model, "prompt": list(prompt),
                "max_tokens": KV_OUT, "temperature": 0.0,
                "ignore_eos": True, "stream": True,
                "stream_options": {"include_usage": True}}

    async def until(pred, what: str, timeout: float = 60.0) -> float:
        t = time.perf_counter()
        while not pred():
            check(time.perf_counter() - t < timeout, f"{label}: {what}")
            await asyncio.sleep(0.002)
        return time.perf_counter() - t

    async def run_waves(port: int, entry, mode: str) -> dict:
        """Waves 1-3 through the frontend at `port` on fresh schedulers."""
        out = {}
        for k in range(2):
            fresh(k)
        for name in ("w1", "w2", "w3"):
            items = traffic[name]
            before_prefill = [w.scheduler.stats.prefill_tokens
                              for w in workers]
            before_batched = [w.scheduler.stats.prefill_batched_steps
                              for w in workers]
            first_arrival = len(arrivals)
            t_wave = time.perf_counter()
            if name == "w2":
                answers = []
                for _, prompt in items:
                    if entry is not None:
                        await until(lambda: settled(entry), "settle")
                    else:
                        await until(lambda: all(idle(w) for w in workers),
                                    "idle")
                    pre = [w.scheduler.stats.prefill_tokens
                           for w in workers]
                    answers.append(await _http(port, "POST",
                                               "/v1/completions",
                                               body(prompt)))
                    await until(lambda: all(idle(w) for w in workers),
                                "idle after a wave-2 request")
                    k = arrivals[-1][0]
                    out.setdefault("w2_cached", []).append(
                        len(prompt) - (workers[k].scheduler.stats
                                       .prefill_tokens - pre[k]))
            else:
                tasks = [asyncio.ensure_future(_http(
                    port, "POST", "/v1/completions", body(p)))
                    for _, p in items]
                if name == "w1":  # every scheduler starts once all are in
                    await until(lambda: sum(w.scheduler._incoming.qsize()
                                            for w in workers) == len(items),
                                "wave 1 submitted")
                    for w in workers:
                        w.scheduler.start()
                answers = await asyncio.gather(*tasks)
            wall = time.perf_counter() - t_wave
            await until(lambda: all(idle(w) for w in workers), "idle")
            outs = [_sse_outcome(a) for a in answers]
            for o in outs:
                check(o["finish"] == "length"
                      and o["usage"]["completion_tokens"] == KV_OUT,
                      f"{label}: {mode} {name}: {o['finish']} {o['usage']}")
            where = {p: k for k, p in arrivals[first_arrival:]}
            routed = [where[tuple(p)] for _, p in items]
            prefill = sum(w.scheduler.stats.prefill_tokens - b
                          for w, b in zip(workers, before_prefill))
            isl = sum(len(p) for _, p in items)
            ttft = [(o["stamps"][0] - o["t0"]) * 1e3 for o in outs]
            itl = [(o["stamps"][-1] - o["stamps"][0]) * 1e3 / (KV_OUT - 1)
                   for o in outs]
            out[name] = {"routed": routed,
                         "order": [(k, p) for k, p in
                                   arrivals[first_arrival:]],
                         "texts": [o["text"] for o in outs],
                         "prefill_tokens": prefill,
                         "prefix_cached_tokens": isl - prefill,
                         "ttft_ms": ttft,
                         "ttft_ms_mean": float(np.mean(ttft)),
                         "ttft_ms_max": float(np.max(ttft)),
                         "itl_ms_mean": float(np.mean(itl)),
                         "prefill_batched_steps": sum(
                             w.scheduler.stats.prefill_batched_steps - b
                             for w, b in zip(workers, before_batched)),
                         "wall_s": wall}
            if name == "w2":
                # a hit: the request's worker served its 1,024-token prefix
                # from its cache
                hit = [c >= KV_PREFIX for c in out["w2_cached"]]
                out[name]["ttft_ms_hits"] = [
                    t for t, h in zip(ttft, hit) if h]
                out[name]["ttft_ms_misses"] = [
                    t for t, h in zip(ttft, hit) if not h]
        return out

    def router_view(entry, w) -> list:
        return sorted(entry.scheduler.indexer.dump_worker(
            WorkerWithDpRank(w.instance_id)), key=str)

    def local_view(w) -> list:
        return sorted(((p, h) for p, h in
                       w.events.local_index.dump()["blocks"]), key=str)

    def settled(entry) -> bool:
        """Both workers idle, the router holding every event they
        registered, their latest published load equal to their pools'."""
        for w in workers:
            pool = w.scheduler.pool
            pub = entry.scheduler.sequences._published.get(
                WorkerWithDpRank(w.instance_id))
            if (not idle(w) or pub is None
                    or pub.active_blocks != pool.num_pages - 1
                    - pool.free_count()
                    or router_view(entry, w) != local_view(w)):
                return False
        return True

    async def call(rt, w, endpoint: str) -> list:
        client = (rt.namespace(w.card.namespace).component(w.card.component)
                  .endpoint(endpoint).client())
        await client.start()
        try:
            await client.wait_for_instances(2, timeout=30)
            return [d async for d in client.direct({}, w.instance_id)]
        finally:
            await client.close()

    async def serve() -> dict:
        root = tempfile.mkdtemp(prefix="chip_smoke_kv_")
        cfg = RuntimeConfig(discovery_backend="file", discovery_path=root,
                            tcp_host="127.0.0.1", system_enabled=False)
        check(cfg.event_plane == "zmq", f"{label}: {cfg.event_plane}")
        rts = [await DistributedRuntime(dataclasses.replace(cfg)).start()
               for _ in range(3)]
        fes = {"kv": Frontend(rts[2], host="127.0.0.1", port=0,
                              router_mode="kv"),
               "rr": Frontend(rts[2], host="127.0.0.1", port=0,
                              router_mode="round_robin")}
        out = {}
        try:
            t_up = time.perf_counter()
            for k, w in enumerate(workers):
                fresh(k)
                await w.serve(rts[k])
            for fe in fes.values():
                await fe.start()
            ids = {w.instance_id for w in workers}
            for fe in fes.values():
                await until(lambda fe=fe: fe.manager.get(model) is not None
                            and ids <= set(fe.manager.get(model)
                                           .worker_usage),
                            "both workers' LoadMetrics at the manager")
            out["setup_s"] = time.perf_counter() - t_up
            entry = fes["kv"].manager.get(model)
            decisions = []
            select = entry.scheduler.select_worker

            def selecting(candidates, block_hashes, isl, **kw):
                res = select(candidates, block_hashes, isl, **kw)
                decisions.append({
                    "first_hash": block_hashes[0], "isl": isl,
                    "worker": res.worker.worker_id,
                    "overlap_blocks": res.overlap_blocks,
                    "logit": res.logit})
                return res

            entry.scheduler.select_worker = selecting
            apply = entry.scheduler.indexer.apply_event

            def applying(event):
                applied[(event.worker_id, event.event_id)] = (
                    time.perf_counter())
                return apply(event)

            entry.scheduler.indexer.apply_event = applying
            clock = _LayerClock([
                (ev_mod.ZmqEventPublisher, "publish", "event_plane"),
                (ev_mod.ZmqEventSubscriberManager, "_on_message",
                 "event_plane"),
                (zmtp, "encode_message", "event_plane"),
                (ModelWatcher, "_apply", "event_plane"),
                (KvEventBuffer, "drain", "event_plane"),
                (RouterEvent, "to_wire", "event_plane"),
                (LoadMetrics, "to_wire", "event_plane"),
            ])
            # counts to zero just before the main path
            reset_counts()
            for r in runners:
                reset_runner_counts(r)
            recorded.clear()
            t_kv = time.perf_counter()
            with clock:
                out["kv"] = await run_waves(fes["kv"].port, entry, "kv")
                out["settle_s"] = await until(lambda: settled(entry),
                                              "settle after wave 3")
            out["kv_wall_s"] = time.perf_counter() - t_kv
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out["launches"] = read_counts()
            out["runner_counts"] = [launched_forwards(r) | {
                "prefill": r.prefill_steps, "decode_steps": r.decode_steps,
                "warm": dict(r.graph_warm_forwards),
                "captures": r.graph_captures} for r in runners]
            out["want"] = {}
            for r in runners:
                for name, n in expected_counts(
                        r, dev, decode=r.decode_steps,
                        prefill=r.prefill_steps,
                        warm=r.graph_warm_forwards).items():
                    out["want"][name] = out["want"].get(name, 0) + n
            out["event_seconds"] = clock.seconds["event_plane"]
            out["decisions"] = decisions
            lags = [(applied[key] - t) * 1e3
                    for key, (t, _) in recorded.items() if key in applied]
            out["event_lag_ms"] = lags
            out["events_recorded"] = len(recorded)
            out["events_by_kind"] = {
                kind: sum(1 for _, k in recorded.values() if k == kind)
                for kind in ("stored", "removed")}
            out["views_equal"] = [router_view(entry, w) == local_view(w)
                                  for w in workers]
            out["view_blocks"] = [len(local_view(w)) for w in workers]
            out["usage"] = {f"{iid:x}": u
                            for iid, u in entry.worker_usage.items()}
            kinds = {"stored": 0, "removed": 0, "cleared": 0}
            events_seen = []

            def counting(event):
                events_seen.append(event)
                return applying(event)

            entry.scheduler.indexer.apply_event = counting
            # clear_kv_blocks on both workers: the router's tree empties
            for k, w in enumerate(workers):
                (answer,) = await call(rts[2], w, "clear_kv_blocks")
                out.setdefault("cleared_blocks", []).append(
                    answer["cleared_blocks"])
                await until(lambda w=w: router_view(entry, w) == [],
                            f"the router still holds worker {k}'s blocks "
                            "after clear_kv_blocks")
            for e in events_seen:
                kinds["stored" if e.stored else "removed" if e.removed
                      else "cleared"] += 1
            out["clear_events"] = kinds
            # the same waves in round_robin
            out["rr"] = await run_waves(fes["rr"].port, None, "rr")
            # busy shedding: a threshold below both workers' usage
            rr_entry = fes["rr"].manager.get(model)
            await until(lambda: all(rr_entry.worker_usage.get(
                w.instance_id, 0) > 0 for w in workers), "usage published")
            usage = min(rr_entry.worker_usage[w.instance_id]
                        for w in workers)
            fes["rr"].http.busy_threshold = usage / 2
            res = await _http(fes["rr"].port, "POST", "/v1/completions",
                              {**body(traffic["w1"][0][1]), "stream": False})
            fes["rr"].http.busy_threshold = None
            out["busy"] = {"threshold": usage / 2, "status": res["status"],
                           "body": res["text"]}
            # the direct replay of waves 1 and 2, to the kv run's workers
            for w in workers:
                await call(rts[2], w, "clear_kv_blocks")
            replay = {}
            for k in range(2):
                fresh(k)
            for name in ("w1", "w2"):
                order = out["kv"][name]["order"]
                streams = {}
                if name == "w1":
                    tasks = {p: asyncio.ensure_future(_stream(
                        workers[k], _kv_body(f"kv-{n}", p)))
                        for n, (k, p) in enumerate(order)}
                    await asyncio.sleep(0)
                    for w in workers:
                        w.scheduler.start()
                    for p, t in tasks.items():
                        streams[p] = (await t)["tokens"]
                else:
                    for n, (k, p) in enumerate(order):
                        await until(lambda: all(idle(w) for w in workers),
                                    "idle")
                        streams[p] = (await _stream(
                            workers[k], _kv_body(f"kv2-{n}", p)))["tokens"]
                replay[name] = streams
            out["replay"] = replay
            await until(lambda: all(idle(w) for w in workers), "idle")
        finally:
            for fe in fes.values():
                await fe.close()
            for w in workers:
                await w.shutdown()
                del w.generate
            for rt in rts:
                await rt.shutdown()
            shutil.rmtree(root, ignore_errors=True)
        return out

    out = asyncio.run(serve())
    kv, rr = out["kv"], out["rr"]
    ids = [w.instance_id for w in workers]
    check(sorted(kv["w1"]["routed"]) == [0, 0, 1, 1],
          f"{label}: wave 1 routed {kv['w1']['routed']}, not 2 / 2")
    holder = {i: kv["w1"]["routed"][n]
              for n, (i, _) in enumerate(traffic["w1"])}
    by_hash = {prefix_hashes[i][0]: i for i in holder}
    w2_decisions = out["decisions"][4:12]  # wave 1 made the first four
    for n, ((i, prompt), d) in enumerate(zip(traffic["w2"], w2_decisions)):
        check(by_hash[d["first_hash"]] == i and d["isl"] == len(prompt),
              f"{label}: wave-2 decision {n} is not its request's")
        check(d["worker"] == ids[holder[i]]
              and kv["w2"]["routed"][n] == holder[i],
              f"{label}: wave-2 request {n} (prefix {i}) went to worker "
              f"{kv['w2']['routed'][n]}, its prefix is on {holder[i]}")
        check(d["overlap_blocks"] >= KV_PREFIX // page,
              f"{label}: wave-2 request {n} overlap {d['overlap_blocks']}")
        check(kv["w2_cached"][n] >= KV_PREFIX,
              f"{label}: wave-2 request {n} reused {kv['w2_cached'][n]} "
              "cached tokens")
    suffixes = sum(len(p) - KV_PREFIX for _, p in traffic["w2"])
    check(kv["w2"]["prefill_tokens"] == suffixes
          and rr["w2"]["prefill_tokens"] == suffixes + 4 * KV_PREFIX,
          f"{label}: wave-2 prefill tokens kv {kv['w2']['prefill_tokens']}, "
          f"round_robin {rr['w2']['prefill_tokens']}; want {suffixes} and "
          f"{suffixes + 4 * KV_PREFIX}")
    check(all(out["views_equal"]) and min(out["view_blocks"]) > 0,
          f"{label}: the router's trees differ from the local indexes "
          f"({out['views_equal']}, {out['view_blocks']})")
    check(out["clear_events"]["cleared"] == 2,
          f"{label}: cleared events {out['clear_events']}")
    check(out["busy"]["status"] == 503
          and "service busy" in out["busy"]["body"],
          f"{label}: busy threshold answered {out['busy']}")
    for name in ("w1", "w2"):
        for n, (_, prompt) in enumerate(traffic[name]):
            want = tok.decode(out["replay"][name][tuple(prompt)])
            check(kv[name]["texts"][n] == want,
                  f"{label}: {name} request {n}: the HTTP text differs from "
                  "the direct replay's")
    for r, rc in zip(runners, out["runner_counts"]):
        check(rc["captures"] == 0, f"{label}: {rc['captures']} captures")
        check_graphed(r, label)
    check(out["launches"] == out["want"] and (dev.type != "cuda" or (
        out["launches"]["q4_matmul_v2"] > 0
        and out["launches"]["paged_decode_attention_pool_int8"] > 0)),
          f"{label}: kernel launches {out['launches']} != expected "
          f"{out['want']}")
    lags = out["event_lag_ms"]
    check(len(lags) == out["events_recorded"] > 0,
          f"{label}: {out['events_recorded']} events registered, "
          f"{len(lags)} applied by the router")

    def wave_line(w) -> dict:
        return {k: v for k, v in w.items() if k not in ("texts", "order")}

    emit(label, run=run, model=model,
         nvidia_smi=nvidia_smi() if dev.type == "cuda"
         else None, weight_dtype=worker_a.runner_config.weight_dtype,
         kv_dtype=worker_a.runner_config.kv_dtype, workers=2,
         event_plane="zmq", prewarm_b_s=prewarm_b_s,
         setup_s=out["setup_s"],
         kv={k: wave_line(v) for k, v in kv.items() if k != "w2_cached"},
         kv_w2_cached_tokens=kv["w2_cached"],
         rr={k: wave_line(v) for k, v in rr.items() if k != "w2_cached"},
         decisions=[{k: v for k, v in d.items() if k != "first_hash"}
                    for d in out["decisions"]],
         events_recorded=out["events_recorded"],
         events_by_kind=out["events_by_kind"],
         event_lag_ms_mean=float(np.mean(lags)),
         event_lag_ms_p50=float(np.median(lags)),
         event_lag_ms_max=float(np.max(lags)),
         clear_events=out["clear_events"],
         cleared_blocks=out["cleared_blocks"],
         router_equals_local_index=out["views_equal"],
         indexed_blocks=out["view_blocks"], usage=out["usage"],
         busy=out["busy"]["status"], texts_equal_replay=True,
         event_plane_s=out["event_seconds"],
         event_plane_share=out["event_seconds"] / out["kv_wall_s"],
         kv_wall_s=out["kv_wall_s"], kernel_launches=out["launches"],
         forwards=out["runner_counts"],
         seconds=time.perf_counter() - t_phase)
    worker_b.close()
    return out["launches"]


RES_PROMPTS = (256, 512, 768, 1024)  # the migrating streams' prompt lengths
RES_OUT = 256  # their max_tokens
RES_CUT = 32  # tokens every stream has before worker B dies
RES_IDLE_S = "3"  # DYNT_STREAM_IDLE_TIMEOUT_SECS while B is wedged
RES_BACKLOG = 48  # requests that saturate both workers' 16 slots
RES_TENANT_LIMIT = "50"  # DYNT_TENANT_RATE_LIMIT, tokens/s
# Each worker's HealthCheckManager: probe after 1 s idle, sweep every 0.5 s,
# 2 s per canary, deregister after 2 failures. A canary waits behind the
# worker's batch, and a long stream leaves its endpoint's idle clock alone
# while it runs, so the timeout must cover a scheduler iteration under load.
RES_HEALTH = {"canary_wait_time": 1.0, "check_interval": 0.5,
              "canary_timeout": 2.0, "max_failures": 2}


def phase_resilience(dev: torch.device, worker_a) -> dict:
    """Resilience and admission at full width: a second TorchWorker (B) on
    `worker_a`'s weights (mistral-7b W4A16 + int8 KV, the default
    RunnerConfig, both prewarmed), each on its own port DistributedRuntime
    (file discovery in a temporary directory, the TCP request plane, the
    zmq event plane; B's status server on), a HealthCheckManager on each
    (RES_HEALTH) and a port Frontend in round_robin in front, in this
    process. Greedy /v1/completions with token-id prompts, streamed.

    1. hard failure: 4 streams of 256-1,024 prompt tokens and 256 tokens
       each (2 per worker); once each has sent >= 32 tokens B dies (its
       request-plane server drops every connection without a final frame,
       its lease is revoked, its scheduler stops). Every stream must end
       with finish_reason length, 256 tokens and the original prompt length
       in usage; each migrated stream's text is the tokens B sent before
       the cut followed by A's replay (prior_output_tokens = those tokens),
       and the replay equals a direct request to A (fresh scheduler, empty
       cache) of the prompt plus those tokens, or parts from it only at a
       near-tie (check_continuations says why).
    2. wedged worker: B restarts (a new runtime, a fresh scheduler); the
       same 4 streams with DYNT_STREAM_IDLE_TIMEOUT_SECS=3, and once B's
       two have >= 32 tokens B's scheduler freezes while its connections
       stay open: they migrate after the idle timeout with the same checks,
       B's canaries fail, its HealthCheckManager deregisters it and its
       /health answers 503; B thaws and its canaries re-register it.
    3. deadlines: a 1,024-token request with x-dynt-deadline-ms 1,000 ends
       with the in-band 504 deadline error, its sequence is cancelled and
       its worker's reclaimable pages return to their count within one
       scheduler iteration; a request with a spent budget (0 ms) gets 503
       with Retry-After and reaches no worker.
    4. admission (DYNT_ADMISSION_ENABLE=1): 48 requests saturate both
       workers; a request whose deadline is below the estimated queue wait
       gets 503 with Retry-After = the estimator's clamped value and
       reaches no worker; a request with a generous deadline is admitted
       (its estimate against its actual wait is printed); with
       DYNT_TENANT_RATE_LIMIT=50 a tenant over its share is refused while
       another tenant is served.

    Throughout: no graph is captured and no graphable forward runs eagerly,
    and rows 2 and 6 are launched once per layer (projection) of every
    forward of both runners, the canaries' and the direct checks' included.
    Returns the phase's launches and worker B (its scheduler stopped; the
    drain phase serves it again)."""
    import tempfile
    import threading

    from dynamo_tpu_torch.engine import TorchWorker
    from dynamo_tpu_torch.frontend import Frontend
    from dynamo_tpu_torch.llm.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime import (
        DistributedRuntime,
        HealthCheckManager,
        RuntimeConfig,
    )
    from dynamo_tpu_torch.runtime import admission as adm
    from dynamo_tpu_torch.runtime import metrics as rt_metrics

    label = "resilience"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    worker_b = TorchWorker(worker_a.model_config, worker_a.runner_config,
                           device=worker_a.device,
                           params=worker_a.runner.model)
    worker_b.runner.prewarm()
    prewarm_b_s = time.perf_counter() - t0
    workers = [worker_a, worker_b]
    runners = [w.runner for w in workers]
    model = worker_a.card.name
    vocab = worker_a.model_config.vocab_size
    rng = np.random.default_rng(SEED + 13)
    tok = ByteTokenizer()
    originals = [w.generate for w in workers]
    # request_id -> {"worker": k, "prompt", "prior", "tokens"} of every
    # non-canary request each worker served, in arrival order
    served: list = []
    canaries = [0, 0]
    # the near-tie checks' eager forwards on A (context lengths): outside
    # the runner's counters, they launch row 6 once per projection
    eager_forwards: list = []

    def recording(k: int):
        async def gen(body, ctx=None):
            if (body.get("annotations") or {}).get("canary"):
                canaries[k] += 1
                async with contextlib.aclosing(
                        originals[k](body, ctx)) as stream:
                    async for item in stream:
                        yield item
                return
            rec = {"worker": k, "rid": body["request_id"],
                   "prompt": list(body["token_ids"]),
                   "prior": list(body.get("prior_output_tokens") or []),
                   "tokens": [], "t_first": None}
            served.append(rec)
            async with contextlib.aclosing(originals[k](body, ctx)) as stream:
                async for item in stream:
                    if item.get("t") and rec["t_first"] is None:
                        rec["t_first"] = time.perf_counter()
                    rec["tokens"] += item.get("t") or []
                    yield item
        return gen

    for k, w in enumerate(workers):
        w.generate = recording(k)

    def fresh(k: int) -> None:
        _fresh_scheduler(workers[k])

    def prompt(n: int) -> list:
        return rng.integers(1, vocab, n).tolist()

    def body(p, max_tokens: int, stream: bool = True) -> dict:
        return {"model": model, "prompt": list(p), "max_tokens": max_tokens,
                "temperature": 0.0, "ignore_eos": True, "stream": stream,
                "stream_options": {"include_usage": True}}

    async def until(pred, what: str, timeout: float = 60.0) -> float:
        t = time.perf_counter()
        while not pred():
            check(time.perf_counter() - t < timeout, f"{label}: {what}")
            await asyncio.sleep(0.002)
        return time.perf_counter() - t

    def sent(rid: str) -> int:
        return sum(len(r["tokens"]) for r in served if r["rid"] == rid)

    def prefill_tokens() -> list:
        return [w.scheduler.stats.prefill_tokens for w in workers]

    def all_reclaimable(k: int) -> bool:
        """No live sequence on worker k: every page but the reserved one
        is free or an unpinned prefix-cache page."""
        pool = workers[k].scheduler.pool
        return (_reclaimable_pages(pool) == pool.num_pages - 1
                and workers[k].scheduler.queue_depth() == (0, 0))

    async def direct(prompt_ids, max_tokens: int) -> list:
        """The greedy continuation on worker A alone: a fresh scheduler,
        the cache empty."""
        fresh(0)
        req = PreprocessedRequest(
            request_id=f"direct-{len(prompt_ids)}", token_ids=list(prompt_ids),
            sampling=SamplingOptions(max_tokens=max_tokens, temperature=0.0),
            stop=StopConditions(ignore_eos=True)).to_wire()
        out = []
        async for frame in originals[0](req):
            out += frame.get("t") or []
        return out

    async def migrate_round(port: int, entry, trigger, what: str) -> dict:
        """4 streams, 2 per worker; `trigger` kills or freezes B once each
        stream on it has >= RES_CUT tokens. Returns the outcomes and the
        migrated streams' records."""
        first = len(served)
        prompts = [prompt(n) for n in RES_PROMPTS]
        tasks = [asyncio.ensure_future(_http(port, "POST", "/v1/completions",
                                             body(p, RES_OUT)))
                 for p in prompts]
        await until(lambda: len(served) - first >= 4, f"{what}: 4 arrivals")
        mine = served[first:first + 4]
        on_b = [r["rid"] for r in mine if r["worker"] == 1]
        check(sorted(r["worker"] for r in mine) == [0, 0, 1, 1],
              f"{what}: the streams went to {[r['worker'] for r in mine]}")
        await until(lambda: all(sent(r["rid"]) >= RES_CUT for r in mine),
                    f"{what}: {RES_CUT} tokens on every stream")
        t_cut = time.perf_counter()
        await trigger()
        answers = await asyncio.gather(*tasks)
        t_done = time.perf_counter()
        outs = []
        for p, res in zip(prompts, answers):
            o = _sse_outcome(res)
            o["rid"] = res["headers"].get("x-request-id")
            o["prompt"] = p
            outs.append(o)
        migrated = []
        for o in outs:
            check(o["finish"] == "length"
                  and o["usage"]["completion_tokens"] == RES_OUT
                  and o["usage"]["prompt_tokens"] == len(o["prompt"]),
                  f"{what}: {o['finish']} {o['usage']} (prompt "
                  f"{len(o['prompt'])})")
            legs = [r for r in served[first:] if r["rid"] == o["rid"]]
            if o["rid"] not in on_b:
                check(len(legs) == 1 and tok.decode(legs[0]["tokens"])
                      == o["text"], f"{what}: a stream on A was disturbed")
                continue
            check(len(legs) >= 2 and legs[0]["worker"] == 1
                  and legs[-1]["worker"] == 0,
                  f"{what}: stream {o['rid']} legs "
                  f"{[(r['worker'], len(r['prior'])) for r in legs]}")
            replay = legs[-1]
            cut = replay["prior"]
            # no token repeated or lost at the cut: what the client got
            # before it is a prefix of what B sent, and the text is those
            # tokens then the replay's
            check(len(cut) >= RES_CUT and legs[0]["tokens"][:len(cut)] == cut
                  and replay["prompt"] == o["prompt"] + cut
                  and len(cut) + len(replay["tokens"]) == RES_OUT
                  and tok.decode(cut + replay["tokens"]) == o["text"],
                  f"{what}: stream {o['rid']}: {len(cut)} tokens before the "
                  f"cut, {len(replay['tokens'])} after")
            migrated.append({"rid": o["rid"], "prompt": o["prompt"],
                             "cut": cut, "replay": replay["tokens"],
                             # the cut to A sending the replay's first token
                             "stall_ms": (replay["t_first"] - t_cut) * 1e3,
                             "replay_prompt": len(replay["prompt"])})
        check(len(migrated) == 2, f"{what}: {len(migrated)} migrated")
        own_a = sum(len(r["prompt"]) for r in served[first:]
                    if r["worker"] == 0 and not r["prior"])
        return {"migrated": migrated, "t_cut": t_cut, "own_a": own_a,
                "wall_s": t_done - t_cut}

    async def check_continuations(round_: dict, what: str) -> None:
        """Each replay against a direct continuation on A. The decode
        kernel's split plan follows the batch's table width, so a replay
        beside other streams and the same request alone round differently:
        the two greedy streams may part only at a near-tie, a top-2 gap
        within NEAR_TIE_NATS of an eager forward's logits there."""
        for m in round_["migrated"]:
            context = m["prompt"] + m["cut"]
            want = await direct(context, RES_OUT - len(m["cut"]))
            d = _first_divergence(want, m["replay"])
            m["diverged_at"], m["gap_nats"] = None, None
            if d < len(want):
                gap = _near_tie_gap(worker_a, context + want[:d], want[d],
                                    m["replay"][d])
                eager_forwards.append(len(context) + d)
                m["diverged_at"], m["gap_nats"] = d, gap
                check(gap <= NEAR_TIE_NATS,
                      f"{what}: stream {m['rid']}'s replay parts from the "
                      f"direct continuation at token {d} of "
                      f"{len(want)}, {gap:.3f} nats below the top (not a "
                      f"near-tie, <= {NEAR_TIE_NATS})")

    async def serve() -> dict:
        root = tempfile.mkdtemp(prefix="chip_smoke_res_")
        cfg = RuntimeConfig(discovery_backend="file", discovery_path=root,
                            tcp_host="127.0.0.1", system_enabled=False)
        rt_a = await DistributedRuntime(dataclasses.replace(cfg)).start()
        rt_fe = await DistributedRuntime(dataclasses.replace(cfg)).start()
        rts = {"a": rt_a, "fe": rt_fe}
        dead = []  # B's runtimes after a kill, shut down at the end
        health = {}
        fe = Frontend(rt_fe, host="127.0.0.1", port=0,
                      router_mode="round_robin")
        freeze, thaw = threading.Event(), threading.Event()
        out = {}

        def health_manager(rt) -> HealthCheckManager:
            hm = HealthCheckManager(rt, **RES_HEALTH)
            hm.start()
            return hm

        async def off_health(run_checks) -> None:
            """Run the direct checks with the canaries off: they replace
            A's scheduler under its live endpoint, which would drop a
            canary in flight."""
            names = list(health)
            for name in names:
                await health.pop(name).close()
            await run_checks
            for name in names:
                health[name] = health_manager(rts[name])

        async def start_b() -> None:
            rt_b = await DistributedRuntime(dataclasses.replace(
                cfg, system_enabled=True)).start()
            rts["b"] = rt_b
            worker_b._served, worker_b._tasks = [], []
            fresh(1)
            await worker_b.serve(rt_b)
            health["b"] = health_manager(rt_b)

        async def kill_b() -> None:
            """B dies: its server drops every connection without a final
            frame, its lease is revoked, its scheduler stops."""
            rt_b = rts.pop("b")
            dead.append(rt_b)
            await health.pop("b").close()
            for task in (rt_b._keepalive_task, *worker_b._tasks):
                task.cancel()
            await asyncio.gather(rt_b._keepalive_task, *worker_b._tasks,
                                 return_exceptions=True)
            await rt_b.request_server.close()
            await rt_b.discovery.revoke_lease(rt_b.lease)
            worker_b.scheduler.stop()

        try:
            fresh(0)
            await worker_a.serve(rt_a)
            health["a"] = health_manager(rt_a)
            await start_b()
            await fe.start()
            ids = {w.instance_id for w in workers}
            await until(lambda: fe.manager.get(model) is not None
                        and ids <= set(fe.manager.get(model).worker_usage)
                        and ids <= set(fe.manager.get(model).router.client
                                       .instance_ids()),
                        "both workers listed with their LoadMetrics")
            entry = fe.manager.get(model)
            subject = entry.router.client.endpoint.subject
            b_hex = f"{worker_b.instance_id:x}"
            # counts to zero just before the main path
            reset_counts()
            for r in runners:
                reset_runner_counts(r)
            retries0 = rt_metrics.RETRIES_TOTAL.labels(
                endpoint=subject, outcome="allowed").get()
            opens0 = rt_metrics.BREAKER_TRANSITIONS.labels(
                endpoint=subject, state="open").get()
            canaries0 = list(canaries)

            # 1. a hard failure
            pre, canaries_pre = prefill_tokens(), list(canaries)
            hard = await migrate_round(fe.port, entry, kill_b, "hard")
            # every prompt is random: nothing of it is in A's cache, and a
            # canary prefills its one token
            hard["prefill_tokens_a_replays"] = (
                prefill_tokens()[0] - pre[0] - hard["own_a"]
                - (canaries[0] - canaries_pre[0]))
            hard["retries_allowed"] = rt_metrics.RETRIES_TOTAL.labels(
                endpoint=subject, outcome="allowed").get() - retries0
            hard["breaker_opened_b"] = rt_metrics.BREAKER_TRANSITIONS.labels(
                endpoint=subject, state="open").get() - opens0
            hard["breaker_b"] = (entry.router.breakers._breakers[
                worker_b.instance_id].state
                if worker_b.instance_id in entry.router.breakers._breakers
                else "dropped (deregistered)")
            check(hard["breaker_opened_b"] >= 1,
                  "hard: B's breaker never opened")
            await off_health(check_continuations(hard, "hard"))
            out["hard"] = hard

            # 2. a wedged worker
            await start_b()
            await until(lambda: worker_b.instance_id in
                        entry.router.client.instance_ids(), "B back")
            orig_step = worker_b.scheduler._step

            def step():
                if freeze.is_set():
                    thaw.wait()
                return orig_step()

            worker_b.scheduler._step = step
            marks = {}

            async def wedge() -> None:
                freeze.set()
                marks["freeze"] = time.perf_counter()

            with knobs(DYNT_STREAM_IDLE_TIMEOUT_SECS=RES_IDLE_S):
                wedged = await migrate_round(fe.port, entry, wedge,
                                             "wedged")
            await until(lambda: worker_b.instance_id not in
                        entry.router.client.instance_ids(),
                        "the canaries did not deregister B")
            wedged["freeze_to_deregistered_s"] = (time.perf_counter()
                                                  - marks["freeze"])
            res = await _http(rts["b"].status_server.port, "GET", "/health")
            wedged["health_status"] = res["status"]
            check(res["status"] == 503 and "unhealthy" in res["text"],
                  f"wedged: B's /health answered {res['status']} "
                  f"{res['text']}")
            thaw.set()
            t_thaw = time.perf_counter()
            await until(lambda: worker_b.instance_id in
                        entry.router.client.instance_ids(),
                        "B's canaries did not re-register it")
            wedged["thaw_to_reregistered_s"] = time.perf_counter() - t_thaw
            res = await _http(rts["b"].status_server.port, "GET", "/health")
            check(res["status"] == 200, f"wedged: B's /health after the "
                  f"thaw answered {res['status']}")
            worker_b.scheduler._step = orig_step
            out["wedged"] = wedged
            # the canaries have shown both ways; they stop here, so the
            # prefill and page counts below are the requests' own
            for hm in health.values():
                await hm.close()
            await check_continuations(wedged, "wedged")
            fresh(0)
            await until(lambda: all(all_reclaimable(k) for k in range(2)),
                        "idle before the deadlines")

            # 3. deadlines
            first = len(served)
            budget_ms = 1000
            res = await _http(fe.port, "POST", "/v1/completions",
                              body(prompt(512), 1024),
                              headers={"x-dynt-deadline-ms": str(budget_ms)})
            t_end = res["t_end"]
            check(len(served) == first + 1, "deadline: no arrival")
            k = served[first]["worker"]
            steps0 = workers[k].scheduler.stats.steps
            events = [json.loads(e) for _, e in res["events"]
                      if e != "[DONE]"]
            errors = [e["error"] for e in events if "error" in e]
            check(len(errors) == 1 and errors[0]["code"] == 504
                  and errors[0]["type"] == "deadline_exceeded",
                  f"deadline: the stream ended with {errors}")
            await until(lambda: all_reclaimable(k),
                        "deadline: the pages did not come back", 10.0)
            deadline = {
                "worker": k, "tokens_before_expiry": len(
                    served[first]["tokens"]),
                "expiry_to_stream_end_ms": (t_end - (res["t0"] + budget_ms
                                                     / 1e3)) * 1e3,
                "iterations_to_pages_back": (workers[k].scheduler.stats.steps
                                             - steps0)}
            check(deadline["iterations_to_pages_back"] <= 1,
                  f"deadline: pages back after "
                  f"{deadline['iterations_to_pages_back']} iterations")
            pre = prefill_tokens()
            res = await _http(fe.port, "POST", "/v1/completions",
                              body(prompt(512), 64),
                              headers={"x-dynt-deadline-ms": "0"})
            check(res["status"] == 503 and "retry-after" in res["headers"]
                  and "deadline already spent" in res["text"]
                  and len(served) == first + 1 and prefill_tokens() == pre,
                  f"deadline: a spent budget answered {res['status']} "
                  f"{res['text']}")
            deadline["spent_status"] = res["status"]
            deadline["spent_retry_after"] = res["headers"]["retry-after"]
            out["deadline"] = deadline

            # 4. admission under a saturating backlog
            with knobs(DYNT_ADMISSION_ENABLE="1",
                       DYNT_TENANT_RATE_LIMIT=RES_TENANT_LIMIT):
                adm.reset_tenant_ledger()
                out["admission"] = await admission(fe.port, entry)
            adm.reset_tenant_ledger()
            await until(lambda: all(w.scheduler.queue_depth() == (0, 0)
                                    for w in workers), "idle at the end")
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out["launches"] = read_counts()
            out["canaries"] = [c - c0 for c, c0 in zip(canaries, canaries0)]
            out["runner_counts"] = [launched_forwards(r) | {
                "prefill": r.prefill_steps, "decode_steps": r.decode_steps,
                "warm": dict(r.graph_warm_forwards),
                "captures": r.graph_captures} for r in runners]
            out["want"] = {}
            for r in runners:
                for name, n in expected_counts(
                        r, dev, decode=r.decode_steps,
                        prefill=r.prefill_steps,
                        warm=r.graph_warm_forwards).items():
                    out["want"][name] = out["want"].get(name, 0) + n
            for name, n in expected_counts(
                    runners[0], dev, prefill=len(eager_forwards)).items():
                out["want"][name] += n
            out["eager_check_forwards"] = list(eager_forwards)
        finally:
            thaw.set()
            await fe.close()
            for hm in health.values():
                await hm.close()
            for w in workers:
                await w.shutdown()
                del w.generate
            for rt in [*rts.values(), *dead]:
                await rt.shutdown()
            shutil.rmtree(root, ignore_errors=True)
        return out

    async def admission(port: int, entry) -> dict:
        """The backlog, the doomed and the generous request, the tenants."""
        est = entry.wait_estimator
        first = len(served)
        backlog = [asyncio.ensure_future(_http(
            port, "POST", "/v1/completions", body(prompt(64), RES_OUT)))
            for _ in range(RES_BACKLOG)]
        # the estimate once the workers published their queues and the
        # frontend saw the first wave's first tokens (its drain rate)
        slots = sum(w.runner_config.max_batch for w in workers)
        await until(lambda: est.depth() >= RES_BACKLOG - slots - 2
                    and sum(r["t_first"] is not None
                            for r in served[first:]) >= slots
                    and est.estimate_wait_ms() > 100.0,
                    f"admission: depth {est.depth()}, estimate "
                    f"{est.estimate_wait_ms()} ms")
        await asyncio.sleep(0.05)  # the last first tokens reach the frontend
        arrivals, pre = len(served), prefill_tokens()
        wait_ms = est.estimate_wait_ms()
        doomed_ms = max(20, int(wait_ms / 4))
        res = await _http(port, "POST", "/v1/completions",
                          body(prompt(64), 64),
                          headers={"x-dynt-deadline-ms": str(doomed_ms)})
        check(res["status"] == 503 and "estimated queue wait" in res["text"],
              f"admission: a {doomed_ms} ms budget behind {wait_ms:.0f} ms "
              f"answered {res['status']} {res.get('text')}")
        # the estimate the refusal used, as check_admission published it
        refused_est = rt_metrics.ADMISSION_WAIT_MS.labels(
            pool=est.pool).get()
        want_after = str(max(1, math.ceil(adm.clamp_retry_after_s(
            refused_est))))
        check(res["headers"]["retry-after"] == want_after
              and len(served) == arrivals and prefill_tokens() == pre,
              f"admission: Retry-After {res['headers'].get('retry-after')} "
              f"(want {want_after}); arrivals {len(served) - arrivals}")
        out = {"depth": est.depth(), "estimate_ms": wait_ms,
               "doomed_budget_ms": doomed_ms,
               "refused_estimate_ms": refused_est,
               "retry_after": res["headers"]["retry-after"]}
        # a generous deadline (ten times the estimate, at least 600 s) is
        # admitted
        pool = est.pool
        generous_ms = max(600_000, int(est.estimate_wait_ms() * 10))
        admitted = asyncio.ensure_future(_http(
            port, "POST", "/v1/completions", body(prompt(64), 16),
            headers={"x-dynt-deadline-ms": str(generous_ms)}))
        await until(lambda: len(served) > arrivals or admitted.done(),
                    "admission: the generous request hung")
        if len(served) == arrivals:
            check(False, f"admission: a {generous_ms} ms budget was "
                  f"refused: {admitted.result().get('text')}")
        out["admitted_estimate_ms"] = rt_metrics.ADMISSION_WAIT_MS.labels(
            pool=pool).get()
        # the tenants, with generous deadlines: only the quota may refuse
        ledger = adm.get_tenant_ledger()
        flood = []
        for i in range(8):
            before = len(served)
            t = asyncio.ensure_future(_http(
                port, "POST", "/v1/completions", body(prompt(64), 64),
                headers={"x-dynt-tenant-id": "flood",
                         "x-dynt-deadline-ms": str(generous_ms)}))
            await until(lambda: t.done() or len(served) > before,
                        "admission: a flood request hung")
            if t.done():
                res = t.result()
                check(res["status"] == 503 and "fair share" in res["text"]
                      and "retry-after" in res["headers"]
                      and len(served) == before,
                      f"admission: flood request {i} answered "
                      f"{res['status']} {res.get('text')}")
                out["flood_refused_at"] = i
                out["flood_rate_tps"] = ledger.rate("flood")
                out["flood_retry_after"] = res["headers"]["retry-after"]
                break
            flood.append(t)
        check("flood_refused_at" in out,
              "admission: the flooding tenant was never refused")
        calm = await _http(port, "POST", "/v1/completions",
                           body(prompt(64), 64),
                           headers={"x-dynt-tenant-id": "calm",
                                    "x-dynt-deadline-ms": str(generous_ms)})
        o = _sse_outcome(calm)
        check(calm["status"] == 200 and o["finish"] == "length",
              f"admission: the calm tenant got {calm['status']}")
        for t in [admitted, *flood, *backlog]:
            o = _sse_outcome(await t)
            check(o["finish"] == "length", f"admission: {o['finish']}")
        o = _sse_outcome(admitted.result())
        out["admitted_wait_ms"] = (o["stamps"][0] - o["t0"]) * 1e3
        return out

    out = asyncio.run(serve())
    for r, rc in zip(runners, out["runner_counts"]):
        check(rc["captures"] == 0, f"{label}: {rc['captures']} captures")
        check_graphed(r, label)
    check(out["launches"] == out["want"] and (dev.type != "cuda" or (
        out["launches"]["q4_matmul_v2"] > 0
        and out["launches"]["paged_decode_attention_pool_int8"] > 0)),
          f"{label}: kernel launches {out['launches']} != expected "
          f"{out['want']}")
    check(sum(out["canaries"]) > 0, f"{label}: no canary was served")
    stalls = {name: [m["stall_ms"] for m in out[name]["migrated"]]
              for name in ("hard", "wedged")}
    emit(label, model=model,
         nvidia_smi=nvidia_smi() if dev.type == "cuda" else None,
         weight_dtype=worker_a.runner_config.weight_dtype,
         kv_dtype=worker_a.runner_config.kv_dtype, workers=2,
         prewarm_b_s=prewarm_b_s,
         hard={"stall_ms": stalls["hard"],
               "stall_ms_mean": float(np.mean(stalls["hard"])),
               "stall_ms_max": float(np.max(stalls["hard"])),
               "tokens_before_cut": [len(m["cut"]) for m in
                                     out["hard"]["migrated"]],
               "replay_prompt_tokens": [m["replay_prompt"] for m in
                                        out["hard"]["migrated"]],
               "prefill_tokens_a_replays": out["hard"][
                   "prefill_tokens_a_replays"],
               "retries_allowed": out["hard"]["retries_allowed"],
               "breaker_opened_b": out["hard"]["breaker_opened_b"],
               "breaker_b": out["hard"]["breaker_b"],
               "wall_s": out["hard"]["wall_s"]},
         wedged={"idle_timeout_s": float(RES_IDLE_S),
                 "stall_ms": stalls["wedged"],
                 "stall_ms_mean": float(np.mean(stalls["wedged"])),
                 "stall_ms_max": float(np.max(stalls["wedged"])),
                 "freeze_to_deregistered_s": out["wedged"][
                     "freeze_to_deregistered_s"],
                 "thaw_to_reregistered_s": out["wedged"][
                     "thaw_to_reregistered_s"],
                 "health_status": out["wedged"]["health_status"]},
         continuations={name: [(m["diverged_at"], m["gap_nats"])
                               for m in out[name]["migrated"]]
                        for name in ("hard", "wedged")},
         deadline=out["deadline"],
         admission=out["admission"], canaries=out["canaries"],
         kernel_launches=out["launches"], forwards=out["runner_counts"],
         eager_check_forwards=out["eager_check_forwards"],
         seconds=time.perf_counter() - t_phase)
    return out["launches"], worker_b


DRAIN_PROMPTS = (256, 512, 768, 1024)  # the handed-off streams' prompts
DRAIN_OUT = 256  # every stream's max_tokens
DRAIN_CUT = 64  # tokens every stream has before POST /drain
DRAIN_PENALTY_PROMPT = 640  # the repetition-penalty (replay) request's


def phase_drain(dev: torch.device, worker_a, worker_b) -> dict:
    """The drain ladder at full width on the resilience phase's two
    mistral-7b W4A16 + int8 KV workers, each on its own port runtime (B's
    status server on), a port Frontend in round_robin in front. Only B is
    listed when the traffic arrives: 4 streams of 256-1,024 prompt tokens
    and 256 out (greedy and seeded in turn) and one greedy request with a
    repetition penalty; then A serves, and once every stream has >= 64
    tokens, POST /drain on B.

    Checks: B's report lists 4 handoffs and 1 replay (the processor
    sequence) and no error; A computes 0 prompt tokens for the 4 handoffs
    (each leg pulls B's packed int8 pages: value bytes, then the scale rows
    over 128 lanes) and exactly the replay's prompt plus its generated
    tokens for the replay; every stream ends with 256 tokens and its
    original prompt length; B is empty when the drain returns and
    deregisters once shut down; B's dynamo_drain_state reads 0, 1, 2 in
    that order. Each handoff's stall (B's last token to A's first, at the
    workers) and bytes pulled are printed; each stream is compared with the
    same request served undrained on A (greedy ones may part only at a
    near-tie). Rows 2 and 6 launch once per layer (projection) of every
    forward of both runners. Returns the phase's launches."""
    import tempfile

    from dynamo_tpu_torch.engine import InferenceScheduler
    from dynamo_tpu_torch.frontend import Frontend
    from dynamo_tpu_torch.llm.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
    from dynamo_tpu_torch.runtime import metrics as rt_metrics

    label = "drain"
    t_phase = time.perf_counter()
    workers = [worker_a, worker_b]
    runners = [w.runner for w in workers]
    model = worker_a.card.name
    vocab = worker_a.model_config.vocab_size
    rng = np.random.default_rng(SEED + 17)
    prompts = [rng.integers(1, vocab, n).tolist()
               for n in DRAIN_PROMPTS + (DRAIN_PENALTY_PROMPT,)]
    # (temperature, seed, repetition_penalty) per request: greedy and
    # seeded in turn, then the processor request
    sampling = [(0.0, 0, 1.0), (0.8, 1, 1.0), (0.0, 2, 1.0), (0.8, 3, 1.0),
                (0.0, 4, 1.3)]
    originals = [w.generate for w in workers]
    legs: list = []  # every request each worker served, in arrival order

    def recording(k: int):
        async def gen(body, ctx=None):
            dp = body.get("disaggregated_params") or {}
            rec = {"worker": k, "rid": body["request_id"],
                   "prompt": list(body["token_ids"]),
                   "prior": list(body.get("prior_output_tokens") or []),
                   "handoff": dp.get("handoff") is not None, "tokens": [],
                   "t_first": None, "t_last": None}
            legs.append(rec)
            async with contextlib.aclosing(originals[k](body, ctx)) as stream:
                async for item in stream:
                    if item.get("t"):
                        now = time.perf_counter()
                        rec["t_first"] = rec["t_first"] or now
                        rec["t_last"] = now
                        rec["tokens"] += item["t"]
                    yield item
        return gen

    for k, w in enumerate(workers):
        w.generate = recording(k)

    def http_body(i: int) -> dict:
        temperature, seed, penalty = sampling[i]
        body = {"model": model, "prompt": prompts[i],
                "max_tokens": DRAIN_OUT, "temperature": temperature,
                "seed": seed, "ignore_eos": True, "stream": True,
                "stream_options": {"include_usage": True}}
        if penalty != 1.0:
            body["repetition_penalty"] = penalty
        return body

    async def until(pred, what: str, timeout: float = 60.0) -> None:
        t = time.perf_counter()
        while not pred():
            check(time.perf_counter() - t < timeout, f"{label}: {what}")
            await asyncio.sleep(0.002)

    def sent(rid: str) -> int:
        return sum(len(r["tokens"]) for r in legs if r["rid"] == rid)

    async def serve() -> dict:
        root = tempfile.mkdtemp(prefix="chip_smoke_drain_")
        cfg = RuntimeConfig(discovery_backend="file", discovery_path=root,
                            tcp_host="127.0.0.1", system_enabled=False)
        rt_a = await DistributedRuntime(dataclasses.replace(cfg)).start()
        rt_b = await DistributedRuntime(dataclasses.replace(
            cfg, system_enabled=True)).start()
        rt_fe = await DistributedRuntime(dataclasses.replace(cfg)).start()
        fe = Frontend(rt_fe, host="127.0.0.1", port=0)
        out = {}
        b_label = f"{worker_b.instance_id:x}"
        states: list = []
        try:
            for w in workers:
                _fresh_scheduler(w)
                w._served, w._tasks = [], []
            await worker_b.serve(rt_b)
            await fe.start()
            await until(lambda: fe.manager.get(model) is not None
                        and worker_b.instance_id in fe.manager.get(
                            model).router.client.instance_ids(),
                        "B listed")
            entry = fe.manager.get(model)
            # counts to zero just before the main path
            reset_counts()
            for r in runners:
                reset_runner_counts(r)
            tasks = [asyncio.ensure_future(_http(
                fe.port, "POST", "/v1/completions", http_body(i)))
                for i in range(len(prompts))]
            await until(lambda: len(legs) >= len(prompts), "5 arrivals")
            check(all(r["worker"] == 1 for r in legs),
                  "the traffic reached A before it served")
            rids = [r["rid"] for r in legs]
            await worker_a.serve(rt_a)
            await until(lambda: worker_a.instance_id in
                        entry.router.client.instance_ids(), "A listed")
            await until(lambda: all(sent(rid) >= DRAIN_CUT for rid in rids),
                        f"{DRAIN_CUT} tokens on every stream")
            check(all(sent(rid) < DRAIN_OUT for rid in rids),
                  "a stream finished before the drain")
            prefill_a0 = worker_a.scheduler.stats.prefill_tokens
            pulls0 = len(worker_a.pulls)
            gauge = rt_metrics.DRAIN_STATE.labels(worker=b_label)
            states.append(gauge.get())
            sampling_on = True

            async def sample_state():
                while sampling_on:
                    if gauge.get() != states[-1]:
                        states.append(gauge.get())
                    await asyncio.sleep(0.001)

            sampler = asyncio.ensure_future(sample_state())
            t_drain = time.perf_counter()
            res = await _http(rt_b.status_server.port, "POST", "/drain")
            out["drain_http_s"] = time.perf_counter() - t_drain
            check(res["status"] == 200,
                  f"POST /drain answered {res['status']} {res.get('text')}")
            out["report"] = json.loads(res["text"])
            out["b_empty"] = (worker_b.scheduler.queue_depth() == (0, 0)
                              and len(worker_b.transfers) == 0)
            answers = await asyncio.wait_for(asyncio.gather(*tasks), 300)
            sampling_on = False
            await sampler
            if gauge.get() != states[-1]:
                states.append(gauge.get())
            out["states"] = states
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out["launches"] = read_counts()
            out["prefill_a"] = (worker_a.scheduler.stats.prefill_tokens
                                - prefill_a0)
            out["resumed_a"] = worker_a.scheduler.stats.drain_resumed
            out["pulls"] = list(worker_a.pulls)[pulls0:]
            out["outcomes"] = []
            for res in answers:
                o = _sse_outcome(res)
                o["rid"] = res["headers"]["x-request-id"]
                out["outcomes"].append(o)
            out["want"] = {}
            for r in runners:
                for name, n in expected_counts(
                        r, dev, decode=r.decode_steps,
                        prefill=r.prefill_steps,
                        warm=r.graph_warm_forwards).items():
                    out["want"][name] = out["want"].get(name, 0) + n
            out["forwards"] = [launched_forwards(r) | {
                "prefill": r.prefill_steps} for r in runners]
            # B deregisters once shut down
            await worker_b.shutdown()
            t_dereg = time.perf_counter()
            await until(lambda: worker_b.instance_id not in
                        entry.router.client.instance_ids(),
                        "B never deregistered")
            out["deregister_s"] = time.perf_counter() - t_dereg
        finally:
            await fe.close()
            for w in workers:
                await w.shutdown()
                del w.generate
            for rt in (rt_fe, rt_a, rt_b):
                await rt.shutdown()
            shutil.rmtree(root, ignore_errors=True)
        return out

    out = asyncio.run(serve())
    report = out["report"]
    check(len(report["handoff"]) == 4 and len(report["replay"]) == 1
          and report["errored"] == 0 and report["completed"] is True
          and out["b_empty"],
          f"{label}: drain report {report} (B empty: {out['b_empty']})")
    check(out["states"] == [0.0, 1.0, 2.0],
          f"{label}: dynamo_drain_state went {out['states']}")
    by_rid = {}
    for o, p in zip(out["outcomes"], prompts):
        check(o["finish"] == "length"
              and o["usage"]["completion_tokens"] == DRAIN_OUT
              and o["usage"]["prompt_tokens"] == len(p),
              f"{label}: {o['finish']} {o['usage']} (prompt {len(p)})")
        by_rid[o["rid"]] = o
    handoffs, replays = [], []
    for i, p in enumerate(prompts):
        rid = out["outcomes"][i]["rid"]
        mine = [r for r in legs if r["rid"] == rid]
        check(len(mine) == 2 and mine[0]["worker"] == 1
              and mine[1]["worker"] == 0,
              f"{label}: {rid} legs {[(r['worker'], r['handoff']) for r in mine]}")
        src, dst = mine
        stream = src["tokens"] + dst["tokens"]
        check(len(stream) == DRAIN_OUT, f"{label}: {rid} {len(stream)} tokens")
        row = {"rid": rid, "i": i, "prompt": len(p), "tokens": stream,
               "tokens_on_b": len(src["tokens"]),
               "stall_ms": (dst["t_first"] - src["t_last"]) * 1e3}
        if dst["handoff"]:
            check(dst["prompt"] == p and not dst["prior"],
                  f"{label}: {rid}'s handoff leg carried another prompt")
            handoffs.append(row)
        else:
            check(dst["prior"] == src["tokens"]
                  and dst["prompt"] == p + src["tokens"],
                  f"{label}: {rid}'s replay leg is not prompt + generated")
            row["replay_prompt"] = len(dst["prompt"])
            replays.append(row)
    check(len(handoffs) == 4 and len(replays) == 1
          and replays[0]["i"] == len(prompts) - 1,
          f"{label}: {len(handoffs)} handoffs, {len(replays)} replays")
    check(out["resumed_a"] == 4, f"{label}: A resumed {out['resumed_a']}")
    check(out["prefill_a"] == replays[0]["replay_prompt"],
          f"{label}: A prefilled {out['prefill_a']} tokens; the replay "
          f"needs {replays[0]['replay_prompt']} and the handoffs 0")
    pulls = {p_["request_id"]: p_ for p_ in out["pulls"]}
    for row in handoffs:
        pull = pulls[row["rid"]]
        row.update(pull_bytes=pull["bytes"], pull_pages=pull["pages"],
                   bytes_per_page=pull["bytes"] / pull["pages"],
                   pull_ms=pull["pull_ms"], pull_wait_ms=pull["wait_ms"],
                   pull_assemble_ms=pull["assemble_ms"],
                   onboard_ms=pull["stage_ms"],
                   pull_GB_per_s=pull["bytes"] / pull["pull_ms"] / 1e6)
        computed = row["prompt"] + row["tokens_on_b"] - 1
        ps = worker_a.runner.config.page_size
        check(pull["pages"] == -(-computed // ps),
              f"{label}: {row['rid']} pulled {pull['pages']} pages for "
              f"{computed} computed tokens")
    check(out["launches"] == out["want"] and (dev.type != "cuda" or (
        out["launches"]["q4_matmul_v2"] > 0
        and out["launches"]["paged_decode_attention_pool_int8"] > 0)),
          f"{label}: kernel launches {out['launches']} != expected "
          f"{out['want']}")
    for r in runners:
        check_graphed(r, label)
    # every stream against the same request served undrained on A, all
    # five in one wave on an empty cache
    bodies = [PreprocessedRequest(
        request_id=f"undrained-{i}", token_ids=list(p),
        sampling=SamplingOptions(max_tokens=DRAIN_OUT, temperature=t,
                                 seed=seed, repetition_penalty=penalty),
        stop=StopConditions(ignore_eos=True)).to_wire()
        for i, (p, (t, seed, penalty)) in enumerate(zip(prompts, sampling))]
    worker_a.scheduler.stop()
    worker_a.scheduler = InferenceScheduler(worker_a.runner)
    undrained = asyncio.run(_serve_wave(worker_a, bodies, hold=True))
    worker_a.scheduler.stop()
    continuations = {}
    for row in handoffs + replays:
        i = row["i"]
        want, got = undrained[i]["tokens"], row["tokens"]
        d = _first_divergence(want, got)
        gap = None
        if d < len(want) and sampling[i][0] == 0.0 and sampling[i][2] == 1.0:
            gap = _near_tie_gap(worker_a, prompts[i] + want[:d], want[d],
                                got[d])
            check(gap <= NEAR_TIE_NATS,
                  f"{label}: {row['rid']} parts from the undrained stream at "
                  f"token {d}, {gap:.3f} nats below the top (not a "
                  f"near-tie, <= {NEAR_TIE_NATS})")
        continuations[f"req-{i}"] = {
            "rung": "replay" if "replay_prompt" in row else "handoff",
            "temperature": sampling[i][0], "diverged_at": (
                d if d < len(want) else None), "gap_nats": gap}
    stalls = [r["stall_ms"] for r in handoffs]
    emit(label, model=model,
         nvidia_smi=nvidia_smi() if dev.type == "cuda" else None,
         weight_dtype=worker_a.runner_config.weight_dtype,
         kv_dtype=worker_a.runner_config.kv_dtype,
         report={k: (len(v) if isinstance(v, list) else v)
                 for k, v in report.items()},
         drain_http_s=out["drain_http_s"],
         drain_state=out["states"], deregister_s=out["deregister_s"],
         handoff_stall_ms=stalls,
         handoff_stall_ms_mean=float(np.mean(stalls)),
         handoff_stall_ms_max=float(np.max(stalls)),
         replay_stall_ms=replays[0]["stall_ms"],
         replay_prompt_tokens=replays[0]["replay_prompt"],
         prefill_tokens_a=out["prefill_a"],
         handoffs=[{k: v for k, v in r.items() if k != "tokens"}
                   for r in handoffs],
         continuations=continuations, forwards=out["forwards"],
         kernel_launches=out["launches"],
         seconds=time.perf_counter() - t_phase)
    return out["launches"]


def _kv_body(rid: str, prompt) -> dict:
    from dynamo_tpu_torch.llm.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    return PreprocessedRequest(
        request_id=rid, token_ids=list(prompt),
        sampling=SamplingOptions(max_tokens=KV_OUT, temperature=0.0),
        stop=StopConditions(ignore_eos=True)).to_wire()



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

    t_start = time.perf_counter()
    # A phase that hangs prints every thread's stack and fails the run
    # before a 1,200 s limit cuts it silently.
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    dev = resolve_device("cuda")
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    phase_build()
    phase_noise(dev)
    entries = phase_kernels(dev) + phase_gemms(dev)
    launches = {}

    # the bf16 path (llama3-8b)
    worker, counts, default_streams = phase_engine(dev)
    launches["paged_decode_attention_pool"] = counts[
        "paged_decode_attention_pool"]
    try:
        phase_parity(worker)
        phase_prefill(dev, worker, "prefill_bf16")
        phase_graphs(dev, worker, "graphs_bf16")
        phase_serve(dev, worker, "serve_bf16")
        for name, n in phase_checkpoint(dev, worker).items():
            launches[name] = launches.get(name, 0) + n
        disagg, prefill, aggregated = phase_disagg(dev, worker)
        for name, n in disagg.items():
            launches[name] = launches.get(name, 0) + n
        for name, n in phase_comesh(dev, worker, prefill,
                                    aggregated).items():
            launches[name] = launches.get(name, 0) + n
        del prefill
        phase_batch_invariance(dev, worker)
    finally:
        worker.close()
    del worker
    free_memory()

    # the unified T = 1 path (row 3) and the one-layer drop-ins (row 4)
    launches.update(phase_unified(dev, default_streams))

    # speculative decoding (rows 1 folded)
    launches["paged_decode_attention_pool_folded"] = phase_engine_spec(dev)[
        "paged_decode_attention_pool_folded"]

    # the quantized path (mistral-7b, W4A16 + int8 KV)
    worker, counts, _ = phase_engine(
        dev, QMODEL, RunnerConfig(weight_dtype="int4", kv_dtype="int8"),
        label="engine_q", prewarm=True)
    n_layers = worker.model_config.n_layers
    check(matmul_kernels_per_forward(worker.runner)
          == {"q4_matmul_v2": 7 * n_layers + 1},
          "mistral-7b int4 must pack every projection in the v2 layout")
    for name in ("paged_decode_attention_pool_int8", "q4_matmul_v2"):
        launches[name] = launches.get(name, 0) + counts[name]
    try:
        phase_parity(worker, "parity_q")
        for name, n in phase_prefill(dev, worker, "prefill_q").items():
            launches[name] = launches.get(name, 0) + n
        phase_graphs(dev, worker, "graphs_q", spec_ks=(SPEC_K, SPEC_K + 1))
        phase_serve(dev, worker, "serve_q")
        for name, n in phase_logits_q(dev, worker).items():
            launches[name] = launches.get(name, 0) + n
        for run in range(KV_RUNS):
            for name, n in phase_serve_kv(dev, worker, run).items():
                launches[name] = launches.get(name, 0) + n
        res_launches, worker_b = phase_resilience(dev, worker)
        for name, n in res_launches.items():
            launches[name] = launches.get(name, 0) + n
        try:
            for name, n in phase_drain(dev, worker, worker_b).items():
                launches[name] = launches.get(name, 0) + n
        finally:
            worker_b.close()
        del worker_b
    finally:
        worker.close()
    del worker
    free_memory()

    # the spec step on the quantized path (row 2 folded, row 6 at M = 8 x 5
    # = 40: spec_q's runner has 8 slots)
    launches["paged_decode_attention_pool_int8_folded"] = phase_spec_q(dev)[
        "paged_decode_attention_pool_int8_folded"]

    # the secondary quantized paths
    launches["q8_matmul"] = phase_secondary(dev, "int8")["q8_matmul"]
    launches["q4_matmul_v1"] = phase_secondary(dev, "int4", "v1")[
        "q4_matmul_v1"]

    for name in KERNELS:
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on its path")
    # an extra case of a kernel ("name[shape]") carries that kernel's
    # launches on its path
    kernels = [{**e, "launches": launches[e["name"].split("[")[0]]}
               for e in entries]
    faulthandler.cancel_dump_traceback_later()
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
