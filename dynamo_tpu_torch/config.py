"""The environment knobs this package reads.

A subset of `dynamo_tpu/runtime/config.py`: the same names, defaults and
parsing, read straight from `os.environ` (no YAML overlay, no new knobs).
Each knob carries its own parser, so the registry holds bools, ints, floats
and strings.

`DYNT_Q8_MATMUL` and `DYNT_Q4_MATMUL` are not carried over: in the
reference they choose XLA over the Pallas kernel, and on the card the port
always launches its kernel (the plain PyTorch versions run only for CPU
tensors).
"""

from __future__ import annotations

import os
from typing import Any, Callable

_TRUTHY = {"1", "true", "yes", "on"}


def is_truthy(val: str) -> bool:
    """Lenient bool parsing, as the reference's `is_truthy`."""
    return val.strip().lower() in _TRUTHY


_REGISTRY: dict[str, tuple[Any, Callable[[str], Any], str]] = {
    # Discovery and request plane (runtime/config.py RuntimeConfig)
    "DYNT_DISCOVERY_BACKEND": (
        "file", str,
        "Discovery backend: mem | file | etcd (ref: DYN_DISCOVERY_BACKEND)"),
    "DYNT_DISCOVERY_PATH": (
        "/tmp/dynamo_tpu_discovery", str,
        "Root dir for the file discovery backend"),
    "DYNT_LEASE_TTL_SECS": (
        10.0, float,
        "Discovery lease TTL; dead workers deregister after this "
        "(ref: docs/design-docs/discovery-plane.md, 10s default)"),
    "DYNT_REQUEST_PLANE": (
        "tcp", str,
        "Request-plane transport: tcp (default) | http | mem "
        "(ref: DYN_REQUEST_PLANE tcp/http2/nats); addresses carry their "
        "scheme, so mixed-transport clusters interoperate"),
    "DYNT_TCP_HOST": ("0.0.0.0", str, "Request-plane TCP bind host"),
    "DYNT_TCP_ADVERTISE_HOST": (
        "127.0.0.1", str,
        "Host advertised to peers for request-plane connections"),
    "DYNT_TCP_PORT": (0, int, "Request-plane TCP port (0 = ephemeral)"),
    "DYNT_REQUEST_TIMEOUT_SECS": (
        600.0, float, "Per-request end-to-end timeout on the request plane"),
    "DYNT_CONNECT_TIMEOUT_SECS": (
        5.0, float, "TCP connect timeout for request-plane clients"),
    "DYNT_SYSTEM_PORT": (
        0, int,
        "System status server port (/health,/live,/metrics); 0 = ephemeral"),
    "DYNT_SYSTEM_ENABLED": (
        True, is_truthy, "Enable the system status server"),
    # Event plane (runtime/config.py RuntimeConfig)
    "DYNT_EVENT_PLANE": (
        "zmq", str,
        "Event-plane transport: zmq (default) | mem | journal (durable "
        "replayable log — the JetStream-mode analog, ref: "
        "kv_router/jetstream.rs)"),
    "DYNT_ZMQ_HOST": (
        "127.0.0.1", str, "Event-plane ZMQ bind/advertise host"),
    "DYNT_EVENT_JOURNAL_PATH": (
        "/tmp/dynamo_tpu_events", str,
        "Journal event-plane root directory (shared storage: local disk "
        "single-host, NFS/GCS-fuse across hosts)"),
    "DYNT_EVENT_JOURNAL_MAX_MB": (
        64, int,
        "Per-publisher journal size that triggers a snapshot rotation"),
    # Router
    "DYNT_ROUTER_OVERLAP_WEIGHT": (
        1.0, float,
        "KV router cost weight for prefix-overlap blocks "
        "(ref: kv-router scheduling/selector.rs:155)"),
    "DYNT_ROUTER_TEMPERATURE": (
        0.0, float, "KV router softmax sampling temperature (0 = argmin)"),
    "DYNT_BUSY_THRESHOLD": (
        None, float,
        "KV-load busy threshold for 503 load shedding; unset disables "
        "shedding (ref: http/service/busy_threshold.rs). The frontend "
        "--busy-threshold flag overrides"),
    "DYNT_ROUTER_QUEUE_POLICY": (
        "fcfs", str,
        "Router admission-queue ordering: fcfs | lcfs | wspt "
        "(ref: kv-router scheduling/policy.rs)"),
    "DYNT_ROUTER_QUEUE_THRESHOLD": (
        -1.0, float,
        "Park requests when every worker exceeds this fraction of its "
        "token budget; negative disables queueing "
        "(ref: kv-router scheduling/queue.rs threshold_frac)"),
    "DYNT_MAX_BATCHED_TOKENS": (
        0, int,
        "Per-worker token budget for the router admission gate. 0 leaves "
        "the gate effectively unlimited (DEFAULT_MAX_BATCHED_TOKENS) — "
        "set a real budget for queueing to engage "
        "(ref: queue.rs DEFAULT_MAX_BATCHED_TOKENS)"),
    "DYNT_INDEXER_TTL_SECS": (
        0.0, float,
        "Radix-index block TTL; 0 disables expiry "
        "(ref: indexer/pruning.rs PruneConfig ttl=120s when enabled)"),
    "DYNT_INDEXER_MAX_TREE_SIZE": (
        0, int,
        "Radix-index node budget; above it the oldest blocks prune to "
        "80% of budget (0 = unlimited; ref PruneConfig max_tree_size)"),
    "DYNT_INDEXER_ADMISSION": (
        False, is_truthy,
        "TinyLFU admission/eviction for the router radix prefix index: "
        "insertions at the DYNT_INDEXER_MAX_TREE_SIZE node cap are "
        "frequency-gated (doorkeeper absorbs one-hit-wonders, a cold "
        "chain cannot flush a hot shared prefix)"),
    # Engine
    "DYNT_DECODE_PIPELINE": (
        2, int,
        "Pipelined decode-block dispatches in flight (>1 overlaps the host "
        "readback of block d with block d+1's compute; the tokens chain on "
        "the device)"),
    "DYNT_DECODE_BLOCK": (
        8, int,
        "Decode steps fused into one runner call with no host sync; tokens "
        "stream in blocks of this size"),
    "DYNT_KV_BLOCK_SIZE": (
        16, int,
        "Tokens per KV block (block-hash granularity and paged-KV page size)"),
    "DYNT_Q4_GROUP": (
        "256", str,
        "int4 quantization group (contracted rows per scale/zero row): 256 "
        "| 128 (finer GPTQ/AWQ-convention groups)"),
    "DYNT_Q4_VARIANT": (
        "auto", str,
        "Packed-int4 layout the quantizer emits: auto (v2 wherever K "
        "divides 2*group, else v1) | v1 (half-block per group, uint8) | v2 "
        "(global half-split with signed codes, int8). The matmul dispatches "
        "on the packed dtype; already-quantized trees repack at load"),
    "DYNT_SPEC_ENABLE": (
        False, is_truthy,
        "Draftless speculative decoding (prompt-lookup n-gram proposals "
        "+ batched verification): up to DYNT_SPEC_MAX_K proposed tokens "
        "per slot are scored in ONE forward pass and the sampler-exact "
        "prefix commits. Output streams are the ones non-speculative "
        "decode samples; off keeps the decode path untouched"),
    "DYNT_SPEC_MAX_K": (
        4, int,
        "Max draft tokens proposed per slot per speculative step (the "
        "verification chunk is k+1 positions, folded into the GQA group "
        "of the decode kernel)"),
    "DYNT_SPEC_MIN_EMA": (
        0.1, float,
        "Per-slot acceptance-rate EMA floor: a slot whose EMA falls "
        "below this stops proposing (it still probes occasionally; "
        "acceptance is a property of the text, which changes). 0 never "
        "disables a slot"),
    "DYNT_SPEC_BATCH_CUTOFF": (
        0, int,
        "Auto-disable speculation when more than this many slots are "
        "decode-ready: speculation trades FLOPs for latency, and at high "
        "batch the verification FLOPs stop being free. 0 disables the "
        "cutoff (speculate at any batch)"),
    # Disaggregated prefill/decode (engine/scheduler.py, engine/worker.py,
    # llm/prefill_router.py)
    "DYNT_DISAGG_PIPELINE": (
        1, int,
        "Chunked streaming handoff for disaggregated prefill: any non-zero "
        "value makes the prefill worker stream kv_transfer_params after its "
        "FIRST chunk and park pages per chunk, so the decode worker pulls "
        "chunk i while chunk i+1 computes. 0 disables streaming: the "
        "prefill leg returns transfer params only after the whole prompt"),
    "DYNT_DISAGG_CHUNK": (
        0, int,
        "Prefill tokens per streamed chunk for prefill-only sequences (the "
        "disagg handoff granularity). 0 uses the engine's max prefill "
        "chunk; smaller chunks start the KV handoff earlier"),
    # Graceful drain (engine/drain.py): the departure ladder
    "DYNT_DRAIN_ENABLE": (
        True, is_truthy,
        "Graceful drain on SIGTERM / POST /drain / the drain verb: flip the "
        "worker to draining (routers stop selecting it), hand live decode "
        "sequences to peers via KV handoff, and deregister only when empty "
        "or the deadline expires"),
    "DYNT_DRAIN_DEADLINE_SECS": (
        20.0, float,
        "Budget for a graceful drain, end to end: KV-state handoff -> "
        "cooperative replay-migrate -> honest in-band error at expiry; "
        "handoff transfers not pulled by then are expired"),
    "DYNT_DRAIN_ANNOUNCE_SETTLE_SECS": (
        0.25, float,
        "Pause between announcing `draining` (card + LoadMetrics) and "
        "sweeping live sequences, so routers stop selecting this worker "
        "before handoff frames ask them to re-dispatch"),
    "DYNT_DRAIN_HANDOFF": (
        True, is_truthy,
        "Live KV-state handoff during drain; off sends every drained "
        "sequence down the cooperative replay rung"),
    "DYNT_DRAIN_HTTP": (
        True, is_truthy,
        "Serve POST /drain on the status server (unauthenticated and "
        "terminal; turn off where the status port is reachable beyond the "
        "operators)"),
    # Observability (runtime/flight_recorder.py, runtime/status.py): the
    # request timelines and the on-demand profiler capture
    "DYNT_FLIGHT_RECORDER_SIZE": (
        256, int,
        "Completed request timelines the per-process flight recorder "
        "retains (ring buffer behind /debug/requests)"),
    "DYNT_SLOW_TRACE_MS": (
        0.0, float,
        "Force-sample slow requests: a request whose end-to-end wall time "
        "meets this threshold has its flight-recorder timeline dumped to the "
        "log at WARNING (0 disables)"),
    "DYNT_CONFORMANCE": (
        False, is_truthy,
        "Runtime protocol-conformance monitor (runtime/conformance.py): "
        "replay flight-recorder stamps, drain / breaker / transfer / "
        "preemption lifecycle events against the protocol specs and count "
        "violations into dynamo_protocol_violations_total"),
    "DYNT_DEBUG_ENDPOINTS": (
        False, is_truthy,
        "Also serve /debug/requests and /debug/profile on the tenant-facing "
        "OpenAI frontend port (they leak cross-request timelines, so they "
        "are opt-in there; the internal status server always serves them)"),
    "DYNT_PROF_DIR": (
        "/tmp/dynamo_tpu_profiles", str,
        "Directory /debug/profile captures write their traces into (one "
        "timestamped subdirectory per capture)"),
    "DYNT_PROF_DEFAULT_MS": (
        1000, int,
        "Capture duration for /debug/profile when the request sends no "
        "duration_ms query parameter"),
    "DYNT_PROF_MAX_MS": (
        30000, int,
        "Ceiling on a single /debug/profile capture: profiling holds buffers "
        "in the serving process, so an operator typo must not pin it for "
        "minutes"),
    # Worker startup: the arrival ladder (engine/worker.py prepare,
    # weights/, engine/coldstart.py, engine/compile_cache.py) and the
    # snapshot gate (runtime/snapshot.py)
    "DYNT_WEIGHT_SERVICE": (
        "", str,
        "Unix socket of the weight service (GMS analog): workers "
        "re-attach published weights on restart instead of initializing"),
    "DYNT_WEIGHT_STRIPE": (
        True, is_truthy,
        "Striped peer weight pull: a joining worker (weights_from_peer) "
        "stripes the content-addressed chunk manifest across every "
        "live donor in parallel, with digest verification and "
        "resume-after-donor-death. Off falls back to the single-peer "
        "stream"),
    "DYNT_WEIGHT_STRIPE_DONORS": (
        4, int,
        "Max donors a striped weight pull fans out across (more donors "
        "= more aggregate fetch bandwidth, but each pays its "
        "DYNT_WEIGHT_STREAM_BW_FRAC duty cycle)"),
    "DYNT_WEIGHT_STREAM_BW_FRAC": (
        0.5, float,
        "Donor-side bandwidth budget for weight streaming: the "
        "fraction of wall time a serving donor may spend on param "
        "gathers for a cold peer. Same pacing formula as "
        "DYNT_OFFLOAD_BW_FRAC (defer g*(1/frac - 1) after a gather "
        "costing g), gathers ride the scheduler's dispatch/drain gap, "
        "so the donor's decode ITL does not regress. 1.0 disables "
        "pacing"),
    "DYNT_WEIGHT_STORE": (
        "", str,
        "Object-store root for the weight-tree rung (filesystem "
        "path or http(s) S3/GCS-shaped endpoint with DYNT_G4_* "
        "auth): a joining worker with no live peer fetches the "
        "content-addressed chunk tree from here; resolved workers "
        "publish to it best-effort off the startup critical path. "
        "Empty disables the rung"),
    "DYNT_COLDSTART_BUDGET_SECS": (
        60.0, float,
        "Pinned cold-start-to-first-token budget for a joining worker "
        "(the arrival-side twin of DYNT_DRAIN_DEADLINE_SECS): a "
        "completed ladder above it logs a warning naming its slowest "
        "phase"),
    "DYNT_SNAPSHOT_MODE": (
        "off", str,
        "Worker snapshot protocol: off | dump (prepare the engine, write "
        "the ready marker, block until the restore marker appears, then "
        "connect with a fresh instance id — the CRIU analog). --mode "
        "comesh refuses dump"),
    "DYNT_SNAPSHOT_DIR": (
        "/tmp/dynamo_tpu_snapshot", str,
        "Directory for snapshot ready/restore marker files"),
    # The reference's default names its JAX compilation cache. The port's
    # compile products are the kernel libraries nvcc builds, so unset means
    # the kernel build directory (ops/_build.BUILD_DIR, build/dynamo_tpu_torch
    # under the checkout); set, the kernels build into and load from it
    "DYNT_COMPILE_CACHE_DIR": (
        "", str,
        "Directory of the built kernel libraries (the compile cache); "
        "empty = build/dynamo_tpu_torch under the checkout"),
    "DYNT_COMPILE_CACHE_STORE": (
        "", str,
        "Object-store root (filesystem path or http(s) endpoint) the "
        "compile cache syncs with: a joining worker pulls the built "
        "kernel libraries down before building its engine and pushes new "
        "ones up after warmup, so a warm-cache arrival runs no nvcc. "
        "Empty disables the sync"),
    "DYNT_COMPILE_CACHE_PREFIX": (
        "compile-cache", str,
        "Key prefix compile-cache entries live under in the "
        "DYNT_COMPILE_CACHE_STORE object store"),
    # Resilience: deadlines, retries, breakers, migration, canaries
    # (runtime/resilience.py, runtime/health_check.py, llm/engine.py)
    "DYNT_STREAM_IDLE_TIMEOUT_SECS": (
        120.0, float,
        "Max gap between response frames on a streaming request (and the "
        "wait for the first frame) before the client declares the worker "
        "black-holed and raises ConnectionLost; 0 disables"),
    "DYNT_DEADLINE_SECS": (
        600.0, float,
        "Default end-to-end request deadline the frontend stamps when the "
        "caller sends no x-dynt-deadline-ms header (0 disables)"),
    "DYNT_RETRY_BUDGET_RATIO": (
        0.2, float,
        "Retry-budget deposit per completed first attempt: retries are "
        "capped at ~this fraction of live traffic"),
    "DYNT_RETRY_BUDGET_MIN": (
        3.0, float,
        "Retry-budget seed tokens so a cold client can still retry"),
    "DYNT_RETRY_BACKOFF_BASE_MS": (
        50.0, float, "Decorrelated-jitter backoff floor between retries"),
    "DYNT_RETRY_BACKOFF_CAP_MS": (
        2000.0, float, "Decorrelated-jitter backoff ceiling between retries"),
    "DYNT_RETRY_MAX_ATTEMPTS": (
        3, int,
        "Router retry attempt cap per request (raised to live instance "
        "count + 1 when more candidates exist)"),
    "DYNT_BREAKER_FAILURES": (
        1, int,
        "Consecutive transport failures that open an instance's circuit "
        "breaker"),
    "DYNT_BREAKER_RESET_SECS": (
        5.0, float,
        "Open -> half-open delay before an open breaker admits its single "
        "recovery probe"),
    "DYNT_MIGRATION_LIMIT": (
        3, int,
        "Failure migrations (stream replays on another worker) per request"),
    # Priority classes and preemption (engine/scheduler.py)
    "DYNT_PREEMPT_ENABLE": (
        True, is_truthy,
        "Preempt batch-class decode slots under interactive pressure: park "
        "to the KVBM park store (resumed when pressure clears, the committed "
        "stream unchanged), or a cooperative migrate when no park store is "
        "attached. Off = class-blind slot allocation (priority still orders "
        "the queues)"),
    "DYNT_PREEMPT_MAX_PARKED": (
        16, int,
        "Bound on concurrently parked (preempted) sequences per engine; past "
        "it a preemption takes the cooperative migrate"),
    "DYNT_PREEMPT_MIGRATION_LIMIT": (
        3, int,
        "Cooperative migrations (worker-emitted finish_reason=migrate) per "
        "request, bounded apart from DYNT_MIGRATION_LIMIT"),
    "DYNT_CANARY_WAIT_SECS": (
        30.0, float, "Idle time before canary health-check probes"),
    # Deadline-aware admission and tenant quotas (runtime/admission.py)
    "DYNT_ADMISSION_ENABLE": (
        True, is_truthy,
        "Refuse work whose deadline cannot survive the estimated queue "
        "wait (503 + Retry-After); off restores pure FCFS admission"),
    "DYNT_ADMISSION_HALFLIFE_SECS": (
        5.0, float, "Half-life of the per-pool drain-rate EWMA"),
    "DYNT_ADMISSION_MARGIN": (
        1.2, float,
        "Refuse when estimated wait * margin > remaining deadline budget"),
    "DYNT_RETRY_AFTER_MIN_SECS": (
        1.0, float, "Floor on the Retry-After seconds of a 503 shed"),
    "DYNT_RETRY_AFTER_MAX_SECS": (
        30.0, float,
        "Cap on the Retry-After seconds of a 503 shed (and what a stalled "
        "pool advertises)"),
    "DYNT_TENANT_RATE_LIMIT": (
        0.0, float,
        "Capacity (tokens/s: prompt + max_tokens of admitted requests) the "
        "weighted fair-share quota divides among tenants; 0 disables"),
    "DYNT_TENANT_WINDOW_SECS": (
        10.0, float, "Sliding window of the per-tenant token-rate ledger"),
    "DYNT_TENANT_WEIGHTS": (
        "", str, "Per-tenant fair-share weights as 'tenantA=4,tenantB=1'"),
    "DYNT_TENANT_DEFAULT_WEIGHT": (
        1.0, float,
        "Fair-share weight of tenants not named in DYNT_TENANT_WEIGHTS"),
    # KVBM offload (block_manager/offload.py)
    "DYNT_OFFLOAD_BW_FRAC": (
        0.25, float,
        "Bandwidth budget for KVBM D2H offload: the fraction of wall time "
        "the offload path may hold the scheduler thread with device "
        "gathers. After a gather that took g seconds in-step, the next "
        "gather is deferred g*(1/frac - 1) seconds. 0 disables throttling"),
    "DYNT_OFFLOAD_SUBBATCH": (
        2, int,
        "Pages per in-step offload gather sub-batch; one sub-batch bundle "
        "sinks to G2 while the next gathers (double buffering)"),
    "DYNT_OFFLOAD_QUEUE_CAP": (
        4096, int,
        "Bound on the KVBM offload queue (blocks awaiting D2H); a store "
        "burst past the cap drops the OLDEST queued blocks (counted by "
        "dynamo_kvbm_offload_dropped_total)"),
    # KVBM pin leases (block_manager/manager.py)
    "DYNT_PIN_TTL_SECS": (
        300.0, float,
        "Default lease TTL for a cache_control pinned prefix (a "
        "request-supplied ttl is clamped to at most this). A pinned prefix "
        "cannot be evicted from KVBM G2/G3 mid-lease but ALWAYS dies at "
        "TTL"),
    # G4 object-store auth (block_manager/storage.py HttpObjectStoreClient)
    "DYNT_G4_AUTH": (
        "none", str,
        "Auth mode for the HTTP(S) G4 object-store client: none | hmac "
        "(SigV4-style canonical-string request signing) | bearer (static "
        "token)"),
    "DYNT_G4_HMAC_KEY_ID": (
        "", str,
        "Access-key id sent in the Authorization Credential for "
        "hmac-signed G4 requests"),
    "DYNT_G4_HMAC_SECRET": (
        "", str, "HMAC-SHA256 signing secret for G4 request signing"),
    "DYNT_G4_BEARER_TOKEN": (
        "", str,
        "Static bearer token for G4 requests when DYNT_G4_AUTH=bearer"),
    "DYNT_G4_SIG_TTL_SECS": (
        300.0, float,
        "Maximum age of a signed G4 request's x-dynt-date before the "
        "server rejects it (replay window)"),
}


def env(name: str) -> Any:
    """Read a registered knob with its declared parser and default."""
    default, parse, _doc = _REGISTRY[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    return parse(raw)
