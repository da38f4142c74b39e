"""TorchWorker: the engine a worker serves from, and the worker entry point.

Port of `TpuWorker` in `dynamo_tpu/engine/worker.py`. `generate` keeps the
reference's contract: a `PreprocessedRequest` wire dict in, a stream of
`EngineOutput` wire dicts out, the last one carrying `finish_reason`.
`serve()` registers the `generate`, `clear_kv_blocks`, `kv_blocks`,
`kv_pull` and `drain` endpoints on a DistributedRuntime's request plane
(and the drain on its status server's POST /drain), publishes the worker's
ModelDeploymentCard into discovery, as `TpuWorker.serve` does, so the
frontends of both packages route to it, and publishes the worker's KV events
(stored / removed / cleared, every 50 ms) and load metrics (every 0.5 s) on
the event plane, so either package's kv-mode router scores it. `main` is
`python -m dynamo_tpu_torch.worker`.

`TorchWorker(model_path=dir)` serves an HF checkpoint directory, as
`TpuWorker(model_path=...)` does: the architecture from its config.json,
the weights from its safetensors shards (`models/checkpoint.py`, loaded on
the device leaf by leaf; a load error is fatal, never random weights), and
the card advertises an `hf` tokenizer when the directory holds a
`tokenizer.json`.

The arrival ladder (`prepare`, as `TpuWorker.prepare`): the weights come
from the first rung that answers — a weight service's shared memory
(`weight_service=`), a striped pull from live peers' `weights` endpoints
(`weights_from_peer=`), one peer, the object store (DYNT_WEIGHT_STORE), the
checkpoint, or a random draw — checked leaf by leaf against the model's
template, then go to the card; a thread publishes them to the service and
the store for the next arrival. `self.coldstart` stamps `fetch`, `load`,
`compile` (kernels built, warm-up), `register` (`serve`) and `first_token`
(the first served token, canaries aside). Every worker serves its weights
on the `weights` endpoint: the full stream, or the striped manifest and
chunks from a host copy gathered once in the scheduler's gaps and paced by
DYNT_WEIGHT_STREAM_BW_FRAC. `main` can gate startup on a snapshot
(DYNT_SNAPSHOT_MODE=dump, `runtime/snapshot.py`): prepare, the ready
marker, the restore marker, a fresh instance id, then the runtime and
`serve`.

`generate` is served with the reference's canary payload (a one-token
greedy request annotated `canary`), and `main` starts a HealthCheckManager
(DYNT_CANARY_WAIT_SECS) that probes it when idle and deregisters a worker
whose canaries keep failing. A deadline watchdog's cancel closes the
`generate` stream, which cancels the sequence: its pages return to the pool
within one scheduler iteration. A replayed request (`prior_output_tokens`
set by the frontend's Migration) is served as the reference serves it: as
a longer prompt.

Disaggregated serving (`mode`): a `prefill` worker publishes a `[PREFILL]`
card (under the `prefill` component from the CLI) and serves every request
prefill-only: it parks the prompt's pages in its `PendingTransferTable`
(`llm/kv_transfer.py`) and answers with `kv_transfer_params`, after the
first chunk when DYNT_DISAGG_PIPELINE streams the handoff (pages parked
chunk by chunk, the first token in the pull stream's last frame), else
after the whole prompt. A request carrying `disaggregated_params` pulls the
pages from the owner's `kv_pull` endpoint (`_pull_remote_kv`: frames
assembled on the host, the upload staged on a side stream off the step
thread) and is admitted without a prefill pass; a failed pull recomputes
the prefill. Every worker serves `kv_pull` and `drain` in every mode: the
drain ladder (`engine/drain.py`; SIGTERM, the `drain` verb, or the status
server's POST /drain) parks each live decode sequence's prompt and
generated pages and hands it to a peer with its resume state, and a failed
handoff pull bounces with a plain migrate (the replay rung).

Co-located disaggregation (`--mode comesh`, `engine/ici_transfer.py`): a
prefill worker and a decode worker in one process share an `IciKvBridge`
(`ici_bridge=`). The prefill side advertises the bridge's token in its
`kv_transfer_params`, and a decode worker holding the same bridge pulls
through it, device to device, instead of over the wire; a drain handoff
never offers the token, so it always takes the host relay.

KV block manager tiers (`kvbm_config`, `--kvbm-host-blocks` /
`--kvbm-disk-blocks` / `--kvbm-disk-path` / `--kvbm-object-store`): the
scheduler gets a `block_manager.KvBlockManager` over this runner's layout,
offloading prompt blocks as they register and onboarding them at
admission; `generate` leases a request's `cache_anchors` prefix blocks
(`cache_ttl`, at most DYNT_PIN_TTL_SECS) and prefetches them into G2 (a
`session_pin` event), the event-drain tick sweeps expired leases, and
`shutdown` flushes the offload before it stops the scheduler. The same
manager is the park store of the scheduler's preemption: a batch decode slot
preempted for an interactive request parks its pages there and resumes
later; with no KVBM the victim migrates (the frontend replays it). Parked
sequences count as waiting in LoadMetrics.

Every request's phases go on a flight-recorder timeline
(`runtime/flight_recorder.py`; a prefill leg's under `<id>#prefill`), with a
`kv_pull` event naming the link it took (`ici` or `dcn`) and the pull's
split. LoadMetrics carry the last step's device / host split
(`perf/steptrace.py`), and the metrics tick publishes the step histograms,
the host-bound verdict and the live MFU and roofline-fraction gauges. The
card names the worker's tool and reasoning parsers (`--tool-call-parser`,
`--reasoning-parser`), and the scheduler's logits processors get the card's
tokenizer, as in the reference.

Multi-LoRA (`RunnerConfig.max_loras` > 0, `--max-loras`, `--lora-rank`,
`--lora NAME=PATH`): a `llm.lora.LoraManager` maps adapter names to the
runner's slots, and `serve` registers the `lora_load`, `lora_unload` and
`lora_list` endpoints, loads the startup adapters (after `prepare`, so a
worker that arrived from any rung of the ladder serves them) and puts
`runtime_config["lora"]` (slots, rank) and `["loras"]` (the loaded names)
on the card, republished on every load and unload. A slot is written on the
scheduler thread between steps; an unload is two-phase and refused while a
sequence still uses the slot. `generate` resolves a request's
`lora_name` to its slot after its last await, just before `submit`, and
answers `adapter '<name>' not loaded here` in band when it has none.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import logging
import os
import threading
import time
import uuid
from typing import AsyncIterator, Optional, Union

import numpy as np

from ..block_manager import BlockLayoutSpec, KvBlockManager, KvbmConfig
from ..config import env
from ..device import DeviceLike, resolve_device
from ..kv_router.local_indexer import LocalKvIndexer
from ..kv_router.protocols import (
    KV_EVENT_TOPIC,
    KV_SNAPSHOT_TOPIC,
    LOAD_TOPIC,
    KvCacheRemoved,
    KvCacheStored,
    LoadMetrics,
    RouterEvent,
)
from ..llm.kv_transfer import (
    BlockAssembler,
    KvLayoutDescriptor,
    PendingTransfer,
    PendingTransferTable,
    StreamingTransfer,
    encode_block_chunks,
)
from ..llm.lora import LoraManager
from ..llm.model_card import (
    CHAT,
    COMPLETIONS,
    PREFILL,
    ModelDeploymentCard,
    publish_card,
    unpublish_card,
)
from ..llm.protocols import (
    EngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from ..llm.tokenizer import load_tokenizer
from ..models import ModelConfig, Transformer, get_config, init_params
from ..models.checkpoint import (
    checkpoint_digest,
    config_from_checkpoint,
    load_params,
)
from ..models.transformer import AttentionFn
from ..perf.steptrace import LiveRoofline
from ..runtime import metrics as rt_metrics
from ..runtime.component import new_instance_id
from ..runtime.flight_recorder import current_request_id, get_recorder
from ..runtime.metrics import DISAGG_STREAMED_PAGES
from ..runtime.push_router import PushRouter
from ..tokens import compute_block_hashes, xxh64
from ..weights.client import flatten_params
from .coldstart import ColdStartLadder
from .model_runner import ModelRunner, RunnerConfig
from .drain import SERVING, DrainCoordinator, set_drain_state
from .ici_transfer import split_devices
from .scheduler import InferenceScheduler

log = logging.getLogger("dynamo_tpu_torch.worker")


class KvEventBuffer:
    """Thread-safe KV event buffer: the scheduler thread records stored /
    removed page hashes; an async drain task batches them onto the event
    plane (the reference batches publishes the same way,
    kv_router/publisher). Event ids are consecutive per worker, and the
    local indexer records each event under the same lock."""

    def __init__(self, worker_id: int, dp_rank: int = 0) -> None:
        self.worker_id = worker_id
        self.dp_rank = dp_rank
        self._lock = threading.Lock()
        self._pending: list[RouterEvent] = []
        self._event_id = 0
        # Queryable record of this worker's blocks — the router's resync/
        # bootstrap source (kv_router/local_indexer.py).
        self.local_index = LocalKvIndexer(worker_id, dp_rank)

    def on_stored(self, hashes: list[int], parent: Optional[int]) -> None:
        with self._lock:
            self._pending.append(RouterEvent(
                worker_id=self.worker_id, event_id=self._event_id,
                dp_rank=self.dp_rank,
                stored=KvCacheStored(block_hashes=list(hashes),
                                     parent_hash=parent),
            ))
            self.local_index.on_stored(self._event_id, list(hashes), parent)
            self._event_id += 1

    def on_removed(self, hashes: list[int]) -> None:
        with self._lock:
            self._pending.append(RouterEvent(
                worker_id=self.worker_id, event_id=self._event_id,
                dp_rank=self.dp_rank,
                removed=KvCacheRemoved(block_hashes=list(hashes)),
            ))
            self.local_index.on_removed(self._event_id, list(hashes))
            self._event_id += 1

    def on_cleared(self) -> None:
        """Whole-cache invalidation (clear_kv_blocks)."""
        with self._lock:
            self._pending.append(RouterEvent(
                worker_id=self.worker_id, event_id=self._event_id,
                dp_rank=self.dp_rank, cleared=True,
            ))
            self.local_index.on_cleared(self._event_id)
            self._event_id += 1

    def drain(self) -> list[RouterEvent]:
        with self._lock:
            out, self._pending = self._pending, []
            return out


class TorchWorker:
    def __init__(
        self,
        model: Union[str, ModelConfig] = "llama3-8b",
        runner_config: Optional[RunnerConfig] = None,
        *,
        device: DeviceLike = "cuda",
        seed: int = 0,
        params: Optional[Transformer] = None,
        attention_fn: Optional[AttentionFn] = None,
        namespace: str = "dynamo",
        component: str = "backend",
        tool_parser: Optional[str] = None,
        reasoning_parser: Optional[str] = None,
        model_path: Optional[str] = None,
        served_name: Optional[str] = None,
        dtype: str = "bfloat16",
        mode: str = "aggregated",
        ici_bridge=None,
        kvbm_config=None,
        weight_service: Optional[str] = None,
        weights_from_peer: bool = False,
        lora_adapters: Optional[dict[str, str]] = None,  # name -> npz path
    ) -> None:
        """`model` is a preset name or a ModelConfig. Without `params` the
        weights are random, drawn from `seed` on `device`. `model_path`, an
        HF checkpoint directory, overrides both: the config comes from its
        config.json (named after the directory) and the weights, cast to
        `dtype` (bfloat16, as the reference), from its shards; the
        runner's weight_dtype then quantizes them in place. The card is
        named `served_name` when given. `attention_fn`
        goes to the runner, as `TpuWorker(attention_fn=...)` does: the
        unified forward then serves decode and prefill with it (for example
        `ops.paged_attention.paged_attention`, the T = 1 kernel), and
        speculation is off. `namespace` and `component` place the worker's
        endpoints and card for `serve`; `tool_parser` and `reasoning_parser`
        go on the card, for the frontends' output parsers. `mode` is
        "aggregated", "prefill" (a `[PREFILL]` card; every request is served
        prefill-only) or "decode" (served as aggregated: it decodes what a
        prefill pool prefilled, and prefills itself when no pool answers).
        `ici_bridge`, an `engine.ici_transfer.IciKvBridge` shared by a
        prefill and a decode worker in one process: the prefill side
        attaches to it, and the decode side pulls through it.
        `kvbm_config`, a `block_manager.KvbmConfig` with host blocks, gives
        the scheduler a KvBlockManager over this runner's layout (G2 host,
        optional G3 disk and G4 object store): prompt blocks offload as
        they register and onboard at admission.

        The arrival ladder: `weight_service` (a weight service's unix
        socket), `weights_from_peer` (pull from live peers serving this
        component's `weights` endpoint) or DYNT_WEIGHT_STORE (an object
        store) make the worker resolve its weights in `await prepare()`,
        walking service -> striped peers -> one peer -> object store ->
        checkpoint -> random init, and publish what it resolved to the
        service and the store for the next arrival. Without any of them,
        as before, the constructor loads the checkpoint or draws the
        weights at once, and `start()` (or `prepare()`) builds the kernels
        and warms up. Either way `self.coldstart` stamps the rungs.

        With `runner_config.max_loras` > 0 the worker serves LoRA adapters
        (`self.loras`, a LoraManager); `lora_adapters` (name -> `.npz`
        path) load when `serve` runs. Adapters without slots raise the
        reference's ValueError."""
        if mode not in ("aggregated", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r} (expected aggregated, "
                             "prefill or decode)")
        self.mode = mode
        self.device = resolve_device(device)
        self.ici_bridge = ici_bridge
        if ici_bridge is not None and mode == "prefill":
            ici_bridge.attach_prefill(self)
        self.model_path = model_path
        tokenizer = {"kind": "byte"}
        if model_path:
            if params is not None:
                raise ValueError("give model_path or params, not both")
            self.model_config = config_from_checkpoint(model_path,
                                                       dtype=dtype)
            if os.path.exists(os.path.join(model_path, "tokenizer.json")):
                tokenizer = {"kind": "hf", "path": model_path}
        else:
            self.model_config = (get_config(model) if isinstance(model, str)
                                 else model)
        self.runner_config = runner_config or RunnerConfig(
            page_size=env("DYNT_KV_BLOCK_SIZE"))
        self.loras: Optional[LoraManager] = None
        if self.runner_config.max_loras > 0:
            self.loras = LoraManager(self.model_config,
                                     self.runner_config.max_loras,
                                     self.runner_config.lora_rank)
        elif lora_adapters:
            raise ValueError(
                "LoRA adapters were given but max_loras=0 — set "
                "--max-loras to enable adapter slots")
        self._initial_loras = dict(lora_adapters or {})
        self._seed = seed
        self._attention_fn = attention_fn
        self._kvbm_config = kvbm_config
        self.runtime = None
        self.instance_id = new_instance_id()
        self.events = KvEventBuffer(self.instance_id)
        # Built from the resolved weights: at once, or in prepare()
        self.runner: Optional[ModelRunner] = None
        self.kvbm: Optional[KvBlockManager] = None
        self.scheduler: Optional[InferenceScheduler] = None
        # Parked KV transfers served by kv_pull (a prefill leg's prompt
        # pages, or a drain handoff's), expired on the event-drain tick
        self.transfers = PendingTransferTable()
        # Streamed handoffs (DYNT_DISAGG_PIPELINE): live streaming transfers
        # by request id, appended per prefill chunk on the scheduler thread
        self.disagg_pipeline = max(0, int(env("DYNT_DISAGG_PIPELINE") or 0))
        self._stream_transfers: dict[str, StreamingTransfer] = {}
        self._pull_clients: dict[str, PushRouter] = {}
        # The drain ladder (engine/drain.py); LoadMetrics carries the flag
        self.draining = False
        self._drain_coordinator: Optional[DrainCoordinator] = None
        self._publisher = None
        # The latest pulls' links, sizes and times (the puller's side)
        self.pulls: collections.deque = collections.deque(maxlen=256)
        # The live roofline gauges (perf/steptrace.py LiveRoofline) and the
        # previous tick's cumulative (prefill tokens, decode tokens, decode
        # steps, device ms) behind dynamo_mfu / dynamo_roofline_fraction
        self._roofline: Optional[LiveRoofline] = None
        self._roof_prev: Optional[tuple] = None
        self.card = ModelDeploymentCard(
            name=served_name or self.model_config.name,
            model_types=[PREFILL] if mode == "prefill" else [CHAT, COMPLETIONS],
            namespace=namespace,
            component=component,
            endpoint="generate",
            context_length=min(self.model_config.max_context,
                               self.runner_config.max_context),
            kv_block_size=self.runner_config.page_size,
            total_kv_blocks=self.runner_config.num_pages,
            tokenizer=tokenizer,
            tool_parser=tool_parser,
            reasoning_parser=reasoning_parser,
        )
        # Routers bootstrap / gap-resync from our local indexer (the
        # frontend's manager gates its resync calls on this flag).
        self.card.runtime_config["kv_blocks_endpoint"] = True
        self._served: list = []
        self._tasks: list[asyncio.Task] = []
        # The arrival ladder (engine/coldstart.py): which rung gave the
        # weights (init | service | peer_striped | peer | object_store |
        # checkpoint); the ladder closes at the first served token
        self._weight_service = weight_service or None
        self._weights_from_peer = weights_from_peer
        self.weights_source = "init"
        self.coldstart = ColdStartLadder(f"{self.instance_id:x}")
        self._template: Optional[Transformer] = None
        self._publish_task: Optional[asyncio.Task] = None
        # Donor side of the striped pull: (weights_key, WeightManifest,
        # per-param host bytes), built once on the first manifest or chunk
        # request; the lock serializes pullers so the paced gather runs once
        self._donor_cache: Optional[tuple] = None
        self._donor_task: Optional[asyncio.Task] = None
        self._donor_task_key: Optional[str] = None
        self._donor_lock = asyncio.Lock()
        if params is None and (self._weight_service or weights_from_peer
                               or env("DYNT_WEIGHT_STORE")):
            return  # prepare() walks the ladder
        with self.coldstart.phase("fetch"):
            if model_path:
                # on the device leaf by leaf; an error is fatal, never
                # random weights
                params = load_params(model_path, self.model_config,
                                     device=self.device)
                self.weights_source = "checkpoint"
        self.coldstart.source = self.weights_source
        with self.coldstart.phase("load"):
            self._build_engine(params)

    def _build_engine(self, params: Optional[Transformer]) -> None:
        """The runner over `params` (moved to the device; random when None),
        the KVBM over its layout, and the scheduler."""
        if params is not None and params.embed.device != self.device:
            params = params.to(self.device)
        self.runner = ModelRunner(self.model_config, self.runner_config,
                                  device=self.device, params=params,
                                  seed=self._seed,
                                  attention_fn=self._attention_fn)
        kvbm_config = self._kvbm_config
        if kvbm_config is not None and kvbm_config.enabled:
            self.kvbm = KvBlockManager(
                kvbm_config,
                BlockLayoutSpec.from_runner_layout(self.runner.kv_layout()),
                pin_memory=self.device.type == "cuda")
        self.scheduler = InferenceScheduler(
            self.runner, on_stored=self.events.on_stored,
            on_removed=self.events.on_removed, kvbm=self.kvbm)
        # Logits-processor factories that declare a `tokenizer` parameter
        # (guided decoding) get this model's tokenizer.
        self.scheduler.logits_tokenizer = load_tokenizer(self.card.tokenizer)

    def start(self, prewarm: bool = False) -> None:
        """The compile rung: build the kernels (on the card), warm the
        runner up (`prewarm`: capture the whole steady-state key space),
        then start the scheduler thread."""
        if self.runner is None:
            raise RuntimeError("the weights are not resolved yet: "
                               "await prepare() walks the arrival ladder")
        with self.coldstart.phase("compile"):
            if self.device.type == "cuda":
                from ..ops import _build

                _build.build_all()
            (self.runner.prewarm if prewarm else self.runner.warmup)()
        self.scheduler.start()

    async def prepare(self, runtime=None, prewarm: bool = False) -> None:
        """Build the engine: walk the arrival ladder's `fetch` and `load`
        rungs when the constructor left the weights unresolved, then the
        `compile` rung (`start`: kernels built, warm-up, scheduler thread).
        `runtime` (a DistributedRuntime) lets the peer rungs pull; without
        it they are skipped, as at a snapshot's dump point, where no
        connection may be open. With DYNT_COMPILE_CACHE_STORE the built
        kernel libraries sync down before the build and up after it."""
        if runtime is not None:
            self.runtime = runtime
        if self.runner is None:
            with self.coldstart.phase("fetch"):
                params, client = await self._resolve_params()
            self.coldstart.source = self.weights_source
            with self.coldstart.phase("load"):
                await asyncio.to_thread(self._build_engine, params)
            del params
            self._publish_forward(client)
        log.info("weights source: %s", self.weights_source)
        cache_store = env("DYNT_COMPILE_CACHE_STORE")
        if cache_store:
            from .compile_cache import sync_down

            t0 = time.monotonic()
            await asyncio.to_thread(sync_down)
            self.coldstart.mark("compile", time.monotonic() - t0)
        await asyncio.to_thread(self.start, prewarm)
        if cache_store:
            from .compile_cache import sync_up

            self._tasks.append(asyncio.create_task(
                asyncio.to_thread(sync_up)))

    def _weights_key(self) -> str:
        """Arena, stream and store key: the model name and an XXH64 of the
        whole config (any architecture change misses the old arena), then
        the checkpoint's content digest when there is a model path. Equal
        to the reference's for the same config and directory."""
        cfg = self.model_config
        key = f"{cfg.name}:{xxh64(repr(cfg).encode()):016x}"
        if self.model_path:
            key += f":{checkpoint_digest(self.model_path)}"
        return key

    def _params_template(self) -> Transformer:
        """The weights' names, shapes and dtypes, on the meta device."""
        if self._template is None:
            self._template = init_params(self.model_config, device="meta")
        return self._template

    def _params_from_flat(self, flat, source: str) -> Optional[Transformer]:
        """Check a fetched flat tree against the template and rebuild it
        (its leaves where the rung put them: the host, or the card for the
        service); None on a mismatch (the caller takes the next rung)."""
        from ..weights.client import unflatten_like

        try:
            params = unflatten_like(self._params_template(), flat)
        except KeyError as exc:
            log.warning("%s weights mismatch (%s); ignoring", source, exc)
            return None
        self.weights_source = source
        return params

    async def _resolve_params(self) -> tuple:
        """The arrival ladder, as the reference's: weight service (crash
        survival) -> striped peer pull -> single-peer stream -> G4 object
        store -> checkpoint -> init (None: the runner draws). A rung that
        misses is logged and the next one tried. Returns (params, the
        service client or None)."""
        params = None
        client = None
        if self._weight_service:
            from ..weights import WeightClient

            client = WeightClient(self._weight_service)
            # straight from the shared memory to the card
            flat = await asyncio.to_thread(client.fetch, self._weights_key(),
                                           self.device)
            if flat is not None:
                params = self._params_from_flat(flat, "service")
            else:
                log.info("weight service has no %s", self._weights_key())
        if (params is None and self._weights_from_peer
                and self.runtime is not None):
            if env("DYNT_WEIGHT_STRIPE"):
                from ..weights.striped import pull_weights_striped

                flat = await pull_weights_striped(
                    self.runtime, self.card.namespace, self.card.component,
                    expected_key=self._weights_key(),
                    max_donors=int(env("DYNT_WEIGHT_STRIPE_DONORS")))
                if flat is not None:
                    params = self._params_from_flat(flat, "peer_striped")
            if params is None:
                from ..weights.streaming import pull_weights

                flat = await pull_weights(self.runtime, self.card.namespace,
                                          self.card.component,
                                          expected_key=self._weights_key())
                if flat is not None:
                    params = self._params_from_flat(flat, "peer")
        if params is None and env("DYNT_WEIGHT_STORE"):
            # No live peer serves this model: the object store is the last
            # fast rung before the checkpoint read.
            from ..weights.objstore import (
                fetch_weights_from_store,
                make_store_client,
            )

            flat = await asyncio.to_thread(
                fetch_weights_from_store,
                make_store_client(env("DYNT_WEIGHT_STORE")),
                self._weights_key())
            if flat is not None:
                params = self._params_from_flat(flat, "object_store")
        if params is None and self.model_path:
            # The checkpoint: errors are fatal — a worker given a model
            # path never falls back to random weights.
            log.info("loading checkpoint from %s ...", self.model_path)
            params = await asyncio.to_thread(
                load_params, self.model_path, self.model_config,
                device=self.device)
            self.weights_source = "checkpoint"
        return params, client

    def _publish_forward(self, client) -> None:
        """Publish the resolved weights to the service and the store for
        the next arrival: best-effort, on a thread, off the startup path."""
        store_root = env("DYNT_WEIGHT_STORE")
        to_service = client is not None and self.weights_source != "service"
        to_store = bool(store_root) and self.weights_source != "object_store"
        if not (to_service or to_store):
            return
        key = self._weights_key()
        model = self.runner.model

        def publish() -> None:
            try:
                if to_service:
                    client.store(key, model)
            except Exception:  # noqa: BLE001 — crash survival is
                # best-effort; serving continues without it
                log.exception("weight publish failed")
            if not to_store:
                return
            try:
                from ..weights.objstore import (
                    make_store_client,
                    publish_weights_to_store,
                    weights_prefix,
                )

                store = make_store_client(store_root)
                if not store.exists(f"{weights_prefix(key)}/manifest.json"):
                    publish_weights_to_store(store, key,
                                             flatten_params(model))
            except Exception:  # noqa: BLE001 — store convergence is
                # best-effort; peers still serve the striped pull
                log.exception("object-store weight publish failed")

        self._publish_task = asyncio.create_task(asyncio.to_thread(publish))

    def rederive_identity(self) -> None:
        """A fresh instance identity after a snapshot restore: clones of a
        dumped process must not share instance ids (cards would clobber, KV
        event streams interleave). Call before serve(); nothing has been
        published at the dump point."""
        self.instance_id = new_instance_id()
        self.events.worker_id = self.instance_id
        self.events.local_index.worker_id = self.instance_id

    def close(self) -> None:
        """Stop the scheduler thread, then the KVBM's threads (`shutdown`
        first when serving)."""
        if self.scheduler is not None:
            self.scheduler.stop()
        if self.kvbm is not None:
            self.kvbm.close()

    async def serve(self, runtime=None) -> None:
        """Register `generate`, `clear_kv_blocks`, `kv_blocks`, `kv_pull`,
        `drain` and `weights` (and with adapter slots `lora_load`,
        `lora_unload` and `lora_list`, then load the startup adapters) on
        `runtime`'s request plane (a DistributedRuntime; default the one
        `prepare` was given), publish the card, and start publishing KV
        events and load metrics on its event plane: the ladder's `register`
        rung."""
        t_register = time.monotonic()
        if runtime is not None:
            self.runtime = runtime
        component = (self.runtime.namespace(self.card.namespace)
                     .component(self.card.component))
        canary = PreprocessedRequest(
            request_id="_canary", token_ids=[0],
            sampling=SamplingOptions(max_tokens=1, temperature=0.0),
            stop=StopConditions(), annotations={"canary": True}).to_wire()
        # kv_pull and drain are served in every mode: a drain parks live
        # decode sequences' pages, and the handoff's destination pulls them
        for name, handler, payload in (
                ("generate", self.generate, canary),
                ("clear_kv_blocks", self._clear_kv, None),
                ("kv_blocks", self._kv_blocks, None),
                ("kv_pull", self._kv_pull, None),
                ("drain", self._drain_endpoint, None),
                ("weights", self._stream_weights, None)):
            self._served.append(await component.endpoint(name).serve_endpoint(
                handler, instance_id=self.instance_id,
                health_check_payload=payload))
        if self.loras is not None:
            self.card.runtime_config["lora"] = {
                "max_loras": self.runner_config.max_loras,
                "rank": self.runner_config.lora_rank,
            }
            for name, handler in (("lora_load", self._lora_load),
                                  ("lora_unload", self._lora_unload),
                                  ("lora_list", self._lora_list)):
                self._served.append(await component.endpoint(
                    name).serve_endpoint(handler,
                                         instance_id=self.instance_id))
            for name, path in self._initial_loras.items():
                await self.load_adapter(name, path)
        if getattr(self.runtime, "status_server", None) is not None:
            self.runtime.status_server.register_drain(self.drain)
        set_drain_state(self.instance_id, SERVING)
        await publish_card(self.runtime, self.card, self.instance_id)
        publisher = self.runtime.event_publisher(self.card.namespace)
        self._publisher = publisher
        if hasattr(publisher, "set_snapshot_fn"):
            # Durable journal plane: rotations seed the new generation
            # with this worker's full index instead of the old history.
            publisher.set_snapshot_fn(
                lambda: [(KV_SNAPSHOT_TOPIC,
                          self.events.local_index.dump())])
        self._tasks.append(asyncio.create_task(self._event_drain(publisher)))
        self.coldstart.mark("register", time.monotonic() - t_register)
        log.info("torch worker serving %s (instance=%x, device=%s, mode=%s)",
                 self.card.name, self.instance_id, self.device, self.mode)

    async def shutdown(self) -> None:
        """Unpublish the card, deregister and drain the endpoints, stop the
        event drain, then stop the scheduler."""
        if self._served:
            await unpublish_card(self.runtime, self.card, self.instance_id)
            for served in self._served:
                await served.shutdown()
            self._served = []
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        for router in self._pull_clients.values():
            await router.client.close()
        self._pull_clients = {}
        if self.kvbm is not None:
            # Drain pending offload gathers while the scheduler thread can
            # still serve run_in_gap; close() then stops both.
            await asyncio.to_thread(self.kvbm.flush, 5.0)
        self.close()

    # -- multi-LoRA ----------------------------------------------------------

    async def load_adapter(self, name: str, path: str) -> int:
        """Read and validate an adapter (off the event loop), write its slot
        on the scheduler thread between steps, and republish the card.
        Returns the slot; a failed slot write frees the name again."""
        adapter = await asyncio.to_thread(self.loras.load, name, path)
        q = self.scheduler.run_in_step(
            lambda: self.runner.set_lora_slot(adapter.slot, adapter))
        _, exc = await asyncio.to_thread(q.get)
        if exc is not None:
            self.loras.unload(name)
            raise exc
        await self._republish_loras()
        return adapter.slot

    async def _republish_loras(self) -> None:
        """Advertise the loaded adapters on the card, so frontends route
        `model=<adapter>` here; published once the worker serves."""
        self.card.runtime_config["loras"] = self.loras.names()
        if self._served and self.runtime is not None:
            await publish_card(self.runtime, self.card, self.instance_id)

    async def _lora_load(self, body: dict, ctx=None) -> AsyncIterator[dict]:
        try:
            name = body["name"]
            slot = await self.load_adapter(name, body["path"])
        except Exception as exc:  # noqa: BLE001 — reported, the endpoint
            # keeps serving
            yield {"error": str(exc)}
            return
        yield {"ok": True, "name": name, "slot": slot}

    async def _lora_unload(self, body: dict, ctx=None) -> AsyncIterator[dict]:
        """Two-phase unload: unmap the name (new requests fail fast, the
        slot stays reserved), then on the scheduler thread refuse while any
        sequence still uses the slot (live, waiting or parked): zeroing it,
        or a later load reusing it, would switch weights under a stream.
        Busy: the unload is aborted and the caller retries later."""
        try:
            name = body["name"]
            adapter = self.loras.begin_unload(name)
        except Exception as exc:  # noqa: BLE001
            yield {"error": str(exc)}
            return

        def clear() -> None:
            busy = self.scheduler.lora_in_flight(adapter.slot)
            if busy:
                raise RuntimeError(
                    f"adapter {name!r} busy: {busy} in-flight sequence(s); "
                    "retry after they finish")
            self.runner.clear_lora_slot(adapter.slot)

        _, exc = await asyncio.to_thread(
            self.scheduler.run_in_step(clear).get)
        if exc is not None:
            self.loras.abort_unload(adapter)
            yield {"error": str(exc)}
            return
        self.loras.commit_unload(adapter)
        await self._republish_loras()
        yield {"ok": True, "name": name}

    async def _lora_list(self, body, ctx=None) -> AsyncIterator[dict]:
        yield {"adapters": self.loras.list()}

    async def _clear_kv(self, body, ctx) -> AsyncIterator[dict]:
        cleared = self.scheduler.pool.clear()
        self.events.on_cleared()
        yield {"cleared_blocks": len(cleared)}

    async def _kv_blocks(self, body, ctx=None) -> AsyncIterator[dict]:
        yield self.events.local_index.dump()

    async def _donor_tree(self) -> tuple:
        """Donor-side chunk tree for striped serving: every leaf gathered to
        the host once (paced — see _build_donor_tree), chunked, and cached
        for every concurrent or later puller. Single-flight: the lock only
        guards the cache check and the build task's claim; the gather runs
        unlocked and concurrent pullers await the same task."""
        key = self._weights_key()
        async with self._donor_lock:
            cache = self._donor_cache
            if cache is not None and cache[0] == key:
                return cache[1], cache[2]
            task = self._donor_task
            if (task is None or self._donor_task_key != key
                    or (task.done() and task.exception() is not None)):
                task = asyncio.create_task(self._build_donor_tree(key))
                self._donor_task = task
                self._donor_task_key = key
        # Shielded: one puller going away must not cancel the build the
        # others wait on.
        return await asyncio.shield(task)

    async def _build_donor_tree(self, key: str) -> tuple:
        """The slow half of _donor_tree. Each leaf's device-to-host copy
        rides the scheduler's dispatch/drain gap (`run_in_gap`) and the
        copies are duty-cycle paced by DYNT_WEIGHT_STREAM_BW_FRAC (a copy
        costing g seconds defers the next by g*(1/frac - 1)), so seeding a
        newcomer does not regress this donor's decode ITL."""
        from ..runtime.metrics import WEIGHT_STREAM_DEFERRED
        from ..weights.leaves import dtype_name, to_bytes
        from ..weights.striped import BandwidthBudget, WeightManifest

        budget = BandwidthBudget(env("DYNT_WEIGHT_STREAM_BW_FRAC"))
        flat = []
        for path, leaf in flatten_params(self.runner.model):
            t0 = time.monotonic()
            q = self.scheduler.run_in_gap(lambda t=leaf: t.to("cpu"))
            host, exc = await asyncio.to_thread(q.get, True, 60.0)
            if exc is not None:
                raise exc
            flat.append((path, dtype_name(host), list(host.shape),
                         to_bytes(host)))
            defer = budget.defer_after(time.monotonic() - t0)
            if defer > 0:
                WEIGHT_STREAM_DEFERRED.labels().inc(defer)
                await asyncio.sleep(defer)
        manifest = await asyncio.to_thread(WeightManifest.build_from_bytes,
                                           flat, key)
        bufs = [data for _, _, _, data in flat]
        self._donor_cache = (key, manifest, bufs)
        return manifest, bufs

    async def _stream_weights(self, body, ctx=None) -> AsyncIterator[dict]:
        """Serve this replica's weights to a cold peer. The body multiplexes
        three shapes (the `weights/striped.py` wire protocol):

          {}                           the single-peer full stream
          {"weights_manifest": true}   striped: one manifest frame
          {"weights_chunks": [cid..]}  striped: digest-stamped chunk frames

        Every device-to-host copy and byte slice runs off the event loop, so
        multi-GB copies never stall it mid-token-stream."""
        from ..weights.streaming import encode_param_chunks, manifest_frame

        body = body or {}
        if body.get("weights_manifest") or "weights_chunks" in body:
            from ..weights.striped import encode_chunk_frames

            try:
                manifest, bufs = await self._donor_tree()
            except Exception as exc:  # noqa: BLE001 — report to the
                # puller (it falls down the ladder), keep serving
                log.exception("donor chunk tree build failed")
                yield {"error": f"donor tree build failed: {exc!r}"}
                return
            if body.get("weights_manifest"):
                yield manifest.to_wire()
                return
            frames = encode_chunk_frames(
                manifest, bufs, [int(c) for c in body["weights_chunks"]])
            while True:
                frame = await asyncio.to_thread(next, frames, None)
                if frame is None:
                    return
                yield frame
        flat = flatten_params(self.runner.model)
        yield manifest_frame(self._weights_key(), len(flat))
        for index, (key, leaf) in enumerate(flat):
            frames = await asyncio.to_thread(
                lambda k=key, t=leaf: list(encode_param_chunks(
                    [(k, t.to("cpu"))])))
            for frame in frames:
                frame["total_params"] = len(flat)
                frame["index"] = index
                yield frame

    def _load_metrics(self) -> LoadMetrics:
        pool = self.scheduler.pool
        stats = self.scheduler.stats
        active, waiting = self.scheduler.queue_depth()
        return LoadMetrics(
            worker_id=self.instance_id,
            active_blocks=pool.num_pages - 1 - pool.free_count(),
            total_blocks=pool.num_pages,
            active_requests=active,
            waiting_requests=waiting,
            kv_usage=pool.usage(),
            step_wall_ms=stats.last_step_wall_ms,
            prefill_tokens_in_step=stats.prefill_tokens_last_step,
            decode_tokens_in_step=stats.decode_tokens_last_step,
            device_ms_in_step=stats.device_ms_last_step,
            host_ms_in_step=stats.host_ms_last_step,
            draining=self.draining,
        )

    def publish_steptrace_metrics(self) -> None:
        """Publish the device-time attribution (perf/steptrace.py): the
        per-step device / host histograms of the samples committed since the
        last call, the host-bound verdict, and the live MFU and roofline
        fraction of the interval's work against the analytical model."""
        trace = self.scheduler.steptrace
        worker = f"{self.instance_id:x}"
        for sample in trace.drain_samples():
            for phase, ms in sample.device_by_phase.items():
                rt_metrics.STEP_DEVICE_MS.labels(phase=phase).observe(ms)
            rt_metrics.STEP_HOST_MS.labels(phase=sample.kind).observe(
                sample.host_ms)
        rt_metrics.HOST_BOUND.labels(worker=worker).set(
            1.0 if trace.host_bound else 0.0)
        if self._roofline is None:
            wb = {"int8": 1.0, "int4": 0.53125}.get(
                self.runner_config.weight_dtype, 2.0)
            self._roofline = LiveRoofline(
                self.model_config, num_chips=1, weight_bytes_per_param=wb,
                kv_dtype_bytes=1 if self.runner_config.kv_dtype == "int8"
                else 2)
        stats = self.scheduler.stats
        cur = (stats.prefill_tokens, stats.decode_tokens,
               self.runner.decode_steps, trace.device_ms_total)
        prev, self._roof_prev = self._roof_prev, cur
        if prev is None:
            return
        device_s = (cur[3] - prev[3]) / 1e3
        if device_s <= 0:
            return
        mfu, fraction = self._roofline.observe(
            prefill_tokens=cur[0] - prev[0], decode_tokens=cur[1] - prev[1],
            decode_steps=cur[2] - prev[2],
            active_kv_tokens=self.scheduler.active_kv_tokens(),
            device_s=device_s)
        rt_metrics.MFU_GAUGE.labels(worker=worker).set(mfu)
        rt_metrics.ROOFLINE_FRACTION.labels(worker=worker).set(fraction)

    async def _event_drain(self, publisher, interval: float = 0.05) -> None:
        """KV events every tick, load metrics and the step-trace metrics
        every 10th (~0.5 s), stale transfers expired every 40th (~2 s)."""
        ticks = 0
        while True:
            await asyncio.sleep(interval)
            for event in self.events.drain():
                try:
                    await publisher.publish(KV_EVENT_TOPIC, event.to_wire())
                except Exception:  # noqa: BLE001
                    log.exception("kv event publish failed")
            ticks += 1
            if ticks % 40 == 0:
                try:
                    self.transfers.expire_stale()
                except Exception:  # noqa: BLE001 — the drain task survives
                    log.exception("transfer expiry failed")
                if self.kvbm is not None:
                    try:
                        # Session pin leases die at TTL even when no new
                        # pin traffic triggers the lazy sweep.
                        self.kvbm.sweep_pins()
                    except Exception:  # noqa: BLE001 — the drain survives
                        log.exception("pin sweep failed")
            if ticks % 10 == 0:
                try:
                    self.publish_steptrace_metrics()
                except Exception:  # noqa: BLE001 — the gauges must not kill
                    # the drain task
                    log.exception("steptrace metrics publish failed")
                try:
                    await publisher.publish(LOAD_TOPIC,
                                            self._load_metrics().to_wire())
                except Exception:  # noqa: BLE001
                    log.exception("load metrics publish failed")

    # -- disaggregation: the owner's side (prefill legs, drain handoffs) ---

    def _transfer_params(self, transfer_id: str, layout: KvLayoutDescriptor,
                         prompt_len: int, streaming: bool = False) -> dict:
        params = {
            "transfer_id": transfer_id,
            "namespace": self.card.namespace,
            "component": self.card.component,
            "instance_id": self.instance_id,
            "layout": layout.to_wire(),
            "prompt_len": prompt_len,
        }
        if streaming:
            # no first_token yet: the pull stream's last frame carries it
            params["streaming"] = True
        if self.ici_bridge is not None:
            # decode workers in THIS process pull through the bridge; remote
            # ones take the wire
            params["bridge_token"] = self.ici_bridge.token
        return params

    def _layout(self) -> KvLayoutDescriptor:
        return KvLayoutDescriptor.from_wire(self.runner.kv_layout())

    def _register_transfer(self, seq, first_token: int,
                           page_ids: list[int]) -> dict:
        """Scheduler thread, when a prefill-only sequence finishes its
        prompt pass: park its pages with the transfer table and describe the
        pull route. A streamed sequence finishes its StreamingTransfer
        instead of opening a new one."""
        layout = self._layout()
        stream = self._stream_transfers.pop(seq.request.request_id, None)
        if stream is not None:
            stream.finish(first_token, page_ids)
            return {**self._transfer_params(stream.transfer_id, layout,
                                            seq.prompt_len, streaming=True),
                    "first_token": first_token}
        transfer_id = uuid.uuid4().hex
        self.transfers.add(PendingTransfer(
            transfer_id=transfer_id, page_ids=page_ids,
            release=lambda: self.scheduler.release_transfer_pages(seq),
            layout=layout, prompt_len=seq.prompt_len))
        return self._transfer_params(transfer_id, layout, seq.prompt_len)

    def _stream_transfer_chunk(self, seq, new_page_ids):
        """Scheduler thread, after each NON-final prefill chunk of a
        prefill-only sequence: park the newly completed pages with a
        StreamingTransfer, so the decode worker pulls chunk i while chunk
        i+1 computes. The first call registers the transfer and returns the
        params the scheduler emits mid-stream; `new_page_ids=None` is the
        abort signal (cancel or error before the prompt finished)."""
        rid = seq.request.request_id
        if new_page_ids is None:
            stream = self._stream_transfers.pop(rid, None)
            if stream is not None:
                stream.fail()
            return None
        DISAGG_STREAMED_PAGES.labels(
            worker=f"{self.instance_id:x}").inc(len(new_page_ids))
        stream = self._stream_transfers.get(rid)
        if stream is not None:
            stream.append_pages(new_page_ids)
            return None
        layout = self._layout()
        stream = StreamingTransfer(
            transfer_id=uuid.uuid4().hex,
            page_ids=[int(p) for p in new_page_ids],
            release=lambda: self.scheduler.release_transfer_pages(seq),
            layout=layout, prompt_len=seq.prompt_len, table=self.transfers)
        self._stream_transfers[rid] = stream
        self.transfers.add(stream)
        return self._transfer_params(stream.transfer_id, layout,
                                     seq.prompt_len, streaming=True)

    async def _gather_to_host(self, page_ids: list[int], run) -> object:
        """The pages' bundle on the host: the device gather on the scheduler
        thread through `run` (run_in_step or run_in_gap), the copy off it."""
        q = run(lambda: self.runner.gather_pages_device(page_ids))
        # bounded: a scheduler shutting down still runs queued callbacks,
        # but the handler never hangs on a wedged one
        bundle, exc = await asyncio.to_thread(q.get, True, 60.0)
        if exc is not None:
            raise exc
        return await asyncio.to_thread(self.runner.bundle_to_host, bundle)

    async def _kv_pull(self, body: dict, ctx=None) -> AsyncIterator[dict]:
        """A peer pulls parked pages here: the claim removes the entry (the
        TTL can no longer release pages a gather reads), the pages are
        gathered and streamed as chunked binary frames, and the claimer
        releases them once, however the stream ends."""
        transfer_id = (body or {}).get("transfer_id", "")
        transfer = self.transfers.claim(transfer_id)
        if transfer is None:
            yield {"error": f"unknown transfer {transfer_id}"}
            return
        try:
            if transfer.streaming:
                async for frame in self._stream_kv_pull(transfer, ctx):
                    yield frame
                return
            try:
                blocks = await self._gather_to_host(
                    transfer.page_ids, self.scheduler.run_in_step)
            except Exception as exc:  # noqa: BLE001 — an error frame; the
                # puller recomputes
                yield {"error": f"gather failed: {exc!r}"}
                return
            for frame in encode_block_chunks(blocks, transfer.layout):
                yield frame
        finally:
            transfer.release()

    async def _stream_kv_pull(self, transfer: StreamingTransfer,
                              ctx) -> AsyncIterator[dict]:
        """Serve a streaming transfer: gather and send each chunk's pages as
        the scheduler parks them, then a last frame with the first sampled
        token. The gathers ride the scheduler's dispatch/drain gap
        (run_in_gap)."""
        layout = transfer.layout
        total = transfer.total_pages
        deadline = getattr(ctx, "deadline", None)
        budget = deadline.remaining() if deadline is not None else None
        if budget is not None and budget <= 0:
            yield {"error": "request deadline expired before streaming kv "
                            "pull"}
            return
        # A deadline bounds the whole pull; without one, a 120 s stall
        # window re-armed on every chunk of progress.
        overall = time.monotonic() + max(1.0, budget if budget is not None
                                         else 120.0)
        sent = 0
        while True:
            ids, done, failed = await asyncio.to_thread(
                transfer.wait_ready, sent, 1.0)
            if failed:
                yield {"error": f"transfer {transfer.transfer_id} aborted "
                                "(prefill cancelled)"}
                return
            new = ids[sent:]
            if not new and not done:
                if time.monotonic() > overall:
                    yield {"error": "streaming transfer timed out awaiting "
                                    "prefill chunks"}
                    return
                continue
            if new:
                if budget is None:
                    overall = time.monotonic() + 120.0
                try:
                    blocks = await self._gather_to_host(
                        new, self.scheduler.run_in_gap)
                except Exception as exc:  # noqa: BLE001 — an error frame
                    yield {"error": f"gather failed: {exc!r}"}
                    return
                for frame in encode_block_chunks(blocks, layout, base=sent,
                                                 total_pages=total):
                    yield frame
                sent += len(new)
            if done and sent >= len(ids):
                yield {"done": True, "first_token": transfer.first_token,
                       "total_pages": total}
                return

    # -- disaggregation: the puller's side ---------------------------------

    async def _pull_remote_kv(self, params: dict, request_id: str = "",
                              deadline=None, record_id: Optional[str] = None):
        """Pull parked pages from their owner. Returns (bundle, first_token)
        with the bundle staged on this runner's device, or (None, None)
        when the pull or its assembly fails (the caller recomputes, or, for
        a drain handoff, replays). A streamed handoff's first token comes in
        the pull stream's last frame. `deadline` is the request's remaining
        end-to-end budget. The link is `ici` when the params carry this
        worker's own bridge token (the pages move device to device), else
        `dcn` (the host relay: kv_pull frames over the request plane); a
        pull that lands puts a `kv_pull` event naming its link and its split
        on the `record_id` timeline."""
        if params.get("mock") or "layout" not in params:
            return None, None  # a mocker handoff carries no data
        if (self.ici_bridge is not None
                and params.get("bridge_token") == self.ici_bridge.token):
            return await self._pull_bridge(params, request_id, record_id)
        remote = KvLayoutDescriptor.from_wire(params["layout"])
        local = self._layout()
        if not remote.compatible(local):
            log.warning("kv layout mismatch (remote=%s local=%s); "
                        "recomputing", remote, local)
            return None, None
        subject = f"{params['namespace']}/{params['component']}/kv_pull"
        router = self._pull_clients.get(subject)
        if router is None:
            endpoint = (self.runtime.namespace(params["namespace"])
                        .component(params["component"]).endpoint("kv_pull"))
            router = PushRouter(endpoint.client(), mode="round_robin")
            await router.client.start()
            self._pull_clients[subject] = router
        assembler = BlockAssembler()
        pulled_bytes = 0
        first_token = None
        start = time.monotonic()
        t_first = None  # the first page frame's arrival
        t_last = None  # the last page frame's
        try:
            async with contextlib.aclosing(router.generate(
                    {"transfer_id": params["transfer_id"]},
                    instance_id=params["instance_id"],
                    deadline=deadline)) as stream:
                async for frame in stream:
                    if frame.get("error"):
                        log.warning("kv pull failed: %s", frame["error"])
                        return None, None
                    if frame.get("done"):
                        first_token = frame.get("first_token")
                        continue
                    t_last = time.monotonic()
                    t_first = t_first or t_last
                    pulled_bytes += len(frame.get("data") or b"")
                    assembler.add(frame)
            if not assembler.complete:
                log.warning("kv pull incomplete; recomputing")
                return None, None
            t_frames = time.monotonic()
            blocks, _ = assembler.assemble()
        except Exception:  # noqa: BLE001 — a transport or assembly failure
            log.exception("kv pull failed; recomputing")
            return None, None
        pull_s = time.monotonic() - start
        # Stage the upload here, off the step thread: admission's scatter
        # then only does the indexed write.
        t0 = time.monotonic()
        staged = await asyncio.to_thread(self._stage, blocks)
        # pull_ms: the request to the assembled bundle; of it, wait_ms until
        # the first page frame (a streamed pull waits on the prefill there),
        # frames_ms from the first page frame to the last, and assemble_ms
        # the host assembly; then stage_ms the upload
        record = {
            "request_id": request_id, "transfer_id": params["transfer_id"],
            "link": "dcn", "bytes": pulled_bytes,
            "pages": int(blocks.shape[0]), "pull_ms": pull_s * 1e3,
            "wait_ms": ((t_first or t_frames) - start) * 1e3,
            "frames_ms": ((t_last or t_frames) - (t_first or t_frames)) * 1e3,
            "assemble_ms": (t0 - t_frames) * 1e3,
            "stage_ms": (time.monotonic() - t0) * 1e3}
        self._record_pull(record, record_id)
        if first_token is None:
            first_token = params.get("first_token")
        return staged, first_token

    async def _pull_bridge(self, params: dict, request_id: str,
                           record_id: Optional[str]):
        """The `ici` link: the pages through this process's bridge, device
        to device (engine/ici_transfer.py); (None, None) recomputes."""
        timings: dict = {}
        start = time.monotonic()
        bundle, first_token = await self.ici_bridge.pull(
            params["transfer_id"], self.runner, timings=timings)
        if bundle is None:
            return None, None
        tensor = bundle.tensor
        # pull_ms: the claim to the bundle complete on this device; of it,
        # wait_ms until the first pages were ready, gather_ms waiting on the
        # prefill scheduler's gathers, copy_ms joining and completing it
        self._record_pull({
            "request_id": request_id, "transfer_id": params["transfer_id"],
            "link": "ici", "bytes": tensor.numel() * tensor.element_size(),
            "pages": int(tensor.shape[0]),
            "pull_ms": (time.monotonic() - start) * 1e3, **timings},
            record_id)
        if first_token is None:
            first_token = params.get("first_token")
        return bundle, first_token

    def _record_pull(self, record: dict, record_id: Optional[str]) -> None:
        """Keep a landed pull's record and put it on the request's timeline
        as a `kv_pull` event (its link, bytes, pages, duration_ms and the
        split)."""
        self.pulls.append(record)
        split = {k: round(v, 3) for k, v in record.items()
                 if k.endswith("_ms") and k != "pull_ms"}
        get_recorder().event(
            record_id, "kv_pull", link=record["link"],
            transfer_id=record["transfer_id"], bytes=record["bytes"],
            pages=record["pages"], duration_ms=round(record["pull_ms"], 3),
            **split)

    def _stage(self, blocks):
        """Upload a pulled bundle and wait for it (a worker thread)."""
        staged = self.runner.stage_bundle(blocks)
        if staged.ready is not None:
            staged.ready.synchronize()
        return staged

    # -- graceful drain (engine/drain.py) -----------------------------------

    async def announce_draining(self) -> None:
        """Flip this worker to draining where routers look: its card
        (runtime_config) and an immediate LoadMetrics publish (the next
        ~0.5 s tick would leave a window where routers still pick it)."""
        self.draining = True
        self.card.runtime_config["draining"] = True
        if self.runtime is None:
            return
        try:
            await publish_card(self.runtime, self.card, self.instance_id)
        except Exception:  # noqa: BLE001 — LoadMetrics still flips
            # routers; lease expiry is the backstop
            log.exception("draining card republish failed")
        if self._publisher is not None:
            try:
                await self._publisher.publish(
                    LOAD_TOPIC, self._load_metrics().to_wire())
            except Exception:  # noqa: BLE001
                log.exception("draining load publish failed")

    def register_drain_handoff(self, seq, page_ids: list[int],
                               computed_tokens: int) -> dict:
        """Scheduler thread, from `drain_sweep`: park a live decode
        sequence's computed pages with the transfer table (kv_pull serves
        them while this worker drains) and describe the pull route and the
        resume state the destination needs."""
        layout = self._layout()
        transfer_id = uuid.uuid4().hex
        self.transfers.add(PendingTransfer(
            transfer_id=transfer_id, page_ids=[int(p) for p in page_ids],
            release=lambda: self.scheduler.release_transfer_pages(seq),
            layout=layout, prompt_len=computed_tokens))
        params = self._transfer_params(transfer_id, layout, computed_tokens)
        # Never the bridge for a drain handoff: it serves the comesh prefill
        # pool's transfers, not these, and the wire works from any peer.
        params.pop("bridge_token", None)
        params["handoff"] = {
            "seed": int(seq.seed),
            "generated": [int(t) for t in seq.generated],
            "prompt_len": int(seq.prompt_len),
        }
        return params

    async def drain(self, reason: str = "signal",
                    deadline_secs: Optional[float] = None) -> dict:
        """Run (or join) the departure ladder (engine/drain.py); idempotent.
        `deadline_secs` overrides DYNT_DRAIN_DEADLINE_SECS for the call that
        starts the ladder."""
        if self._drain_coordinator is None:
            self._drain_coordinator = DrainCoordinator(
                self, deadline_secs=deadline_secs)
        return await self._drain_coordinator.drain(reason)

    async def _drain_endpoint(self, body: dict, ctx=None
                              ) -> AsyncIterator[dict]:
        """The drain verb on the request plane: run the ladder and stream
        its report. body.shutdown=true also resolves the process's shutdown
        event, so its main deregisters after the drain."""
        report = await self.drain(reason=(body or {}).get("reason",
                                                          "control"))
        try:
            yield report
        finally:
            # in a finally: a caller that closes the stream once the report
            # lands raises GeneratorExit at the yield, and the drained
            # process must still go
            if (body or {}).get("shutdown"):
                from ..runtime.signals import request_shutdown

                request_shutdown("drain control verb")

    def _pin_anchors(self, request: PreprocessedRequest, rec_id: str) -> None:
        """Session tier: lease the anchored prefix blocks against tier
        eviction (they always die at TTL) and stage any G3/G4 residents up
        into G2, so the admission-time onboard reads host RAM."""
        try:
            page = self.scheduler.page_size
            n = (max(request.cache_anchors) // page) * page
            hashes = (compute_block_hashes(request.token_ids[:n], page,
                                           lora_id=request.kv_salt())
                      if n else [])
            if hashes:
                # the client's lease TTL when the wire carries one
                # (pin_blocks clamps it to the system ceiling)
                ttl = request.cache_ttl or env("DYNT_PIN_TTL_SECS")
                self.kvbm.pin_blocks(hashes, ttl)
                self.kvbm.prefetch(hashes)
                get_recorder().event(rec_id, "session_pin",
                                     blocks=len(hashes))
        except Exception:  # noqa: BLE001 — pinning is a cache hint; a
            # failure degrades to normal eviction order
            log.exception("session pin failed for %s", request.request_id)

    async def generate(self, body: dict, ctx=None) -> AsyncIterator[dict]:
        request = PreprocessedRequest.from_wire(body)
        current_request_id.set(request.request_id)
        if request.annotations.get("embed"):
            # An embedding: the trunk-only pooled forward, serialized with
            # the engine's steps on the scheduler thread (no KV involved)
            tokens = np.asarray(request.token_ids, np.int32)
            q = self.scheduler.run_in_step(lambda: self.runner.embed(tokens))
            vec, exc = await asyncio.to_thread(q.get)
            if exc is not None:
                yield EngineOutput(finish_reason="error",
                                   error=str(exc)).to_wire()
                return
            yield EngineOutput(
                finish_reason="stop", prompt_tokens=len(request.token_ids),
                embedding=[float(x) for x in vec]).to_wire()
            return
        prefill_only = (self.mode == "prefill"
                        or bool(request.annotations.get("prefill_only")))
        canary = bool(request.annotations.get("canary"))
        recorder = get_recorder()
        # A prefill leg reuses the decode request's id: qualify its record
        # key, so both legs keep their own timeline when the pools share a
        # process (comesh). Canary probes never open a timeline.
        rec_id = (f"{request.request_id}#prefill" if prefill_only
                  else request.request_id)
        if not canary:
            recorder.start(rec_id, model=request.model)
        status = "error"
        try:
            loop = asyncio.get_running_loop()
            out_queue: asyncio.Queue = asyncio.Queue()

            def emit(output: EngineOutput) -> None:
                loop.call_soon_threadsafe(out_queue.put_nowait, output)

            if request.cache_anchors and self.kvbm is not None:
                self._pin_anchors(request, rec_id)
            submit_kwargs: dict = {}
            if prefill_only:
                submit_kwargs.update(prefill_only=True,
                                     on_prefill_done=self._register_transfer)
                if self.disagg_pipeline > 0:
                    submit_kwargs["on_prefill_chunk"] = (
                        self._stream_transfer_chunk)
            elif request.disaggregated_params:
                handoff = request.disaggregated_params.get("handoff")
                blocks, first_token = await self._pull_remote_kv(
                    request.disaggregated_params, request.request_id,
                    deadline=getattr(ctx, "deadline", None),
                    record_id=rec_id)
                if handoff is not None:
                    if blocks is None:
                        # A drain handoff cannot fall through to a plain
                        # submit (that re-emits the whole stream over tokens
                        # the client has): bounce with a plain migrate, the
                        # replay rung.
                        log.warning("drain handoff pull failed for %s; "
                                    "bouncing to replay", request.request_id)
                        yield EngineOutput(
                            finish_reason="migrate",
                            error="drain handoff pull failed; replay"
                        ).to_wire()
                        return
                    submit_kwargs.update(onboard_blocks=blocks,
                                         resume_state=handoff)
                elif blocks is not None and first_token is not None:
                    submit_kwargs.update(onboard_blocks=blocks,
                                         onboard_first_token=first_token)
                # else: a plain submit recomputes the prefill
            if request.lora_name:
                # Resolve the slot after every await above: submit() runs in
                # the same event-loop step, so lora_in_flight's drain of the
                # incoming queue cannot miss a resolved sequence (a suspend
                # between the two would let a concurrent unload free the
                # slot, and a load repurpose it).
                slot = (self.loras.slot_of(request.lora_name)
                        if self.loras is not None else None)
                if slot is None:
                    yield EngineOutput(
                        finish_reason="error",
                        error=f"adapter {request.lora_name!r} not loaded here",
                    ).to_wire()
                    return
                submit_kwargs["lora_idx"] = slot
            recorder.stamp(rec_id, "queued")
            handle = self.scheduler.submit(
                request, emit, record_id=None if canary else rec_id,
                **submit_kwargs)
            try:
                saw_error = False
                while True:
                    output: EngineOutput = await out_queue.get()
                    saw_error = saw_error or output.error is not None
                    if (self.coldstart.total is None and not canary
                            and output.error is None):
                        # the first served token closes the arrival ladder
                        self.coldstart.first_token()
                    if output.finish_reason is not None:
                        status = "error" if saw_error else "ok"
                        yield output.to_wire()
                        return
                    yield output.to_wire()
            finally:
                handle.cancel()
        except asyncio.CancelledError:
            # a deadline watchdog's cancel, or the client went away
            status = "cancelled"
            deadline = getattr(ctx, "deadline", None)
            if deadline is not None and deadline.expired():
                status = "deadline_exceeded"
            raise
        except GeneratorExit:
            # the stream was closed by its consumer: an ordinary cancel, not
            # an error (keep "ok" when the close raced the final frame)
            if status == "error":
                status = "cancelled"
            raise
        finally:
            # one exit for every path: close the timeline (a frontend in
            # this process may have closed it first)
            timeline = (recorder.finish(rec_id, status)
                        or recorder.get(rec_id))
            dev_ms = (timeline.device.get("prefill_device_ms")
                      if timeline is not None and not canary else None)
            if dev_ms:
                # the device-time TTFT: the prefill device window behind
                # this request's first token
                rt_metrics.TTFT_DEVICE_MS.labels(
                    model=request.model).observe(dev_ms)


def build_arg_parser() -> argparse.ArgumentParser:
    """The subset of the reference worker's CLI that this package serves
    (--model-ref stays refused: the model registry is not ported), plus
    --prewarm and --device. --dp is taken for its checks only: data
    parallelism is not ported, so only 1 serves."""
    parser = argparse.ArgumentParser("dynamo_tpu_torch.worker",
                                     allow_abbrev=False)
    parser.add_argument("--model", default="tiny-test",
                        help="model preset (models/config.py PRESETS)")
    parser.add_argument("--model-path", default=None,
                        help="HF checkpoint directory (config.json + "
                             "*.safetensors [+ tokenizer.json]); overrides "
                             "--model — the architecture comes from the "
                             "checkpoint's config.json")
    parser.add_argument("--served-model-name", default=None)
    parser.add_argument("--namespace", default="dynamo")
    parser.add_argument("--component", default="backend",
                        help="the endpoints' component (a prefill worker's "
                             "default is prefill)")
    parser.add_argument("--mode", default="aggregated",
                        choices=["aggregated", "prefill", "decode", "comesh"],
                        help="aggregated, or one side of disaggregated "
                             "serving: prefill (a [PREFILL] card; answers "
                             "kv_transfer_params) or decode; comesh runs a "
                             "prefill pool AND a decode pool in this process "
                             "on disjoint devices with the in-process KV "
                             "bridge")
    parser.add_argument("--prefill-devices", type=int, default=1,
                        help="comesh: devices of the prefill pool")
    parser.add_argument("--decode-devices", type=int, default=1,
                        help="comesh: devices of the decode pool")
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--page-size", type=int,
                        default=env("DYNT_KV_BLOCK_SIZE"))
    parser.add_argument("--num-pages", type=int, default=2048)
    parser.add_argument("--max-batch", type=int, default=16)
    parser.add_argument("--max-pages-per-seq", type=int, default=128)
    parser.add_argument("--weight-dtype", default="model",
                        choices=["model", "int8", "int4"],
                        help="weight storage: model dtype (bf16), W8A16 or "
                             "W4A16")
    parser.add_argument("--kv-dtype", default="model",
                        choices=["model", "int8"],
                        help="KV pool storage: model dtype or int8")
    parser.add_argument("--tool-call-parser", default=None,
                        choices=["hermes", "qwen", "mistral", "llama3_json",
                                 "pythonic", "xml", "dsml", "harmony"])
    parser.add_argument("--reasoning-parser", default=None,
                        choices=["think", "deepseek-r1", "granite",
                                 "harmony", "gpt-oss"])
    parser.add_argument("--prewarm", action="store_true",
                        help="capture the whole steady-state key space "
                             "(ModelRunner.prewarm) before publishing the "
                             "card")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--kvbm-host-blocks", type=int, default=0,
                        help="G2 host-RAM KV tier size in blocks (0=off)")
    parser.add_argument("--kvbm-disk-blocks", type=int, default=0,
                        help="G3 local-disk KV tier size in blocks (0=off)")
    parser.add_argument("--kvbm-disk-path", default="/tmp/dynamo_tpu_kvbm.bin")
    parser.add_argument("--kvbm-object-store", default=None,
                        help="G4 blob-store root (a directory, e.g. a "
                             "gcsfuse mountpoint, or an http(s):// URL)")
    parser.add_argument("--weight-service", default=None,
                        help="unix socket of a weight service (python -m "
                             "dynamo_tpu_torch.weights): re-attach its "
                             "published weights, else publish ours "
                             "(default DYNT_WEIGHT_SERVICE)")
    parser.add_argument("--weights-from-peer", action="store_true",
                        help="pull the weights from live peers serving "
                             "this component (striped across up to "
                             "DYNT_WEIGHT_STRIPE_DONORS, then one peer) "
                             "before the object store, checkpoint or init")
    parser.add_argument("--max-loras", type=int, default=0,
                        help="adapter slots for multi-LoRA serving (0=off)")
    parser.add_argument("--lora-rank", type=int, default=8,
                        help="shared slot rank (adapters with lower rank "
                             "are zero-padded)")
    parser.add_argument("--lora", action="append", default=[],
                        metavar="NAME=PATH",
                        help="adapter to load at startup (repeatable)")
    return parser


def _lora_args(specs: list[str]) -> dict[str, str]:
    """`--lora NAME=PATH` values as {name: path}."""
    try:
        return dict(spec.split("=", 1) for spec in specs)
    except ValueError:
        raise SystemExit(f"--lora takes NAME=PATH, got {specs!r}") from None


async def main(argv: Optional[list[str]] = None) -> None:
    from ..runtime import DistributedRuntime, HealthCheckManager, RuntimeConfig
    from ..runtime.signals import wait_for_shutdown_signal
    from ..runtime.snapshot import SnapshotController

    args = build_arg_parser().parse_args(argv)
    component = args.component
    if args.mode == "prefill" and component == "backend":
        component = "prefill"
    if args.kv_dtype == "int8" and args.mode != "aggregated":
        # As the reference: a drain handoff moves packed int8 bundles, but
        # the disaggregated pools stay model-dtype.
        raise SystemExit("--kv-dtype int8 supports aggregated serving; "
                         "disaggregated prefill/decode pools still require "
                         "kv-dtype=model")
    if args.mode == "comesh":
        if env("DYNT_SNAPSHOT_MODE") == "dump":
            raise SystemExit(
                "--mode comesh does not support snapshot-gated startup "
                "(two engines, one dump point); unset DYNT_SNAPSHOT_MODE")
        # the pools ARE the device split
        if args.dp != 1:
            raise SystemExit("--dp is not meaningful with --mode comesh; "
                             "size the pools with --prefill-devices/"
                             "--decode-devices")
    elif args.dp != 1:
        raise SystemExit("--dp > 1 is not ported: one engine a worker")
    device = resolve_device(args.device)  # no card: raise before building
    kvbm_config = None
    if args.kvbm_host_blocks > 0:
        kvbm_config = KvbmConfig(
            host_blocks=args.kvbm_host_blocks,
            disk_blocks=args.kvbm_disk_blocks,
            disk_path=args.kvbm_disk_path,
            object_store_root=args.kvbm_object_store)
    if args.mode == "comesh":
        # On the CPU the host stands in for every device a pool asks for.
        try:
            pools = split_devices(
                args.prefill_devices, args.decode_devices,
                devices=([device] * (args.prefill_devices
                                     + args.decode_devices)
                         if device.type == "cpu" else None))
        except ValueError as exc:
            raise SystemExit(str(exc)) from exc
        await _comesh_main(args, pools)
        return
    # Snapshot-gated startup (runtime/snapshot.py): the engine is prepared
    # with no runtime connection open, then the ready marker, the wait for
    # the restore marker, a fresh identity, and only then a runtime
    snapshot = SnapshotController()
    runtime = (None if snapshot.enabled
               else await DistributedRuntime(RuntimeConfig.from_env()).start())
    worker: Optional[TorchWorker] = None
    health: Optional[HealthCheckManager] = None
    try:
        # in a thread: loading a checkpoint takes seconds
        worker = await asyncio.to_thread(
            TorchWorker, args.model,
            RunnerConfig(page_size=args.page_size, num_pages=args.num_pages,
                         max_batch=args.max_batch,
                         max_pages_per_seq=args.max_pages_per_seq,
                         weight_dtype=args.weight_dtype,
                         kv_dtype=args.kv_dtype, max_loras=args.max_loras,
                         lora_rank=args.lora_rank),
            model_path=args.model_path, served_name=args.served_model_name,
            device=device, namespace=args.namespace,
            component=component, tool_parser=args.tool_call_parser,
            reasoning_parser=args.reasoning_parser, mode=args.mode,
            kvbm_config=kvbm_config,
            weight_service=(args.weight_service
                            or env("DYNT_WEIGHT_SERVICE") or None),
            weights_from_peer=args.weights_from_peer,
            lora_adapters=_lora_args(args.lora))
        await worker.prepare(runtime, prewarm=args.prewarm)
        if snapshot.enabled:
            snapshot.engine_ready()
            await snapshot.wait_for_restore()
            worker.rederive_identity()  # clones must not share an id
            # The reference also records the restored snapshot in its
            # deploy registry; the port has no registry yet.
            log.info("snapshot restored; no registry record is written")
            runtime = await DistributedRuntime(
                RuntimeConfig.from_env()).start()
        await worker.serve(runtime)
        health = HealthCheckManager(
            runtime, canary_wait_time=env("DYNT_CANARY_WAIT_SECS"))
        health.start()
        await wait_for_shutdown_signal()
        # The departure ladder before teardown: live streams hand their KV
        # to peers (or replay) instead of dying with the endpoints.
        try:
            await worker.drain("shutdown-signal")
        except Exception:  # noqa: BLE001 — teardown proceeds regardless
            log.exception("graceful drain failed")
    finally:
        if health is not None:
            await health.close()
        if worker is not None:
            await worker.shutdown()
        if runtime is not None:
            await runtime.shutdown()


async def _comesh_main(args, pools) -> None:
    """Co-located disaggregation: one process, a prefill worker and a decode
    worker on disjoint devices (`split_devices`), the prompt's pages handed
    over through one IciKvBridge. A frontend orchestrates as with remote
    pools; the bridge token in kv_transfer_params selects the device path.
    POST /drain and SIGTERM vacate BOTH workers through one composed drain:
    decode first (live streams hand off or replay), then prefill (its
    transfers are being pulled), under ONE DYNT_DRAIN_DEADLINE_SECS budget."""
    from ..runtime import DistributedRuntime, HealthCheckManager, RuntimeConfig
    from ..runtime.signals import wait_for_shutdown_signal
    from .ici_transfer import IciKvBridge

    (prefill_device,), (decode_device,) = pools
    runtime = await DistributedRuntime(RuntimeConfig.from_env()).start()
    bridge = IciKvBridge()
    rc = RunnerConfig(page_size=args.page_size, num_pages=args.num_pages,
                      max_batch=args.max_batch,
                      max_pages_per_seq=args.max_pages_per_seq,
                      weight_dtype=args.weight_dtype,
                      kv_dtype=args.kv_dtype, max_loras=args.max_loras,
                      lora_rank=args.lora_rank)
    common = dict(model_path=args.model_path,
                  served_name=args.served_model_name,
                  namespace=args.namespace,
                  tool_parser=args.tool_call_parser,
                  reasoning_parser=args.reasoning_parser, ici_bridge=bridge,
                  lora_adapters=_lora_args(args.lora))
    workers: list[TorchWorker] = []
    health: Optional[HealthCheckManager] = None
    try:
        for mode, component, device in (
                ("prefill", "prefill", prefill_device),
                ("decode", args.component, decode_device)):
            # in a thread: loading a checkpoint takes seconds
            worker = await asyncio.to_thread(
                TorchWorker, args.model, rc, device=device, mode=mode,
                component=component, **common)
            workers.append(worker)
            await asyncio.to_thread(worker.runner.prewarm if args.prewarm
                                    else worker.runner.warmup)
            worker.scheduler.start()
        for worker in workers:
            await worker.serve(runtime)
        prefill_worker, decode_worker = workers

        async def drain_both(reason: str = "control") -> dict:
            budget = float(env("DYNT_DRAIN_DEADLINE_SECS"))
            t0 = time.monotonic()
            report: dict = {}
            for label, w in (("decode", decode_worker),
                             ("prefill", prefill_worker)):
                try:
                    report[label] = await w.drain(
                        reason, deadline_secs=max(
                            1.0, budget - (time.monotonic() - t0)))
                except Exception:  # noqa: BLE001 — one worker's failed drain
                    # must not skip the other's, or teardown
                    log.exception("graceful drain failed (%s)", label)
                    report[label] = {"error": "drain failed; see log"}
            return report

        # the workers' own registrations are last-wins: this one replaces
        # them
        if getattr(runtime, "status_server", None) is not None:
            runtime.status_server.register_drain(drain_both)
        health = HealthCheckManager(
            runtime, canary_wait_time=env("DYNT_CANARY_WAIT_SECS"))
        health.start()
        await wait_for_shutdown_signal()
        await drain_both("shutdown-signal")
    finally:
        if health is not None:
            await health.close()
        for worker in reversed(workers):
            await worker.shutdown()
        await runtime.shutdown()
