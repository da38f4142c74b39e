"""ModelManager + ModelWatcher: discovery-driven serving pipelines.

Port of `dynamo_tpu/llm/manager.py` (ref: lib/llm/src/discovery/
watcher.rs:68 ModelWatcher, model_manager.rs:67 ModelManager). The frontend
is not configured with workers: it watches discovery for
ModelDeploymentCards and builds a serving pipeline (preprocessor + router)
per model as worker instances come and go. When the last instance of a
model disappears, the model is unlisted. Cards of either package are served.

Every model subscribes to its namespace's event plane: load metrics feed
`worker_usage` (busy-threshold shedding) in every router mode, and in `kv`
mode KV events feed the model's radix index. A worker whose card advertises
`kv_blocks_endpoint` is bootstrapped from its local indexer when it appears,
and resynced when its event ids skip (the events that arrive meanwhile are
buffered and replayed after the dump) or when the journal skipped corrupt
frames. A worker that announces its departure, by the `draining` flag of
its card or of its load metrics, leaves routing at once: its router stops
selecting it, its radix state is dropped and its later KV events are
ignored, until its discovery record goes. Every model's engine is wrapped
in `Migration` (DYNT_MIGRATION_LIMIT), so a stream whose worker dies is
replayed on another, and every model keeps a queue-wait estimator fed by
its workers' published `waiting_requests` for deadline-aware admission.

A `[PREFILL]` card joins its model's prefill pool (`PrefillPool`, one per
model name, bound to the first endpoint subject seen); a card that is both
prefill and chat also registers as a model. Inside `Migration` each
model's engine is a `PrefillRouterEngine`, which sends every request to the
prefill pool first while the pool has a live instance and falls back to
aggregated serving when the last one goes. A draining prefill worker stops
getting new legs. Image, encoder and embedding cards are still logged and
dropped: those pools, LoRA adapters and the session tier are not ported.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging
import threading
from typing import Optional

from ..kv_router import (
    KV_EVENT_TOPIC,
    KV_SNAPSHOT_TOPIC,
    LOAD_TOPIC,
    KvRouterConfig,
    KvScheduler,
    LoadMetrics,
    RouterEvent,
    WorkerWithDpRank,
)
from ..config import env
from ..kv_router.indexer import sweep_tree
from ..runtime.admission import QueueWaitEstimator
from ..runtime.discovery import MODEL_CARD_PREFIX
from ..runtime.events import JOURNAL_RESYNC_TOPIC
from ..runtime.push_router import PushRouter
from .engine import KvRouterEngine, Migration, RouterEngine, TokenEngine
from .model_card import CHAT, COMPLETIONS, PREFILL, ModelDeploymentCard
from .prefill_router import PrefillPool, PrefillRouterEngine
from .preprocessor import OpenAIPreprocessor

log = logging.getLogger("dynamo_tpu_torch.manager")


@dataclasses.dataclass
class ModelEntry:
    card: ModelDeploymentCard
    preprocessor: OpenAIPreprocessor
    engine: TokenEngine
    router: PushRouter
    scheduler: Optional[KvScheduler] = None
    instances: set[int] = dataclasses.field(default_factory=set)
    # worker instance_id -> last published kv usage (any router mode; feeds
    # busy-threshold load shedding)
    worker_usage: dict[int, float] = dataclasses.field(default_factory=dict)
    # instance ids that announced their departure (card flag or
    # LoadMetrics.draining); cleared when the instance's record goes
    draining: set[int] = dataclasses.field(default_factory=set)
    # Deadline-aware admission (runtime/admission.py): depth from the
    # workers' published waiting_requests, drain rate from the frontend's
    # first tokens.
    wait_estimator: QueueWaitEstimator = dataclasses.field(
        default_factory=QueueWaitEstimator)

    def __post_init__(self) -> None:
        self.wait_estimator.pool = f"decode:{self.card.name}"


class ModelManager:
    """model name -> serving pipeline registry (locked: the watcher mutates
    it while HTTP handlers read it)."""

    def __init__(self) -> None:
        self._models: dict[str, ModelEntry] = {}
        self._lock = threading.Lock()

    def register(self, entry: ModelEntry) -> None:
        with self._lock:
            self._models[entry.card.name] = entry

    def unregister(self, name: str) -> None:
        with self._lock:
            self._models.pop(name, None)

    def get(self, name: str) -> Optional[ModelEntry]:
        with self._lock:
            return self._models.get(name)

    def list_models(self) -> list[ModelDeploymentCard]:
        with self._lock:
            return [e.card for e in self._models.values()]

    def entries(self) -> list[ModelEntry]:
        with self._lock:
            return list(self._models.values())


class ModelWatcher:
    """Watches v1/mdc/ and maintains the ModelManager (ref: watcher.rs
    handle_put/handle_delete)."""

    def __init__(self, runtime, manager: ModelManager,
                 router_mode: str = "round_robin",
                 kv_config: Optional[KvRouterConfig] = None) -> None:
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        self.kv_config = kv_config
        self._watch = None
        self._tasks: list[asyncio.Task] = []
        self._maintain_task: Optional[asyncio.Task] = None
        # (subject, worker_id) -> events buffered while a resync RPC is in
        # flight for that worker; replayed (ids beyond the dump) after the
        # snapshot loads, so live traffic during the RPC window can neither
        # be lost nor re-applied.
        self._resyncing: dict = {}
        # namespace -> entries fed by that namespace's event stream; the
        # list is shared with the running _event_loop so late-registered
        # models start receiving events immediately.
        self._ns_entries: dict[str, list[ModelEntry]] = {}
        # model name -> its prefill pool; endpoint subject -> model name, so
        # a lease-expiry delete drains the right pool
        self._prefill_pools: dict[str, PrefillPool] = {}
        self._prefill_subjects: dict[str, str] = {}

    async def start(self) -> None:
        self._watch = await self.runtime.discovery.watch_prefix(
            MODEL_CARD_PREFIX + "/")
        self._tasks.append(asyncio.create_task(self._watch_loop()))

    async def close(self) -> None:
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if self._watch is not None:
            await self._watch.cancel()
        for entry in self.manager.entries():
            await entry.router.client.close()
        for pool in self._prefill_pools.values():
            await pool.router.client.close()

    async def _watch_loop(self) -> None:
        async for event in self._watch:
            try:
                if event.kind == "put" and event.value:
                    await self._handle_put(event.key, event.value)
                elif event.kind == "delete":
                    await self._handle_delete(event.key)
            except Exception:  # noqa: BLE001 — watcher must survive bad cards
                log.exception("model watcher failed handling %s", event.key)

    @staticmethod
    def _parse_key(key: str) -> tuple[str, int]:
        # v1/mdc/{ns}/{component}/{endpoint}/{instance_id}
        parts = key.split("/")
        return "/".join(parts[2:5]), int(parts[5])

    async def _handle_put(self, key: str, value: dict) -> None:
        subject, instance_id = self._parse_key(key)
        card = ModelDeploymentCard.from_wire(value)
        if PREFILL in card.model_types:
            await self._handle_prefill_put(card, subject, instance_id)
            # a dual-role card (prefill and chat) registers as a model too
        if not {CHAT, COMPLETIONS} & set(card.model_types):
            if PREFILL not in card.model_types:
                log.warning("card %s (%s) serves %s: not ported yet; "
                            "ignored", card.name, subject, card.model_types)
            return
        entry = self.manager.get(card.name)
        if entry is None:
            entry = self._build_entry(card)
            await entry.router.client.start()
            self.manager.register(entry)
            await self._subscribe_events(card.namespace, entry)
            log.info("model registered: %s (%s, router=%s)", card.name,
                     subject, self.router_mode)
        elif entry.card.endpoint_subject != subject:
            # Same model name served from a different endpoint: first one
            # wins (instance bookkeeping must stay per-subject or deletes
            # can never drain the entry).
            log.warning("model %s already served at %s; ignoring instance "
                        "at %s", card.name, entry.card.endpoint_subject,
                        subject)
            return
        newly_seen = instance_id not in entry.instances
        entry.instances.add(instance_id)
        if card.runtime_config.get("draining"):
            # The worker announced its departure on the discovery plane:
            # stop selecting it, drop its radix state, and skip the
            # bootstrap resync (dumping a vacating worker's index would
            # attract traffic back to it).
            self._mark_draining(entry, instance_id)
            return
        if (newly_seen and entry.scheduler is not None
                and card.runtime_config.get("kv_blocks_endpoint")):
            # Bootstrap this worker's radix state from its local indexer
            # (ref: router-design.md — "on worker discovery it dumps full
            # state"; also how a restarted router recovers routing state).
            self._schedule_resync(entry, instance_id, reason="discovered")

    async def _handle_prefill_put(self, card: ModelDeploymentCard,
                                  subject: str, instance_id: int) -> None:
        """One prefill pool per model name, bound to the first endpoint
        subject seen (a second subject's instances are ignored: the pool's
        router cannot reach them and deletes could never drain them)."""
        pool = self._prefill_pools.get(card.name)
        if pool is not None and self._prefill_subjects.get(subject) \
                != card.name:
            log.warning("prefill pool for %s already bound to another "
                        "subject; ignoring instance at %s", card.name,
                        subject)
            return
        if pool is None:
            client = (self.runtime.namespace(card.namespace)
                      .component(card.component).endpoint(card.endpoint)
                      .client())
            pool = PrefillPool(router=PushRouter(client, mode="round_robin"))
            await pool.router.client.start()
            self._prefill_pools[card.name] = pool
            self._prefill_subjects[subject] = card.name
            log.info("prefill pool up for %s (%s)", card.name, subject)
        pool.instances.add(instance_id)
        if card.runtime_config.get("draining"):
            # a vacating prefill worker stops attracting new legs
            if pool.router.set_draining(instance_id, True):
                pool.wait_estimator.update_worker(instance_id, 0)
                log.info("prefill pool worker %x draining for %s",
                         instance_id, card.name)

    async def _handle_delete(self, key: str) -> None:
        subject, instance_id = self._parse_key(key)
        name = self._prefill_subjects.get(subject)
        pool = self._prefill_pools.get(name) if name is not None else None
        if pool is not None:
            pool.instances.discard(instance_id)
            pool.wait_estimator.forget_worker(instance_id)
            if not pool.instances:
                # the last prefill worker went: aggregated serving again
                log.info("prefill pool drained for %s", name)
                self._prefill_pools.pop(name, None)
                self._prefill_subjects.pop(subject, None)
                await pool.router.client.close()
            # no return: a dual-role card's subject may back a model too
        for entry in self.manager.entries():
            if entry.card.endpoint_subject != subject:
                continue
            entry.instances.discard(instance_id)
            # Deregistration completes a drain: a restarted worker at the
            # same id starts clean (the router's mark clears on the same
            # delete).
            entry.draining.discard(instance_id)
            # Its backlog is gone with it (or migrating to the others).
            entry.wait_estimator.forget_worker(instance_id)
            if entry.scheduler is not None:
                entry.scheduler.remove_worker_id(instance_id)
            if not entry.instances:
                log.info("model unlisted: %s (last instance gone)",
                         entry.card.name)
                self.manager.unregister(entry.card.name)
                entries = self._ns_entries.get(entry.card.namespace, [])
                if entry in entries:
                    entries.remove(entry)
                await entry.router.client.close()

    def _mark_draining(self, entry: ModelEntry, instance_id: int) -> None:
        """One-shot draining transition, from the card flag or the load
        metrics (`set_draining` dedups): exclude the instance from
        selection, drop its radix state and zero its admission depth."""
        if not entry.router.set_draining(instance_id, True):
            return
        entry.draining.add(instance_id)
        if entry.scheduler is not None:
            entry.scheduler.remove_worker_id(instance_id)
        # Its backlog is migrating out, not queue depth new arrivals wait
        # behind.
        entry.wait_estimator.update_worker(instance_id, 0)
        log.info("worker %x draining: removed from selection for %s",
                 instance_id, entry.card.name)

    # -- worker state resync (bootstrap + gap recovery) --------------------

    def _schedule_resync(self, entry: ModelEntry, instance_id: int,
                         reason: str) -> None:
        if instance_id in entry.draining:
            # A vacating worker's radix state was dropped on purpose; this
            # guard covers the gap, journal and bootstrap paths.
            return
        key = (entry.card.endpoint_subject, instance_id)
        if key in self._resyncing:
            return
        self._resyncing[key] = []  # event buffer; _event_loop fills it
        task = asyncio.create_task(
            self._resync_worker(entry, instance_id, reason, key))
        self._tasks.append(task)
        task.add_done_callback(
            lambda t: self._tasks.remove(t) if t in self._tasks else None)

    async def _resync_worker(self, entry: ModelEntry, instance_id: int,
                             reason: str, key) -> None:
        card = entry.card
        client = (self.runtime.namespace(card.namespace)
                  .component(card.component).endpoint("kv_blocks").client())
        indexer = entry.scheduler.indexer
        regap = False
        try:
            await client.start()
            await client.wait_for_instances(1, timeout=10)
            async with contextlib.aclosing(
                    client.direct({}, instance_id)) as stream:
                dump = await anext(stream)
                worker = WorkerWithDpRank(dump["worker_id"],
                                          dump.get("dp_rank", 0))
                pairs = [(p, h) for p, h in dump.get("blocks", [])]
                indexer.load_worker(worker, pairs, dump.get("last_event_id"))
                # Replay events that arrived during the RPC. Anything the
                # dump already reflects (id <= dump_last) is skipped by the
                # indexer's stale check; newer ones apply in order. No await
                # between pop and replay, so no event can slip past both.
                buffered = self._resyncing.pop(key, [])
                for event in buffered:
                    if indexer.apply_event(event) == "gap":
                        regap = True
                log.info("resynced worker %x for %s (%s): %d blocks, "
                         "%d events replayed", instance_id, card.name,
                         reason, len(pairs), len(buffered))
        except Exception:  # noqa: BLE001 — resync is best-effort; events
            # keep flowing and a later gap retries
            log.exception("kv resync failed for %x (%s)", instance_id, reason)
        finally:
            # Failure path: don't drop what was buffered — apply it.
            for event in self._resyncing.pop(key, []):
                try:
                    indexer.apply_event(event)
                except Exception:  # noqa: BLE001
                    log.exception("buffered event replay failed")
            await client.close()
        if regap:
            # An event was lost inside the resync window itself; scheduled
            # after the finally above so the retry's fresh buffer can't be
            # popped by this invocation.
            self._schedule_resync(entry, instance_id, reason="replay-gap")

    def _build_entry(self, card: ModelDeploymentCard) -> ModelEntry:
        client = (self.runtime.namespace(card.namespace)
                  .component(card.component).endpoint(card.endpoint)
                  .client())
        scheduler: Optional[KvScheduler] = None
        if self.router_mode == "kv":
            config = dataclasses.replace(self.kv_config or KvRouterConfig(),
                                         block_size=card.kv_block_size)
            scheduler = KvScheduler(config)
            router = PushRouter(client, mode="round_robin")
            engine: TokenEngine = KvRouterEngine(router, scheduler)
        else:
            router = PushRouter(client, mode=self.router_mode)
            engine = RouterEngine(router)
        name = card.name
        engine = PrefillRouterEngine(
            engine, pool_lookup=lambda: self._prefill_pools.get(name))
        engine = Migration(engine, migration_limit=env("DYNT_MIGRATION_LIMIT"))
        return ModelEntry(card=card, preprocessor=OpenAIPreprocessor(card),
                          engine=engine, router=router, scheduler=scheduler)

    # -- the event plane ---------------------------------------------------

    async def _subscribe_events(self, namespace: str,
                                entry: ModelEntry) -> None:
        """Feed KV events + load metrics from the event plane into every
        model entry in this namespace (ref: kv_router/subscriber.rs)."""
        entries = self._ns_entries.get(namespace)
        if entries is not None:
            entries.append(entry)
            return
        entries = [entry]
        self._ns_entries[namespace] = entries
        sub = await self.runtime.event_subscriber(namespace, topic_prefix="")
        self._tasks.append(asyncio.create_task(self._event_loop(sub, entries)))
        if self._maintain_task is None:
            self._maintain_task = asyncio.create_task(
                self._indexer_maintain_loop())
            self._tasks.append(self._maintain_task)

    async def _indexer_maintain_loop(self, interval: float = 1.0) -> None:
        """Radix-index TTL/size sweep for every KV-routed entry (a no-op
        unless DYNT_INDEXER_TTL_SECS / _MAX_TREE_SIZE enable pruning)."""
        while True:
            await asyncio.sleep(interval)
            for entries in self._ns_entries.values():
                for entry in entries:
                    if entry.scheduler is not None:
                        sweep_tree(entry.scheduler.indexer, entry.card.name,
                                   log)

    async def _event_loop(self, sub, entries: list[ModelEntry]) -> None:
        async for topic, payload in sub:
            try:
                self._apply(topic, payload, entries)
            except Exception:  # noqa: BLE001
                log.exception("bad event on %s", topic)

    def _apply(self, topic: str, payload, entries: list[ModelEntry]) -> None:
        if topic.startswith(KV_EVENT_TOPIC):
            event = RouterEvent.from_wire(payload)
            for entry in entries:
                if entry.scheduler is None:
                    continue
                if event.worker_id in entry.draining:
                    # Vacating: its late events would re-create the radix
                    # state _mark_draining dropped.
                    continue
                buffer = self._resyncing.get(
                    (entry.card.endpoint_subject, event.worker_id))
                if buffer is not None:
                    # Resync in flight: hold this worker's events for replay
                    # after the snapshot loads.
                    buffer.append(event)
                    continue
                status = entry.scheduler.indexer.apply_event(event)
                if (status == "gap" and event.worker_id in entry.instances
                        and entry.card.runtime_config.get(
                            "kv_blocks_endpoint")):
                    # Missed events: replace this worker's view from its
                    # local indexer (ref: worker_query).
                    self._schedule_resync(entry, event.worker_id,
                                          reason="gap")
        elif topic.startswith(KV_SNAPSHOT_TOPIC):
            # Journal rotation snapshot: replace that worker's view
            # wholesale (the same application path as a resync).
            worker = WorkerWithDpRank(payload["worker_id"],
                                      payload.get("dp_rank", 0))
            for entry in entries:
                if entry.scheduler is None or (
                        payload["worker_id"] in entry.draining):
                    continue  # vacating: its state stays dropped
                if (entry.card.endpoint_subject,
                        payload["worker_id"]) in self._resyncing:
                    continue  # a live resync wins; it is fresher
                entry.scheduler.indexer.load_worker(
                    worker, [(p, h) for p, h in payload.get("blocks", [])],
                    payload.get("last_event_id"))
        elif topic.startswith(JOURNAL_RESYNC_TOPIC):
            # The durable journal skipped corrupt frames: KV events were
            # lost with no per-worker gap to flag them, so re-dump every
            # routed worker's state from its local indexer.
            for entry in entries:
                if entry.scheduler is None or not \
                        entry.card.runtime_config.get("kv_blocks_endpoint"):
                    continue
                for iid in list(entry.instances):
                    self._schedule_resync(entry, iid,
                                          reason="journal-corrupt")
        elif topic.startswith(LOAD_TOPIC):
            metrics = LoadMetrics.from_wire(payload)
            for entry in entries:
                entry.worker_usage[metrics.worker_id] = metrics.kv_usage
                if (metrics.draining
                        and metrics.worker_id in entry.instances):
                    # Departure announced on the load plane, sooner than
                    # the card republish lands; update_published would
                    # re-add the worker remove_worker_id just dropped.
                    self._mark_draining(entry, metrics.worker_id)
                    continue
                if entry.scheduler is not None:
                    entry.scheduler.sequences.update_published(metrics)
                if metrics.worker_id in entry.instances:
                    # The admission depth: the scheduler's own queue.
                    entry.wait_estimator.update_worker(
                        metrics.worker_id, metrics.waiting_requests)
            for pool in self._prefill_pools.values():
                if metrics.worker_id not in pool.instances:
                    continue
                if metrics.draining:
                    # a draining prefill worker gets no new legs; the
                    # transfers its decode peers are pulling finish on
                    # their own (its drain deadline bounds them)
                    if pool.router.set_draining(metrics.worker_id, True):
                        pool.wait_estimator.update_worker(
                            metrics.worker_id, 0)
                    continue
                pool.wait_estimator.update_worker(
                    metrics.worker_id, metrics.waiting_requests)
