"""ModelManager + ModelWatcher: discovery-driven serving pipelines.

Port of `dynamo_tpu/llm/manager.py` (ref: lib/llm/src/discovery/
watcher.rs:68 ModelWatcher, model_manager.rs:67 ModelManager). The frontend
is not configured with workers: it watches discovery for
ModelDeploymentCards and builds a serving pipeline (preprocessor + push
router) per model as worker instances come and go. When the last instance of
a model disappears, the model is unlisted. Cards of either package are
served. Not ported yet: prefill, encoder and image pools, KV events and load
metrics, LoRA adapters, and draining marks.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
from typing import Optional

from ..runtime.discovery import MODEL_CARD_PREFIX
from ..runtime.push_router import PushRouter
from .engine import RouterEngine, TokenEngine
from .model_card import CHAT, COMPLETIONS, ModelDeploymentCard
from .preprocessor import OpenAIPreprocessor

log = logging.getLogger("dynamo_tpu_torch.manager")


@dataclasses.dataclass
class ModelEntry:
    card: ModelDeploymentCard
    preprocessor: OpenAIPreprocessor
    engine: TokenEngine
    router: PushRouter
    instances: set[int] = dataclasses.field(default_factory=set)


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
                 router_mode: str = "round_robin") -> None:
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        self._watch = None
        self._tasks: list[asyncio.Task] = []

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
        if not {CHAT, COMPLETIONS} & set(card.model_types):
            log.warning("card %s (%s) serves %s: not ported yet; ignored",
                        card.name, subject, card.model_types)
            return
        entry = self.manager.get(card.name)
        if entry is None:
            entry = self._build_entry(card)
            await entry.router.client.start()
            self.manager.register(entry)
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
        entry.instances.add(instance_id)

    async def _handle_delete(self, key: str) -> None:
        subject, instance_id = self._parse_key(key)
        for entry in self.manager.entries():
            if entry.card.endpoint_subject != subject:
                continue
            entry.instances.discard(instance_id)
            if not entry.instances:
                log.info("model unlisted: %s (last instance gone)",
                         entry.card.name)
                self.manager.unregister(entry.card.name)
                await entry.router.client.close()

    def _build_entry(self, card: ModelDeploymentCard) -> ModelEntry:
        endpoint = (self.runtime.namespace(card.namespace)
                    .component(card.component).endpoint(card.endpoint))
        router = PushRouter(endpoint.client(), mode=self.router_mode)
        return ModelEntry(card=card, preprocessor=OpenAIPreprocessor(card),
                          engine=RouterEngine(router), router=router)
