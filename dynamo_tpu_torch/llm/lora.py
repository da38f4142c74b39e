"""LoRA adapters: the file format and the worker's slot manager.

Port of `dynamo_tpu/llm/lora.py`. An adapter is a `.npz` holding per-layer
low-rank factors `layers.{i}.{target}.a` [din, r] and `.b` [r, dout] for
targets in `models.transformer.LORA_TARGETS`, plus `alpha` and `rank`
scalars; one file written by `save_lora_npz` loads in either package, and
`load_lora_npz` returns the reference's arrays (b scaled by alpha / rank).

`LoraManager` maps adapter names to the runner's fixed slot pack (slot 0 is
the base model): load-time validation against this package's own
`lora_target_dims` (a target the model family does not apply, a shape or a
layer out of range, or a rank above the slot rank is refused, never
dropped), zero-padding up to the slot rank, and the two-phase unload
(`begin_unload`, then `commit_unload` or `abort_unload`) the worker runs
around its in-flight check. The worker's `lora_load` / `lora_unload` /
`lora_list` endpoints and its card's `runtime_config["loras"]` sit on top
(`engine/worker.py`); the frontend routes `model=<adapter>` by that list
(`llm/manager.py` `resolve`).
"""

from __future__ import annotations

import dataclasses
import io
import logging
import threading
from typing import Optional

import numpy as np

from ..models import ModelConfig
from ..models.transformer import LORA_TARGETS, lora_target_dims

log = logging.getLogger("dynamo_tpu_torch.llm.lora")

# layer index -> target -> (a [din, r], b [r, dout]) host arrays
LoraLayers = dict[int, dict[str, tuple[np.ndarray, np.ndarray]]]


@dataclasses.dataclass
class LoraAdapter:
    name: str
    rank: int
    alpha: float
    # b already scaled by alpha / rank (and both padded to the slot rank
    # once a manager has loaded it)
    layers: LoraLayers = dataclasses.field(default_factory=dict)
    slot: int = -1


def save_lora_npz(path: str, layers: LoraLayers, rank: int,
                  alpha: float) -> None:
    """Write an adapter file. `layers[i][target] = (a, b)` with b unscaled."""
    arrays: dict[str, np.ndarray] = {
        "rank": np.asarray(rank, np.int32),
        "alpha": np.asarray(alpha, np.float32),
    }
    for i, targets in layers.items():
        for t, (a, b) in targets.items():
            if t not in LORA_TARGETS:
                raise ValueError(f"unknown LoRA target {t!r}")
            arrays[f"layers.{i}.{t}.a"] = np.asarray(a)
            arrays[f"layers.{i}.{t}.b"] = np.asarray(b)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_lora_npz(name: str, path: str) -> LoraAdapter:
    """Read an adapter file; alpha / rank is folded into every b."""
    with open(path, "rb") as f:
        data = np.load(io.BytesIO(f.read()))
    rank = int(data["rank"])
    alpha = float(data["alpha"])
    scale = alpha / max(rank, 1)
    layers: LoraLayers = {}
    for key in data.files:
        if not key.startswith("layers."):
            continue
        _, idx, target, part = key.split(".")
        if target not in LORA_TARGETS:
            raise ValueError(f"{path}: unknown LoRA target {target!r}")
        entry = layers.setdefault(int(idx), {})
        a, b = entry.get(target, (None, None))
        if part == "a":
            a = np.asarray(data[key])
        elif part == "b":
            b = np.asarray(data[key]) * scale
        else:
            raise ValueError(f"{path}: bad key {key!r}")
        entry[target] = (a, b)
    for idx, targets in layers.items():
        for t, (a, b) in targets.items():
            if a is None or b is None:
                raise ValueError(f"{path}: layer {idx} target {t} missing a/b")
            if a.shape[1] != rank or b.shape[0] != rank:
                raise ValueError(
                    f"{path}: layer {idx} target {t} rank mismatch "
                    f"(a {a.shape}, b {b.shape}, rank {rank})")
    return LoraAdapter(name=name, rank=rank, alpha=alpha, layers=layers)


class LoraManager:
    """Adapter name -> slot over a fixed-rank slot pack. Thread-safe: loads
    and unloads run on the event loop (and their file reads on a thread)
    while the scheduler thread reads slots."""

    def __init__(self, model_config: ModelConfig, max_loras: int,
                 rank: int) -> None:
        self.model_config = model_config
        self.max_loras = max_loras
        self.rank = rank
        self._lock = threading.Lock()
        self._by_name: dict[str, LoraAdapter] = {}
        self._free_slots = list(range(1, max_loras + 1))  # slot 0 = base

    def load(self, name: str, path: str) -> LoraAdapter:
        """Read, validate and pad an adapter, then assign it the lowest free
        slot. Raises ValueError (a target, shape, layer or rank this model
        cannot take; a name already loaded) or RuntimeError (no free
        slot), with the reference's messages."""
        adapter = load_lora_npz(name, path)
        cfg = self.model_config
        dims = lora_target_dims(cfg)
        for idx, targets in adapter.layers.items():
            if not 0 <= idx < cfg.n_layers:
                raise ValueError(
                    f"adapter {name!r} targets layer {idx}; model has "
                    f"{cfg.n_layers} layers")
            for t, (a, b) in targets.items():
                if t not in dims:
                    raise ValueError(
                        f"adapter {name!r} targets {t!r}, unsupported for "
                        f"model family {cfg.name!r} "
                        f"(supported: {sorted(dims)})")
                din, dout = dims[t]
                if a.shape[0] != din or b.shape[1] != dout:
                    raise ValueError(
                        f"adapter {name!r} layer {idx} target {t}: shapes "
                        f"a{a.shape}/b{b.shape} vs model ({din}, {dout})")
        if adapter.rank > self.rank:
            raise ValueError(
                f"adapter {name!r} rank {adapter.rank} exceeds the engine's "
                f"slot rank {self.rank} (set --lora-rank higher)")
        pad = self.rank - adapter.rank
        if pad:
            # zero rows and columns up to the slot rank: the delta is the same
            for targets in adapter.layers.values():
                for t, (a, b) in targets.items():
                    targets[t] = (np.pad(a, ((0, 0), (0, pad))),
                                  np.pad(b, ((0, pad), (0, 0))))
        with self._lock:
            if name in self._by_name:
                raise ValueError(f"adapter {name!r} already loaded")
            if not self._free_slots:
                raise RuntimeError(
                    f"no free adapter slots (max_loras={self.max_loras})")
            adapter.slot = self._free_slots.pop(0)
            self._by_name[name] = adapter
        log.info("lora adapter %s loaded into slot %d (rank %d, alpha %g)",
                 name, adapter.slot, adapter.rank, adapter.alpha)
        return adapter

    def unload(self, name: str) -> LoraAdapter:
        adapter = self.begin_unload(name)
        self.commit_unload(adapter)
        return adapter

    def begin_unload(self, name: str) -> LoraAdapter:
        """Phase 1: unmap the name (new requests fail fast) without freeing
        the slot, so a concurrent load cannot reuse it while in-flight
        sequences are checked. Follow with commit_unload or abort_unload."""
        with self._lock:
            adapter = self._by_name.pop(name, None)
            if adapter is None:
                raise KeyError(f"adapter {name!r} not loaded")
        return adapter

    def commit_unload(self, adapter: LoraAdapter) -> None:
        with self._lock:
            self._free_slots.append(adapter.slot)
            self._free_slots.sort()
        log.info("lora adapter %s unloaded (slot %d freed)", adapter.name,
                 adapter.slot)

    def abort_unload(self, adapter: LoraAdapter) -> None:
        with self._lock:
            self._by_name[adapter.name] = adapter

    def slot_of(self, name: str) -> Optional[int]:
        with self._lock:
            adapter = self._by_name.get(name)
            return adapter.slot if adapter is not None else None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._by_name)

    def list(self) -> list[dict]:
        with self._lock:
            return [{"name": a.name, "slot": a.slot, "rank": a.rank,
                     "alpha": a.alpha}
                    for a in sorted(self._by_name.values(),
                                    key=lambda a: a.slot)]
