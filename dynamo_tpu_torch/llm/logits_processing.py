"""Pluggable logits processors (ref: lib/bindings/python/src/dynamo/
logits_processing/base.py BaseLogitsProcessor + examples/).

Copy of `dynamo_tpu/llm/logits_processing.py` (numpy and the standard
library only): the registry, the built-in processors and `host_sample`, so
a processor written for the JAX package runs unchanged here, and a
processor sequence's seeded stream equals the JAX package's given equal
logits.

The reference protocol is a per-request callable that mutates the
next-token logits in place given the tokens generated so far. The decode
hot path keeps sampling inside the step graph so only token ids cross
device->host; requests that attach a processor opt into a slower escape
hatch: the engine switches those steps to a variant that also returns the
raw logits rows (`ModelRunner.decode(want_logits=True)`, its own graph
key), copies the processor slots' rows to the host, applies the
processors there (numpy, in place — same contract as the reference),
re-samples on the host, and feeds the chosen token back into the next
step. The cost (a [V] f32 readback per processor slot and step) is paid
only by requests that ask for it, which is the reference's stance too (its
processors are Python callbacks on the engine step path).

`logit_bias` (OpenAI API field) is implemented as an implicit processor
on the same path.

Processors are registered per deployment (worker startup) and selected
per request via `nvext.logits_processors: [{"name": ..., "args": {}}]`.
Factories receive the tokenizer when they declare it, mirroring the
reference examples (HelloWorldLogitsProcessor takes the tokenizer).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional, Protocol, Sequence,\
    runtime_checkable

import numpy as np


@runtime_checkable
class BaseLogitsProcessor(Protocol):
    """Per-request processor: mutate `logits` ([V] float32 numpy row for
    the next token) in place. `input_ids` are the tokens generated so
    far (ref: logits_processing/base.py — same signature with a torch
    tensor; numpy here)."""

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None: ...


_REGISTRY: dict[str, Callable[..., BaseLogitsProcessor]] = {}


def register_processor(name: str,
                       factory: Callable[..., BaseLogitsProcessor]) -> None:
    """Register a processor factory under `name`. The factory is called
    once per request with the request's `args` dict (plus `tokenizer=`
    when its signature accepts it), so processors can keep per-request
    state (the reference's HelloWorld example counts steps)."""
    _REGISTRY[name] = factory


def registered_processors() -> list[str]:
    return sorted(_REGISTRY)


def resolve_processors(
    specs: Optional[list],
    tokenizer: Any = None,
) -> list[BaseLogitsProcessor]:
    """Instantiate processors for one request from nvext specs
    (names or {"name":..., "args": {...}}). Unknown names raise
    ValueError (surfaced as a 400 by the worker): a silently dropped
    processor would return unconstrained output the client believes is
    constrained."""
    out: list[BaseLogitsProcessor] = []
    for spec in specs or []:
        if isinstance(spec, str):
            name, args = spec, {}
        else:
            name, args = spec["name"], dict(spec.get("args") or {})
        factory = _REGISTRY.get(name)
        if factory is None:
            raise ValueError(
                f"unknown logits processor {name!r}; registered: "
                f"{registered_processors()}")
        params = inspect.signature(factory).parameters
        if "tokenizer" in params and tokenizer is not None:
            args.setdefault("tokenizer", tokenizer)
        out.append(factory(**args))
    return out


class LogitBiasProcessor:
    """OpenAI `logit_bias`: additive bias per token id."""

    def __init__(self, bias: dict[int, float]) -> None:
        self._ids = np.fromiter(bias.keys(), np.int64, len(bias))
        self._vals = np.fromiter(bias.values(), np.float32, len(bias))

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None:
        mask = self._ids < logits.shape[-1]
        np.add.at(logits, self._ids[mask], self._vals[mask])


# -- built-in examples (ref: logits_processing/examples/) -------------------


class ForcedResponseProcessor:
    """Force an exact token sequence then EOS (ref: examples/
    hello_world.py HelloWorldLogitsProcessor — the canonical "did my
    processor actually run" probe)."""

    def __init__(self, token_ids: list[int], eos_id: int) -> None:
        self.token_ids = [int(t) for t in token_ids]
        self.eos_id = int(eos_id)
        self.state = 0

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None:
        want = (self.token_ids[self.state]
                if self.state < len(self.token_ids) else self.eos_id)
        logits[:] = -np.inf
        logits[want] = 0.0
        self.state += 1


class TemperatureProcessor:
    """Logit-side temperature scaling (ref: examples/temperature.py)."""

    def __init__(self, temperature: float = 1.0) -> None:
        if temperature <= 0:
            raise ValueError("temperature must be positive")
        self.temperature = float(temperature)

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None:
        logits /= self.temperature


class PenaltyProcessor:
    """OpenAI frequency/presence penalties over the tokens generated so
    far (the engine routes penalty requests through the host path so the
    penalties are actually applied — the compiled step samples from the
    raw distribution)."""

    def __init__(self, frequency_penalty: float = 0.0,
                 presence_penalty: float = 0.0) -> None:
        self.frequency_penalty = float(frequency_penalty)
        self.presence_penalty = float(presence_penalty)

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None:
        if not len(input_ids):
            return
        ids, counts = np.unique(np.asarray(input_ids, np.int64),
                                return_counts=True)
        keep = ids < logits.shape[-1]
        ids, counts = ids[keep], counts[keep]
        logits[ids] -= (self.frequency_penalty * counts
                        + self.presence_penalty)


class BanTokensProcessor:
    """Never emit the given token ids."""

    def __init__(self, token_ids: list[int]) -> None:
        self.token_ids = [int(t) for t in token_ids]

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None:
        logits[self.token_ids] = -np.inf


class RepetitionPenaltyProcessor:
    """HF-semantics multiplicative repetition penalty over the prompt AND
    every token generated so far: positive logits divide by the penalty,
    negative multiply (ref protocol: protocols/common.rs
    repetition_penalty; HF penalizes prompt ∪ generated)."""

    def __init__(self, penalty: float,
                 prompt_ids: Optional[Sequence[int]] = None) -> None:
        if penalty <= 0:
            raise ValueError("repetition_penalty must be positive")
        self.penalty = float(penalty)
        self._prompt_ids = np.unique(np.asarray(
            list(prompt_ids) if prompt_ids is not None else [], np.int64))

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None:
        if self.penalty == 1.0:
            return
        generated = np.asarray(list(input_ids), np.int64)
        ids = np.union1d(self._prompt_ids, generated)
        ids = ids[ids < logits.shape[-1]]
        if not len(ids):
            return
        vals = logits[ids]
        logits[ids] = np.where(vals > 0, vals / self.penalty,
                               vals * self.penalty)


class MinTokensProcessor:
    """Ban EOS/stop tokens until `min_tokens` have been generated (ref
    protocol: protocols/common.rs min_tokens)."""

    def __init__(self, min_tokens: int, eos_ids: Sequence[int]) -> None:
        self.min_tokens = int(min_tokens)
        self.eos_ids = [int(e) for e in eos_ids]

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None:
        if len(input_ids) < self.min_tokens:
            for e in self.eos_ids:
                if e < logits.shape[-1]:
                    logits[e] = -np.inf


class MinPProcessor:
    """vLLM-style min_p: mask tokens whose post-temperature probability
    is below min_p * max_prob (ref protocol: common.rs min_p)."""

    def __init__(self, min_p: float, temperature: float = 1.0) -> None:
        if not 0.0 < min_p <= 1.0:
            raise ValueError("min_p must be in (0, 1]")
        self.min_p = float(min_p)
        self.temperature = max(float(temperature), 1e-6)

    def __call__(self, input_ids: Sequence[int],
                 logits: np.ndarray) -> None:
        scaled = logits.astype(np.float64) / self.temperature
        scaled -= scaled.max()
        probs = np.exp(scaled)
        probs /= probs.sum()
        logits[probs < self.min_p * probs.max()] = -np.inf


def _guided_factory(tokenizer=None, **kwargs):
    from .guided import make_guided_processor

    return make_guided_processor(tokenizer=tokenizer, **kwargs)


register_processor("forced_response", ForcedResponseProcessor)
register_processor("temperature", TemperatureProcessor)
register_processor("ban_tokens", BanTokensProcessor)
# Structured outputs (llm/guided.py): regex / choice / json_schema /
# json_object constraints as a DFA-masking processor — the engine-side
# enforcement of the reference's guided_decoding protocol options.
register_processor("guided", _guided_factory)


def host_sample(logits: np.ndarray, temperature: float, top_p: float,
                top_k: int, seed: Optional[int], step: int) -> int:
    """Sample from a processed logits row on host, mirroring the
    compiled sampler's semantics (greedy at temperature 0; top-k/top-p
    truncation; seeded draws keyed by (seed, step) so a fixed request
    seed reproduces its stream)."""
    if temperature <= 0.0:
        return int(np.argmax(logits))
    scaled = logits.astype(np.float64) / temperature
    top_k = min(int(top_k or 0), len(scaled))  # clamp like the device
    if top_k > 0:                              # sampler's jnp.clip
        kth = np.partition(scaled, -top_k)[-top_k]
        scaled = np.where(scaled >= kth, scaled, -np.inf)
    if top_p < 1.0:
        order = np.argsort(scaled)[::-1]
        probs = np.exp(scaled[order] - np.max(scaled))
        probs /= probs.sum()
        keep = np.cumsum(probs) - probs < top_p
        cut = np.full_like(scaled, -np.inf)
        cut[order[keep]] = scaled[order[keep]]
        scaled = cut
    probs = np.exp(scaled - np.max(scaled))
    probs /= probs.sum()
    rng = np.random.default_rng(
        (0 if seed is None else int(seed)) * 1_000_003 + step)
    return int(rng.choice(len(probs), p=probs))
