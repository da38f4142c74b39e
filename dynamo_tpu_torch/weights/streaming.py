"""Single-peer weight streaming — the ModelExpress analog.

Port of `dynamo_tpu/weights/streaming.py`. A cold worker pulls parameters
from a live replica over the request plane instead of initializing or
reading a checkpoint. Frames are msgpack dicts with raw bytes, chunked like
the disaggregated KV transfer, and equal the reference's.
"""

from __future__ import annotations

import logging
from typing import Iterator, Optional

import torch

from .leaves import Leaf, dtype_name, from_bytes, to_bytes

log = logging.getLogger("dynamo_tpu_torch.weights.streaming")

STREAM_CHUNK_BYTES = 4 * 2**20


def manifest_frame(weights_key: str, n_params: int) -> dict:
    """First frame of a weight stream: identifies what is being streamed,
    so a puller can reject weights of the wrong model (two architecturally
    identical models would otherwise pass shape validation)."""
    return {"manifest": True, "weights_key": weights_key,
            "total_params": n_params}


def encode_param_chunks(flat: list[tuple[str, Leaf]]) -> Iterator[dict]:
    """Stream a flattened param list as wire frames. Each param is split
    into <= STREAM_CHUNK_BYTES raw-byte chunks."""
    total = len(flat)
    for index, (key, arr) in enumerate(flat):
        data = to_bytes(arr)
        n_chunks = max(1, -(-len(data) // STREAM_CHUNK_BYTES))
        for ci in range(n_chunks):
            lo = ci * STREAM_CHUNK_BYTES
            yield {
                "path": key,
                "dtype": dtype_name(arr),
                "shape": list(arr.shape),
                "index": index,
                "total_params": total,
                "chunk": ci,
                "total_chunks": n_chunks,
                "data": data[lo: lo + STREAM_CHUNK_BYTES].tobytes(),
            }


class ParamAssembler:
    """Pull-side reassembly of streamed parameter frames."""

    def __init__(self) -> None:
        self._partial: dict[str, list[Optional[bytes]]] = {}
        self._meta: dict[str, tuple[tuple, str]] = {}
        self.params: dict[str, torch.Tensor] = {}
        self._total: Optional[int] = None

    def add(self, frame: dict) -> None:
        key = frame["path"]
        self._total = frame["total_params"]
        chunks = self._partial.setdefault(
            key, [None] * frame["total_chunks"])
        chunks[frame["chunk"]] = frame["data"]
        self._meta[key] = (tuple(frame["shape"]), frame["dtype"])
        if all(c is not None for c in chunks):
            shape, dtype = self._meta[key]
            self.params[key] = from_bytes(b"".join(chunks), dtype, shape)
            del self._partial[key]

    @property
    def complete(self) -> bool:
        return (self._total is not None
                and len(self.params) == self._total
                and not self._partial)


async def pull_weights(runtime, namespace: str, component: str,
                       expected_key: Optional[str] = None,
                       timeout: float = 120.0
                       ) -> Optional[dict[str, torch.Tensor]]:
    """Pull a full parameter set from any live peer serving the `weights`
    endpoint. `expected_key` (the puller's weights key) must match the
    stream's manifest — shape checks alone cannot tell two same-architecture
    models apart. Returns path-addressed host tensors, or None on failure
    (the caller falls down the arrival ladder)."""
    import asyncio

    from ..runtime.push_router import PushRouter

    endpoint = (runtime.namespace(namespace).component(component)
                .endpoint("weights"))
    router = PushRouter(endpoint.client(), mode="round_robin")
    try:
        await router.client.start()
        try:
            await router.client.wait_for_instances(1, timeout=5.0)
        except asyncio.TimeoutError:
            return None
        assembler = ParamAssembler()
        async for frame in router.generate({}):
            if frame.get("error"):
                log.warning("peer weight pull failed: %s", frame["error"])
                return None
            if frame.get("manifest"):
                peer_key = frame.get("weights_key")
                if expected_key is not None and peer_key != expected_key:
                    log.warning(
                        "peer serves %r, we need %r; not pulling (same "
                        "component hosting a different model?)",
                        peer_key, expected_key)
                    return None
                continue
            assembler.add(frame)
        if not assembler.complete:
            log.warning("peer weight pull incomplete")
            return None
        log.info("pulled %d params from a live peer", len(assembler.params))
        return assembler.params
    except Exception:  # noqa: BLE001 — any failure -> fall back
        log.exception("peer weight pull failed")
        return None
    finally:
        await router.client.close()
