"""Striped peer weight streaming — the fast-start arrival plane.

Port of `dynamo_tpu/weights/striped.py`. A joining worker pulls the model's
weight tree as content-addressed chunks striped in parallel across every
live replica serving the same weights key:

  * a deterministic chunk manifest with per-chunk XXH64 digests, so a
    corrupted chunk is detected at the puller and never assembled — it is
    re-fetched from a different donor;
  * resume-after-donor-death: a donor that dies mid-stream only costs its
    unserved chunks, which are re-striped over the survivors;
  * donor-side bandwidth budgeting (`BandwidthBudget`): the donor's device
    gathers ride the scheduler's dispatch/drain gap, paced by
    DYNT_WEIGHT_STREAM_BW_FRAC, so its decode ITL holds while it seeds;
  * fallback to the G4 object store (`weights/objstore.py`) when no live
    peer serves the model.

Wire protocol (the `weights` endpoint, beside the single-peer stream of
`weights/streaming.py` — an empty body keeps that one):

    {"weights_manifest": true}   -> one manifest frame (to_wire below)
    {"weights_chunks": [cid...]} -> {"cid", "digest", "data"} frames

The manifests and frames equal the reference's byte for byte. Digests are
the port's bulk XXH64 (`tokens.xxh64_many`): the manifest hashes every
chunk of the tree in one vectorised pass, and the puller verifies a round's
received chunks together (`StripedAssembler.add_many`), since one 4 MiB
chunk hashed alone runs at Python's speed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
import uuid
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..runtime import conformance
from ..runtime.metrics import WEIGHT_STREAM_CHUNKS
from ..tokens import xxh64_many
from .leaves import Leaf, dtype_name, to_bytes, torch_dtype

log = logging.getLogger("dynamo_tpu_torch.weights.striped")

STRIPE_CHUNK_BYTES = 4 * 2**20


def chunk_digest(data) -> str:
    return f"{xxh64_many([data])[0]:016x}"


@dataclasses.dataclass(frozen=True)
class ChunkRef:
    """One content-addressed slice of one parameter's raw bytes."""

    cid: int      # global chunk id == position in manifest order
    param: int    # index into the manifest's param list
    offset: int   # byte offset within that param's buffer
    size: int
    digest: str   # xxhash64 hex of the chunk bytes

    def to_wire(self) -> list:
        return [self.param, self.offset, self.size, self.digest]


class WeightManifest:
    """Deterministic chunking of a flattened param list. Two replicas
    holding the same weights build byte-identical manifests, which is what
    lets a puller stripe one transfer across N donors and re-stripe the
    remainder when one dies."""

    def __init__(self, weights_key: str, params: list[dict],
                 chunks: list[ChunkRef],
                 chunk_bytes: int = STRIPE_CHUNK_BYTES) -> None:
        self.weights_key = weights_key
        self.params = params          # [{path, dtype, shape, nbytes}]
        self.chunks = chunks
        self.chunk_bytes = chunk_bytes

    @classmethod
    def build(cls, flat: Sequence[tuple[str, Leaf]], weights_key: str,
              chunk_bytes: int = STRIPE_CHUNK_BYTES) -> "WeightManifest":
        """`flat`: (path, host tensor or numpy array) pairs in tree order."""
        return cls.build_from_bytes(
            [(path, dtype_name(arr), list(arr.shape), to_bytes(arr))
             for path, arr in flat], weights_key, chunk_bytes)

    @classmethod
    def build_from_bytes(cls, flat: Sequence[tuple], weights_key: str,
                         chunk_bytes: int = STRIPE_CHUNK_BYTES
                         ) -> "WeightManifest":
        """`flat`: (path, dtype name, shape, uint8 bytes) in tree order."""
        params: list[dict] = []
        spans: list[tuple[int, int, int]] = []
        pieces = []
        for pi, (path, dtype, shape, data) in enumerate(flat):
            params.append({"path": path, "dtype": dtype,
                           "shape": list(shape), "nbytes": len(data)})
            n = max(1, -(-len(data) // chunk_bytes))
            for ci in range(n):
                lo = ci * chunk_bytes
                piece = data[lo: lo + chunk_bytes]
                spans.append((pi, lo, len(piece)))
                pieces.append(piece)
        digests = xxh64_many(pieces)
        chunks = [ChunkRef(cid=i, param=pi, offset=lo, size=size,
                           digest=f"{d:016x}")
                  for i, ((pi, lo, size), d) in enumerate(zip(spans,
                                                              digests))]
        return cls(weights_key, params, chunks, chunk_bytes)

    @property
    def total_bytes(self) -> int:
        return sum(p["nbytes"] for p in self.params)

    def to_wire(self) -> dict:
        return {"manifest": True, "weights_key": self.weights_key,
                "chunk_bytes": self.chunk_bytes, "params": self.params,
                "chunks": [c.to_wire() for c in self.chunks]}

    @classmethod
    def from_wire(cls, frame: dict) -> "WeightManifest":
        chunks = [ChunkRef(cid=i, param=c[0], offset=c[1], size=c[2],
                           digest=c[3])
                  for i, c in enumerate(frame["chunks"])]
        return cls(frame["weights_key"], frame["params"], chunks,
                   frame.get("chunk_bytes", STRIPE_CHUNK_BYTES))


class StripedAssembler:
    """Digest-verifying reassembly. A chunk whose bytes do not hash to the
    manifest digest is rejected here — corrupted data is never served — and
    the puller re-fetches it from another donor."""

    def __init__(self, manifest: WeightManifest) -> None:
        self.manifest = manifest
        self._bufs: list[np.ndarray] = [
            np.empty(p["nbytes"], np.uint8) for p in manifest.params]
        self._have: set[int] = set()

    def add(self, cid: int, data) -> bool:
        """Verify and place one chunk. False = digest or size mismatch (the
        chunk was not placed); True = placed (idempotent on repeats)."""
        return self.add_many([(cid, data)])[0]

    def add_many(self, items: Sequence[tuple[int, object]]) -> list[bool]:
        """`add` for many chunks, their digests computed in one pass."""
        ok = [False] * len(items)
        todo = []
        for i, (cid, data) in enumerate(items):
            if not 0 <= cid < len(self.manifest.chunks):
                continue
            if len(data) != self.manifest.chunks[cid].size:
                WEIGHT_STREAM_CHUNKS.labels(outcome="digest_mismatch").inc()
                continue
            todo.append(i)
        digests = xxh64_many([items[i][1] for i in todo])
        for i, d in zip(todo, digests):
            cid, data = items[i]
            ref = self.manifest.chunks[cid]
            if f"{d:016x}" != ref.digest:
                WEIGHT_STREAM_CHUNKS.labels(outcome="digest_mismatch").inc()
                continue
            if cid not in self._have:
                self._bufs[ref.param][ref.offset: ref.offset + ref.size] = (
                    np.frombuffer(data, np.uint8))
                self._have.add(cid)
            WEIGHT_STREAM_CHUNKS.labels(outcome="verified").inc()
            ok[i] = True
        return ok

    @property
    def missing(self) -> list[int]:
        return [c.cid for c in self.manifest.chunks
                if c.cid not in self._have]

    @property
    def complete(self) -> bool:
        return len(self._have) == len(self.manifest.chunks)

    def params(self) -> dict[str, torch.Tensor]:
        """Path-addressed host tensors over the assembled buffers."""
        assert self.complete, "assembling an incomplete weight tree"
        return {meta["path"]: torch.from_numpy(buf).view(
            torch_dtype(meta["dtype"])).reshape(tuple(meta["shape"]))
            for meta, buf in zip(self.manifest.params, self._bufs)}


class BandwidthBudget:
    """Donor-side duty-cycle pacing — the KVBM offload formula: after a
    serving gather that cost g seconds, defer the next by g*(1/frac - 1) so
    weight streaming occupies at most `frac` of the donor's gather
    bandwidth and the in-flight decode batch keeps its ITL."""

    def __init__(self, frac: float) -> None:
        self.frac = min(max(float(frac), 0.01), 1.0)
        self.deferred_total = 0.0

    def defer_after(self, cost_secs: float) -> float:
        if self.frac >= 1.0:
            return 0.0
        defer = max(0.0, cost_secs) * (1.0 / self.frac - 1.0)
        self.deferred_total += defer
        return defer


# -- striped pull core ------------------------------------------------------
#
# The control loop is transport-agnostic: `fetch_chunks(donor, cids)` yields
# (cid, data) pairs and raises (or ends early) when the donor dies. Tests
# drive it with fakes; pull_weights_striped below binds it to the request
# plane.

async def pull_striped(
    manifest: WeightManifest,
    donors: Sequence[object],
    fetch_chunks,  # async fn (donor, cids) -> AsyncIterator[(cid, bytes)]
    deadline: Optional[float] = None,
    pull_id: Optional[str] = None,
) -> Optional[dict[str, torch.Tensor]]:
    """Stripe the manifest over `donors`, re-striping failures until the
    tree is complete or no donors survive. Returns the assembled
    path-addressed host tensors, or None (the caller falls back).
    `pull_id` keys the pull's lifecycle for the conformance monitor (its
    manifest already observed); None observes it from here."""
    if pull_id is None:
        pull_id = uuid.uuid4().hex
        conformance.observe("striped_weight_pull", pull_id, "manifest")
    assembler = StripedAssembler(manifest)
    alive: list = list(donors)
    # cid -> donors that already failed it (death or corruption); a
    # re-fetch prefers any donor not in this set, so a corrupting donor
    # cannot re-serve the same bad chunk forever.
    tainted: dict[int, set] = {}
    restriping = False
    round_no = 0

    def give_up() -> None:
        if not restriping:
            conformance.observe("striped_weight_pull", pull_id, "dead")
        conformance.observe("striped_weight_pull", pull_id, "error")

    while alive and not assembler.complete:
        if deadline is not None and time.monotonic() > deadline:
            log.warning("striped pull timed out with %d/%d chunks",
                        len(manifest.chunks) - len(assembler.missing),
                        len(manifest.chunks))
            give_up()
            return None
        round_no += 1
        assignment: dict = {d: [] for d in alive}
        order = list(alive)
        for i, cid in enumerate(assembler.missing):
            bad = tainted.get(cid, ())
            pool = [d for d in order if d not in bad] or order
            assignment[pool[i % len(pool)]].append(cid)

        async def _one(donor, cids: list[int]):
            """Returns (donor, its cids, the (cid, data) pairs it sent,
            died)."""
            received: list = []
            try:
                async for cid, data in fetch_chunks(donor, cids):
                    received.append((cid, data))
            except Exception as exc:  # noqa: BLE001 — donor death is an
                # expected event on a spot fleet, not an error
                log.warning("donor %s died mid-stripe (%r) after %d of %d "
                            "chunks", donor, exc, len(received), len(cids))
                return donor, cids, received, True
            return donor, cids, received, False

        results = await asyncio.gather(
            *(_one(d, cids) for d, cids in assignment.items() if cids))
        # Every chunk received this round is verified in one digest pass;
        # a chunk a donor failed (unserved or corrupt) is tainted on it.
        batch = [item for _, _, received, _ in results for item in received]
        ok = await asyncio.to_thread(assembler.add_many, batch)
        placed = {cid for (cid, _), good in zip(batch, ok) if good}
        for _ in placed:
            restriping = False
            conformance.observe("striped_weight_pull", pull_id, "chunk")
        restriped = 0
        for donor, cids, received, died in results:
            # a corrupt chunk, or on a death every unserved one
            failed = ([cid for cid in cids if cid not in placed] if died
                      else [cid for cid, _ in received if cid not in placed])
            for cid in failed:
                tainted.setdefault(cid, set()).add(donor)
            if died:
                alive.remove(donor)
                restriped += len(failed)
        if restriped and alive and not assembler.complete:
            WEIGHT_STREAM_CHUNKS.labels(outcome="restriped").inc(restriped)
            if not restriping:
                conformance.observe("striped_weight_pull", pull_id, "dead")
                restriping = True
        if alive and not assembler.complete:
            # Every remaining chunk tainted on every live donor (death or
            # corruption): no assignment can make progress — bail instead
            # of spinning.
            if all(set(alive) <= tainted.get(cid, set())
                   for cid in assembler.missing):
                log.warning("all donors serve corrupt data for %d chunks",
                            len(assembler.missing))
                give_up()
                return None
    if not assembler.complete:
        log.warning("striped pull exhausted donors with %d chunks missing",
                    len(assembler.missing))
        give_up()
        return None
    conformance.observe("striped_weight_pull", pull_id, "complete")
    log.info("striped pull complete: %d chunks / %.1f MiB from %d donors "
             "in %d round(s)", len(manifest.chunks),
             manifest.total_bytes / 2**20, len(donors), round_no)
    return assembler.params()


async def pull_weights_striped(
    runtime, namespace: str, component: str,
    expected_key: Optional[str] = None,
    max_donors: int = 4,
    timeout: float = 300.0,
) -> Optional[dict[str, torch.Tensor]]:
    """Request-plane binding of the striped pull: discover live donors on
    the `weights` endpoint, fetch the manifest from one, stripe the chunk
    space across up to `max_donors` of them. None on any failure — the
    caller walks down the arrival ladder (single peer, object store,
    checkpoint, init)."""
    from ..runtime.push_router import PushRouter

    endpoint = (runtime.namespace(namespace).component(component)
                .endpoint("weights"))
    router = PushRouter(endpoint.client(), mode="round_robin")
    pull_id = uuid.uuid4().hex
    try:
        await router.client.start()
        try:
            await router.client.wait_for_instances(1, timeout=5.0)
        except asyncio.TimeoutError:
            return None
        donors = router.available()[: max(1, max_donors)]
        if not donors:
            return None
        manifest: Optional[WeightManifest] = None
        for iid in donors:
            try:
                async for frame in router.generate(
                        {"weights_manifest": True}, instance_id=iid):
                    if frame.get("error"):
                        log.warning("manifest fetch from %x failed: %s",
                                    iid, frame["error"])
                        break
                    if frame.get("manifest"):
                        if (expected_key is not None
                                and frame.get("weights_key")
                                != expected_key):
                            log.warning(
                                "peer serves %r, we need %r; not pulling",
                                frame.get("weights_key"), expected_key)
                            conformance.observe("striped_weight_pull",
                                                pull_id, "error")
                            return None
                        manifest = WeightManifest.from_wire(frame)
                        break
            except Exception:  # noqa: BLE001 — try the next donor
                log.exception("manifest fetch from %x failed", iid)
            if manifest is not None:
                break
        if manifest is None:
            conformance.observe("striped_weight_pull", pull_id, "error")
            return None
        conformance.observe("striped_weight_pull", pull_id, "manifest")

        async def fetch_chunks(donor, cids):
            async for frame in router.generate(
                    {"weights_chunks": cids}, instance_id=donor):
                if frame.get("error"):
                    raise RuntimeError(frame["error"])
                yield frame["cid"], frame["data"]

        return await pull_striped(
            manifest, donors, fetch_chunks,
            deadline=time.monotonic() + timeout, pull_id=pull_id)
    except Exception:  # noqa: BLE001 — any failure -> ladder fallback
        log.exception("striped weight pull failed")
        return None
    finally:
        await router.client.close()


def encode_chunk_frames(manifest: WeightManifest,
                        param_bytes: Sequence,
                        cids: Iterable[int]):
    """Donor-side frames for a chunk-subset request. `param_bytes` is the
    donor's cached per-param raw buffers (uint8 arrays or bytes) in
    manifest order."""
    for cid in cids:
        if not 0 <= cid < len(manifest.chunks):
            yield {"error": f"unknown chunk id {cid}"}
            return
        ref = manifest.chunks[cid]
        data = param_bytes[ref.param][ref.offset: ref.offset + ref.size]
        WEIGHT_STREAM_CHUNKS.labels(outcome="served").inc()
        yield {"cid": cid, "digest": ref.digest, "data": bytes(data)}
