"""Object-store weight tree — the no-peer rung of the arrival ladder.

Port of `dynamo_tpu/weights/objstore.py`. When a joining worker finds no
live replica serving its weights key (the first worker of a scale-up from
zero, or a whole-fleet eviction), it fetches the tree from the G4 object
store: the striped pull's content-addressed chunk layout, under a
weights-key-derived prefix, digest-verified on the way back in. Workers
that resolved their weights any other way publish here best-effort and off
the startup path, so the store converges to holding every served model.

Layout under `weights/<xxh64(weights_key)>/`, as the reference's:

    manifest.json          WeightManifest.to_wire()
    chunks/<cid>-<digest>  raw chunk bytes

The client is either backend the KVBM G4 tier speaks
(`block_manager/storage.py`): a filesystem root, or an S3/GCS-shaped HTTP
endpoint with the DYNT_G4_* auth family.
"""

from __future__ import annotations

import json
import logging
from typing import Optional, Sequence

import torch

from ..tokens import xxh64_hexdigest
from .leaves import Leaf, dtype_name, to_bytes
from .striped import StripedAssembler, WeightManifest, chunk_digest

log = logging.getLogger("dynamo_tpu_torch.weights.objstore")

# Chunks fetched, then verified together in one digest pass (2 GiB)
_FETCH_BATCH = 512


def make_store_client(root: str):
    """Filesystem root or http(s) URL -> object-store client (the split the
    KVBM's G4 tier uses)."""
    from ..block_manager.storage import (
        FsObjectStoreClient,
        HttpObjectStoreClient,
    )

    if root.startswith(("http://", "https://")):
        return HttpObjectStoreClient(root)
    return FsObjectStoreClient(root)


def weights_prefix(weights_key: str) -> str:
    return f"weights/{xxh64_hexdigest(weights_key.encode())}"


def _chunk_key(prefix: str, cid: int, digest: str) -> str:
    return f"{prefix}/chunks/{cid}-{digest}"


def publish_weights_to_store(client, weights_key: str,
                             flat: Sequence[tuple[str, Leaf]]) -> int:
    """Upload the chunked tree; the manifest goes last, so a reader never
    sees a manifest whose chunks are still uploading. Returns the chunk
    count (raises on store errors — callers treat publish as best-effort
    and log)."""
    bufs = [to_bytes(arr) for _, arr in flat]  # device leaves: one copy
    manifest = WeightManifest.build_from_bytes(
        [(path, dtype_name(arr), list(arr.shape), buf)
         for (path, arr), buf in zip(flat, bufs)], weights_key)
    prefix = weights_prefix(weights_key)
    for ref in manifest.chunks:
        data = bufs[ref.param][ref.offset: ref.offset + ref.size]
        client.put_bytes(_chunk_key(prefix, ref.cid, ref.digest),
                         data.tobytes())
    client.put_bytes(f"{prefix}/manifest.json",
                     json.dumps(manifest.to_wire()).encode())
    log.info("published %d chunks / %.1f MiB to object store under %s",
             len(manifest.chunks), manifest.total_bytes / 2**20, prefix)
    return len(manifest.chunks)


def fetch_weights_from_store(
        client, weights_key: str) -> Optional[dict[str, torch.Tensor]]:
    """Digest-verified fetch. None when the store has no complete,
    uncorrupted tree for this key — the caller falls back to checkpoint or
    init, never serves bad bytes."""
    prefix = weights_prefix(weights_key)
    try:
        raw = client.get_bytes(f"{prefix}/manifest.json")
    except Exception:  # noqa: BLE001 — transient store error == miss
        log.exception("object-store manifest fetch failed")
        return None
    if raw is None:
        return None
    try:
        frame = json.loads(raw)
    except ValueError:
        log.warning("corrupt object-store manifest under %s", prefix)
        return None
    if frame.get("weights_key") != weights_key:
        log.warning("object store holds %r under our prefix, need %r",
                    frame.get("weights_key"), weights_key)
        return None
    manifest = WeightManifest.from_wire(frame)
    assembler = StripedAssembler(manifest)
    refs = manifest.chunks
    for lo in range(0, len(refs), _FETCH_BATCH):
        batch = []
        for ref in refs[lo: lo + _FETCH_BATCH]:
            try:
                data = client.get_bytes(
                    _chunk_key(prefix, ref.cid, ref.digest))
            except Exception:  # noqa: BLE001 — transient store error == miss
                log.exception("object-store chunk fetch failed (cid=%d)",
                              ref.cid)
                return None
            if data is None:
                log.warning("object-store chunk %d missing; not serving",
                            ref.cid)
                return None
            batch.append((ref.cid, data))
        for (cid, _), ok in zip(batch, assembler.add_many(batch)):
            if not ok:
                log.warning("object-store chunk %d corrupt (digest %s); "
                            "not serving", cid, refs[cid].digest)
                return None
    log.info("fetched %d chunks / %.1f MiB from object store",
             len(manifest.chunks), manifest.total_bytes / 2**20)
    return assembler.params()


__all__ = ["make_store_client", "weights_prefix", "chunk_digest",
           "publish_weights_to_store", "fetch_weights_from_store"]
