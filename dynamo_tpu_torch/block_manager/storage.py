"""Physical storage backends for KV block tiers.

Port of `dynamo_tpu/block_manager/storage.py`:

  G2  HostArena   - a preallocated host slab of universal blocks: a torch
                    tensor, page-locked when the tiers serve a card, so the
                    D2H copy of an offload and the H2D copy of an onboard
                    move it by DMA (the reference's slab is numpy).
  G3  DiskArena   - a `numpy.memmap` slab on local disk, the same bytes in
                    the same order as the reference's file.
  G4  ObjectStore - an unbounded blob store keyed by sequence hash over a
                    pluggable client (a directory, possibly a FUSE mount,
                    or an S3/GCS-shaped HTTP endpoint), with the reference's
                    key scheme and `.npy` blobs.

Blocks are CPU torch tensors of the layout's dtype. numpy has no bfloat16
without `ml_dtypes`, so a bf16 block lives in the disk slab and in a blob
as raw 2-byte words: its `.npy` is written byte-equal to the reference's
(`np.save` of an `ml_dtypes.bfloat16` array, header descr `'<V2'`), and a
blob with that header reads back as bf16. The reference's `ObjectStore.get`
loads such a blob as a `V2` array, fails its dtype check, deletes the blob
and misses: its G4 tier never returns a bf16 block.
"""

from __future__ import annotations

import io
import os
import threading
from typing import Optional

import numpy as np
import torch

from ..llm.model_card import HASH_VERSION
from .layout import BlockLayoutSpec

# Layout dtype name -> the numpy dtype of its storage words. bf16 has no
# numpy dtype here: its words are stored as uint16, the same bytes.
_NP_STORAGE = {"bfloat16": np.uint16, "float16": np.float16,
               "float32": np.float32, "uint8": np.uint8, "int8": np.int8}
# The `.npy` header descr `np.save` writes for an ml_dtypes.bfloat16 array
_BF16_DESCR = "<V2"


def _storage_dtype(spec: BlockLayoutSpec) -> np.dtype:
    try:
        return np.dtype(_NP_STORAGE[spec.dtype])
    except KeyError:
        raise ValueError(f"unsupported KV block dtype {spec.dtype!r}") from None


def to_numpy(block: torch.Tensor) -> np.ndarray:
    """A CPU block's storage words as a numpy array (a view; bf16 as
    uint16)."""
    block = block.detach()
    if block.dtype == torch.bfloat16:
        return block.view(torch.int16).numpy().view(np.uint16)
    return block.numpy()


def from_numpy(words: np.ndarray, spec: BlockLayoutSpec) -> torch.Tensor:
    """Storage words back into a CPU block of the layout's dtype (shares
    memory with `words`)."""
    if spec.dtype == "bfloat16":
        return torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(words)


class HostArena:
    """Fixed-capacity host slab of universal blocks (page-locked with
    `pin_memory`)."""

    def __init__(self, spec: BlockLayoutSpec, capacity: int,
                 pin_memory: bool = False) -> None:
        self.spec = spec
        self.capacity = capacity
        self.pinned = pin_memory
        self._slab = torch.zeros((capacity,) + spec.block_shape,
                                 dtype=spec.torch_dtype,
                                 pin_memory=pin_memory)

    def write(self, idx: int, block: torch.Tensor) -> None:
        self._slab[idx].copy_(block)

    def read(self, idx: int) -> torch.Tensor:
        return self._slab[idx]

    def read_many(self, idxs: list[int]) -> torch.Tensor:
        return self._slab[torch.as_tensor(idxs, dtype=torch.int64)]

    def nbytes(self) -> int:
        return self._slab.numel() * self._slab.element_size()

    def close(self) -> None:
        pass


class DiskArena:
    """np.memmap slab on local disk with the same geometry as HostArena."""

    def __init__(self, spec: BlockLayoutSpec, capacity: int,
                 path: str) -> None:
        self.spec = spec
        self.capacity = capacity
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._slab = np.memmap(path, dtype=_storage_dtype(spec), mode="w+",
                               shape=(capacity,) + spec.block_shape)

    def write(self, idx: int, block: torch.Tensor) -> None:
        self._slab[idx] = to_numpy(block)

    def read(self, idx: int) -> torch.Tensor:
        # COPY, not a view: a memmap view stays aliased to the slab, and an
        # eviction cascade can recycle this very slot while the caller still
        # holds the data (e.g. disk-hit promotion evicting back into disk).
        return from_numpy(np.array(self._slab[idx]), self.spec)

    def read_many(self, idxs: list[int]) -> torch.Tensor:
        return from_numpy(np.array(self._slab[np.asarray(idxs, np.int64)]),
                          self.spec)

    def nbytes(self) -> int:
        return self._slab.nbytes

    def close(self) -> None:
        del self._slab


class TransientStorageError(Exception):
    """Retryable object-store failure (timeout, 5xx, flaky mount)."""


class FsObjectStoreClient:
    """Filesystem/FUSE-mount client; `root` may be a gcsfuse mountpoint.
    Keys may contain '/' — treated as directory separators under root
    (ObjectStore's keys preserve the original sharded on-disk layout,
    `<2-hex-shard>/v<N>-<hash>.npy`, so pre-existing tiers keep
    resolving). Transient I/O errors (EIO from a flaky mount, timeouts)
    surface as TransientStorageError so the store's retry machinery
    applies; only a clean miss is None."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        if ".." in key or key.startswith("/"):
            raise ValueError(f"unsafe object key {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def put_bytes(self, key: str, data: bytes) -> None:
        path = self._path(key)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic: no partial blobs visible
        except OSError as exc:
            raise TransientStorageError(f"put {key}: {exc}") from exc

    def get_bytes(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None
        except OSError as exc:
            raise TransientStorageError(f"get {key}: {exc}") from exc

    def exists(self, key: str) -> bool:
        # os.stat, not os.path.exists: exists() swallows OSError and
        # would silently report a flaky mount's blobs as absent.
        try:
            os.stat(self._path(key))
            return True
        except FileNotFoundError:
            return False
        except OSError as exc:
            raise TransientStorageError(f"exists {key}: {exc}") from exc

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
        except OSError as exc:
            raise TransientStorageError(f"delete {key}: {exc}") from exc


# --- G4 request signing (SigV4-style; docs/prompt-caching.md §G4 auth) ----
#
# Pinned prefixes only earn a real G4 leg when the object store is an
# authenticated cloud endpoint. The scheme mirrors AWS SigV4's shape —
# canonical string over (method, path, date, payload hash), a
# date-scoped derived key, hex HMAC-SHA256 — without the full
# header-canonicalization surface this client never uses. The verify
# half lives here too so the signature-enforcing stub server in tests
# and any real gateway shim share one implementation.

SIG_ALGORITHM = "DYNT1-HMAC-SHA256"
DATE_HEADER = "x-dynt-date"
CONTENT_SHA_HEADER = "x-dynt-content-sha256"


def _canonical_string(method: str, path: str, date: str,
                      payload_hash: str) -> str:
    return "\n".join((SIG_ALGORITHM, method.upper(), path, date,
                      payload_hash))


def _signing_key(secret: str, datestamp: str) -> bytes:
    import hashlib
    import hmac

    # Date-scoped derived key (SigV4 kDate step): a leaked signature
    # never reveals the long-term secret, and old signatures expire
    # with their date scope.
    return hmac.new(("DYNT1" + secret).encode(), datestamp.encode(),
                    hashlib.sha256).digest()


def sign_request(method: str, path: str, body: Optional[bytes],
                 key_id: str, secret: str,
                 date: Optional[str] = None) -> dict[str, str]:
    """Signed headers for one request. `path` is the URL path
    ("/" + object key)."""
    import hashlib
    import hmac
    import time as _time

    if date is None:
        date = _time.strftime("%Y%m%dT%H%M%SZ", _time.gmtime())
    payload_hash = hashlib.sha256(body or b"").hexdigest()
    sig = hmac.new(
        _signing_key(secret, date[:8]),
        _canonical_string(method, path, date, payload_hash).encode(),
        hashlib.sha256).hexdigest()
    return {
        DATE_HEADER: date,
        CONTENT_SHA_HEADER: payload_hash,
        "Authorization": (f"{SIG_ALGORITHM} Credential={key_id}/{date[:8]}, "
                          f"Signature={sig}"),
    }


def verify_signature(method: str, path: str, body: Optional[bytes],
                     headers, secrets: dict[str, str],
                     max_age_secs: Optional[float] = None,
                     now: Optional[float] = None) -> Optional[str]:
    """Server-side check (the tests' enforcing stub + any gateway shim):
    returns None when the request verifies, else a short reason —
    unsigned / unknown-key / expired / bad-signature / body-mismatch.
    Constant-time signature comparison."""
    import calendar
    import hashlib
    import hmac
    import time as _time

    if max_age_secs is None:
        from ..config import env

        max_age_secs = env("DYNT_G4_SIG_TTL_SECS")
    auth = headers.get("Authorization") or headers.get("authorization")
    date = headers.get(DATE_HEADER) or headers.get(DATE_HEADER.title())
    if not auth or not auth.startswith(SIG_ALGORITHM) or not date:
        return "unsigned"
    try:
        parts = dict(
            kv.strip().split("=", 1)
            for kv in auth[len(SIG_ALGORITHM):].strip().split(","))
        key_id = parts["Credential"].split("/", 1)[0]
        got_sig = parts["Signature"]
        ts = calendar.timegm(_time.strptime(date, "%Y%m%dT%H%M%SZ"))
    except (KeyError, ValueError, IndexError):
        return "bad-signature"
    secret = secrets.get(key_id)
    if secret is None:
        return "unknown-key"
    now = _time.time() if now is None else now
    if abs(now - ts) > max_age_secs:
        return "expired"
    payload_hash = hashlib.sha256(body or b"").hexdigest()
    claimed = headers.get(CONTENT_SHA_HEADER) \
        or headers.get(CONTENT_SHA_HEADER.title())
    if claimed is not None and claimed != payload_hash:
        return "body-mismatch"
    want = hmac.new(
        _signing_key(secret, date[:8]),
        _canonical_string(method, path, date, payload_hash).encode(),
        hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, got_sig):
        return "bad-signature"
    return None


class HttpObjectStoreClient:
    """Native S3/GCS-shaped REST client (stdlib urllib, no
    SDK): blobs live at {base_url}/{key} with PUT / GET / HEAD /
    DELETE, the verb set both S3's REST API and GCS's XML API speak, so
    an endpoint URL pointed at a real bucket gateway (or the in-process
    stub in tests) works unchanged. Error mapping follows the
    ObjectStore contract: connection errors and 5xx/429 become
    TransientStorageError (retryable), 404 is absence, and a body
    shorter than Content-Length is a detected partial read (also
    transient — the caller's corrupt-read path quarantines it). Auth
    (the real-G4 leg): `auth` is None (DYNT_G4_* env decides),
    {"mode": "hmac", "key_id":..., "secret":...} for SigV4-style
    request signing, or {"mode": "bearer", "token":...}. 401/403 stay
    non-transient — a rejected credential must fail loudly, not retry.
    Ref: kvbm-design.md §Remote Memory Integration (NIXL-plugged object
    backends)."""

    def __init__(self, base_url: str, timeout: float = 10.0,
                 auth: Optional[dict] = None) -> None:
        from ..config import env

        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        if auth is None:
            mode = env("DYNT_G4_AUTH")
            if mode == "hmac":
                auth = {"mode": "hmac",
                        "key_id": env("DYNT_G4_HMAC_KEY_ID"),
                        "secret": env("DYNT_G4_HMAC_SECRET")}
            elif mode == "bearer":
                auth = {"mode": "bearer",
                        "token": env("DYNT_G4_BEARER_TOKEN")}
        self.auth = auth

    def _url(self, key: str) -> str:
        if ".." in key or key.startswith("/"):
            raise ValueError(f"unsafe object key {key!r}")
        return f"{self.base_url}/{key}"

    def _auth_headers(self, method: str, key: str,
                      data: Optional[bytes]) -> dict[str, str]:
        if not self.auth:
            return {}
        if self.auth.get("mode") == "bearer":
            return {"Authorization": f"Bearer {self.auth.get('token', '')}"}
        if self.auth.get("mode") == "hmac":
            from urllib.parse import urlsplit

            # Sign the full URL path (base path + key) — what the
            # server sees and verifies.
            base_path = urlsplit(self.base_url).path
            return sign_request(method, f"{base_path}/{key}", data,
                                self.auth.get("key_id", ""),
                                self.auth.get("secret", ""))
        return {}

    def _request(self, method: str, key: str,
                 data: Optional[bytes] = None):
        import http.client
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self._url(key), data=data,
                                     method=method)
        if data is not None:
            req.add_header("Content-Type", "application/octet-stream")
        for name, value in self._auth_headers(method, key, data).items():
            req.add_header(name, value)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = resp.read()
                want = resp.headers.get("Content-Length")
                if (method == "GET" and want is not None
                        and len(body) != int(want)):
                    raise TransientStorageError(
                        f"{method} {key}: partial read "
                        f"({len(body)}/{want} bytes)")
                return resp.status, body
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return 404, b""
            if exc.code in (408, 429) or exc.code >= 500:
                raise TransientStorageError(
                    f"{method} {key}: HTTP {exc.code}") from exc
            raise  # 4xx other than absence/throttle: a caller bug
        except (urllib.error.URLError, TimeoutError, OSError) as exc:
            raise TransientStorageError(
                f"{method} {key}: {exc}") from exc
        except http.client.HTTPException as exc:
            # http.client.IncompleteRead: the connection died mid-body —
            # the same partial-read class as the Content-Length check.
            raise TransientStorageError(
                f"{method} {key}: {exc!r}") from exc

    def put_bytes(self, key: str, data: bytes) -> None:
        self._request("PUT", key, data)

    def get_bytes(self, key: str) -> Optional[bytes]:
        status, body = self._request("GET", key)
        return None if status == 404 else body

    def exists(self, key: str) -> bool:
        status, _ = self._request("HEAD", key)
        return status != 404

    def delete(self, key: str) -> None:
        self._request("DELETE", key)


def encode_block(block: torch.Tensor, spec: BlockLayoutSpec) -> bytes:
    """A block as the `.npy` bytes the reference's `np.save` writes (a bf16
    block's header descr is `'<V2'`, as for an ml_dtypes array)."""
    words = np.ascontiguousarray(to_numpy(block.contiguous()))
    descr = (_BF16_DESCR if spec.dtype == "bfloat16"
             else np.lib.format.dtype_to_descr(words.dtype))
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": descr, "fortran_order": False,
              "shape": tuple(words.shape)})
    buf.write(words.tobytes())
    return buf.getvalue()


def decode_block(data: bytes, spec: BlockLayoutSpec) -> Optional[torch.Tensor]:
    """A blob back into a block, or None when it is truncated, mis-shaped
    or of another dtype. A bf16 layout takes the 2-byte void words its own
    (and the reference's) blobs hold."""
    try:
        arr = np.load(io.BytesIO(data))
    except (ValueError, EOFError, OSError):
        return None
    if arr.shape != spec.block_shape:
        return None
    if spec.dtype == "bfloat16":
        if arr.dtype.kind != "V" or arr.dtype.itemsize != 2:
            return None
        arr = arr.view(np.uint16)
    elif arr.dtype != _storage_dtype(spec):
        return None
    return from_numpy(arr, spec)


class ObjectStore:
    """G4: unbounded blob store keyed by sequence hash, over a pluggable
    CLIENT. The store owns what clients should not: bounded retries on
    transient errors, corrupt/partial-read detection (a non-atomic backend
    can surface truncated objects) and key versioning. `backend` is a root
    path (filesystem / FUSE mount client), an http(s):// URL (the REST
    client), or any object with the put_bytes/get_bytes/exists/delete
    surface."""

    def __init__(self, spec: BlockLayoutSpec, backend,
                 retries: int = 3, backoff: float = 0.05) -> None:
        if isinstance(backend, str) and backend.startswith("gs://"):
            raise NotImplementedError(
                "direct GCS access requires the google-cloud-storage client "
                "(not a dependency of this package); mount the bucket (gcsfuse) and pass "
                "the mountpoint, or point an http(s):// URL at a bucket "
                "REST gateway (HttpObjectStoreClient)")
        self.spec = spec
        if isinstance(backend, str) and backend.startswith(
                ("http://", "https://")):
            self.client = HttpObjectStoreClient(backend)
        elif isinstance(backend, str):
            self.client = FsObjectStoreClient(backend)
        else:
            self.client = backend
        self.retries = retries
        self.backoff = backoff
        self.retried_ops = 0
        self.corrupt_reads = 0
        # G4 is hit from the scheduler (onboard), prefetch, and offload
        # threads at once; the health counters are read-modify-write.
        self._stats_lock = threading.Lock()

    def _key(self, h: int) -> str:
        # Keys carry the block-hash scheme version, so a hash-function
        # change never silently mismatches blobs persisted under the old
        # scheme: <2-hex shard>/v<N>-<hash16>.npy, the reference's layout.
        hexh = f"{h & ((1 << 64) - 1):016x}"
        return f"{hexh[:2]}/v{HASH_VERSION}-{hexh}.npy"

    def _with_retries(self, op):
        import time

        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                return op()
            except TransientStorageError as exc:
                last = exc
                if attempt < self.retries:
                    with self._stats_lock:
                        self.retried_ops += 1
                    time.sleep(self.backoff * (2 ** attempt))
        raise last  # type: ignore[misc]

    def put(self, h: int, block: torch.Tensor,
            fail_fast: bool = False) -> None:
        """fail_fast=True: single attempt, no sleeping retries, for callers
        on the scheduler thread (the eviction cascade under the manager
        lock), where a retry sleep stalls the engine loop."""
        data = encode_block(block, self.spec)
        if fail_fast:
            self.client.put_bytes(self._key(h), data)
            return
        self._with_retries(lambda: self.client.put_bytes(self._key(h), data))

    def get(self, h: int) -> Optional[torch.Tensor]:
        try:
            # SINGLE attempt, no sleeping retries: reads run on the
            # scheduler thread under the manager lock at admission time and
            # degrade to a MISS (prefill compute) rather than stall the
            # engine loop. Sleeping retries are for the offload write path.
            data = self.client.get_bytes(self._key(h))
        except TransientStorageError:
            return None
        if data is None:
            return None
        block = decode_block(data, self.spec)
        if block is None:
            # Truncated, mis-shaped, or wrong-dtype object (a partial write
            # on a non-atomic backend; a tier persisted under another
            # kv_dtype, whose bytes would onboard garbage KV): a MISS, and
            # the bad blob goes so it cannot keep poisoning reads.
            with self._stats_lock:
                self.corrupt_reads += 1
            try:
                self.client.delete(self._key(h))
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
            return None
        return block

    def contains(self, h: int) -> bool:
        try:
            # Single attempt, like get(): runs at admission time.
            return self.client.exists(self._key(h))
        except TransientStorageError:
            return False

    def delete(self, h: int) -> None:
        try:
            self._with_retries(lambda: self.client.delete(self._key(h)))
        except TransientStorageError:
            pass
