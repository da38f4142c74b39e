"""KV handoff between pools: layout descriptors and the transfer protocol.

Port of `dynamo_tpu/llm/kv_transfer.py`. A prefill worker (or a draining
worker) parks a sequence's pages in a `PendingTransferTable`; a peer pulls
them over the owner's `kv_pull` endpoint as chunked binary frames and
reassembles them with a `BlockAssembler`:

    pool --(gather, one D2H copy)--> host --(request plane, frames)-->
    peer host --(one H2D copy, indexed write)--> pool

The frames are the reference's, byte for byte, so either package pulls from
the other. Two repairs:

  * Payloads travel as raw bytes and the descriptor's dtype name maps to a
    torch dtype here (`TORCH_DTYPES`): numpy has no bfloat16 without
    `ml_dtypes`. `BlockAssembler.assemble` returns a CPU tensor.
  * A packed int8 bundle (`kv_dtype="int8"`: value bytes, then bf16 scale
    rows over `scale_lanes` lanes; `ops/block_copy.py`) is sized and
    assembled by its byte geometry. The reference sizes `page_bytes` by
    the layout dtype and assembles every bundle as that dtype over
    `[n, L, 2, ps, kh, hd]`, which raises `ValueError` on a packed bundle.

The reference's `conformance.observe` calls (its protocol conformance
recorder, `runtime/conformance.py`) have no counterpart: that module is not
ported.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

# Target bytes per kv_pull response frame (well under the codec's MAX_FRAME).
TRANSFER_CHUNK_BYTES = 4 << 20

# Wire dtype names (numpy's, as the reference writes them) -> torch dtypes.
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32, "uint8": torch.uint8}


@dataclasses.dataclass
class KvLayoutDescriptor:
    """Serialized block-layout metadata exchanged between pools."""

    n_layers: int
    kv_heads: int
    head_dim: int
    page_size: int
    dtype: str  # numpy dtype name of the model's KV (the payload's, unpacked)
    kv_dims: int = 2  # 2 for separate K/V stacks, 1 for an MLA latent cache
    # Quantized pools stamp their scheme, so a packed pool never pairs with
    # a bf16 one (compatible() compares the whole descriptor).
    kv_dtype: str = "model"
    scale_lanes: int = 0

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, data: dict) -> "KvLayoutDescriptor":
        return cls(**{f.name: data[f.name]
                      for f in dataclasses.fields(cls) if f.name in data})

    @property
    def packed(self) -> bool:
        return self.kv_dtype == "int8"

    def page_bytes(self) -> int:
        """Bytes of one page on the wire: packed int8 pages count their
        value bytes and their scale rows."""
        tokens = self.n_layers * self.kv_dims * self.page_size
        if self.packed:
            return tokens * (self.kv_heads * self.head_dim
                             + self.scale_lanes * 2)
        itemsize = torch.empty(0, dtype=TORCH_DTYPES[self.dtype]).element_size()
        return tokens * self.kv_heads * self.head_dim * itemsize

    def page_shape(self) -> tuple:
        """One page of an assembled bundle: [L, kv_dims, ps, kh, hd], or
        [page_bytes] uint8 for a packed int8 page."""
        if self.packed:
            return (self.page_bytes(),)
        return (self.n_layers, self.kv_dims, self.page_size, self.kv_heads,
                self.head_dim)

    def torch_dtype(self) -> torch.dtype:
        return torch.uint8 if self.packed else TORCH_DTYPES[self.dtype]

    def compatible(self, other: "KvLayoutDescriptor") -> bool:
        return self == other


@dataclasses.dataclass
class PendingTransfer:
    transfer_id: str
    page_ids: list[int]  # physical pages in the owner's pool, page order
    release: Callable[[], None]  # returns the pages to the owner's pool
    layout: KvLayoutDescriptor
    prompt_len: int
    created_at: float = dataclasses.field(default_factory=time.monotonic)

    @property
    def streaming(self) -> bool:
        return False


class StreamingTransfer(PendingTransfer):
    """A transfer registered while its prompt is still prefilling: the
    prefill scheduler appends page ids per completed chunk and finishes with
    the first sampled token; the pull side waits on the chunk condition and
    streams pages as they become ready (chunk i moves while chunk i+1
    computes).

    append/finish/fail run on the prefill scheduler thread, wait_ready on a
    puller thread; one condition serializes them. `fail` claims the table
    entry itself, so release runs exactly once whether or not a puller ever
    arrived."""

    def __init__(self, *args, table: "PendingTransferTable", **kwargs):
        super().__init__(*args, **kwargs)
        self._table = table
        self._cond = threading.Condition()
        self.done = False
        self.failed = False
        self.first_token: Optional[int] = None

    @property
    def streaming(self) -> bool:
        return True

    @property
    def total_pages(self) -> int:
        return -(-self.prompt_len // self.layout.page_size)

    def append_pages(self, page_ids: list[int]) -> None:
        with self._cond:
            if self.done or self.failed:
                # finish pinned the final list, or fail released the pages
                # (appending would advertise pages the pool may reissue)
                return
            self.page_ids.extend(int(p) for p in page_ids)
            self._cond.notify_all()

    def finish(self, first_token: int, all_page_ids: list[int]) -> None:
        """Prompt pass complete: pin the final page list (with the partial
        last page) and publish the first sampled token. The TTL clock
        restarts here, so a prompt that prefilled longer than the TTL does
        not become expirable the instant it completes."""
        with self._cond:
            if self.failed or self.done:
                return  # the first terminal event wins
            self.page_ids = [int(p) for p in all_page_ids]
            self.first_token = int(first_token)
            self.done = True
            self.created_at = time.monotonic()
            self._cond.notify_all()

    def fail(self) -> None:
        """Prefill died mid-stream (cancel or error): wake waiters with the
        failure and release the pages iff no puller claimed the entry."""
        with self._cond:
            if self.done or self.failed:
                # done: a completed prompt pass is a valid transfer whose
                # TTL owns the release; failed: already released
                return
            self.failed = True
            self._cond.notify_all()
        if self._table.claim(self.transfer_id) is not None:
            self.release()  # no puller will ever release: we must

    def wait_ready(self, have: int, timeout: float
                   ) -> tuple[list[int], bool, bool]:
        """Block until more than `have` pages are parked, the transfer is
        done, or it failed. Returns (page_ids snapshot, done, failed); a
        timeout returns the unchanged snapshot."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while (len(self.page_ids) <= have and not self.done
                   and not self.failed):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=min(0.2, remaining))
            return list(self.page_ids), self.done, self.failed


class PendingTransferTable:
    """The owner's registry of parked transfers. Entries hold their pages
    until pulled or expired (TTL `ttl_secs`).

    Thread-safe: `add` runs on the scheduler thread, pulls and expiry on the
    event loop. A pull `claim`s its entry (removing it atomically), so
    expiry never releases pages a gather is reading; the claimer owns
    exactly one release."""

    def __init__(self, ttl_secs: float = 120.0) -> None:
        self.ttl_secs = ttl_secs
        self._table: dict[str, PendingTransfer] = {}
        self._lock = threading.Lock()

    def add(self, transfer: PendingTransfer) -> None:
        with self._lock:
            self._table[transfer.transfer_id] = transfer

    def claim(self, transfer_id: str) -> Optional[PendingTransfer]:
        """Atomically take ownership of an entry. The caller must call
        `.release()` exactly once when done with the pages."""
        with self._lock:
            return self._table.pop(transfer_id, None)

    def expire_stale(self) -> int:
        now = time.monotonic()
        with self._lock:
            # A streaming transfer whose prompt pass still runs is never
            # stale: its pages belong to a live sequence.
            stale = [tid for tid, t in self._table.items()
                     if now - t.created_at > self.ttl_secs
                     and not (t.streaming and not getattr(t, "done", True))]
            claimed = [self._table.pop(tid) for tid in stale]
        for transfer in claimed:
            transfer.release()
        return len(claimed)

    def expire_all(self) -> int:
        """Force-expire every unclaimed entry (the drain deadline: parked
        handoff pages a peer never pulled release before the worker
        deregisters). Claims atomically, like expire_stale."""
        with self._lock:
            claimed = list(self._table.values())
            self._table.clear()
        for transfer in claimed:
            transfer.release()
        return len(claimed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)


def raw_bytes(blocks: torch.Tensor) -> bytes:
    """A bundle's bytes in memory order (any dtype, bf16 too)."""
    t = blocks.detach().cpu().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def encode_block_chunks(
    blocks: torch.Tensor,  # [n, ...] bundle on the host, page-major
    layout: KvLayoutDescriptor,
    base: int = 0,
    total_pages: Optional[int] = None,
) -> Iterator[dict]:
    """Chunk a bundle into wire frames: dicts with raw bytes, about
    TRANSFER_CHUNK_BYTES each. A streamed handoff encodes slices of the
    transfer as they become ready: `base` is this slice's first page and
    `total_pages` the final page count (the assembler then counts pages,
    since the chunk count is unknown while prefill still runs)."""
    n = blocks.shape[0]
    pages_per_chunk = max(1, TRANSFER_CHUNK_BYTES
                          // max(1, layout.page_bytes()))
    total_chunks = -(-n // pages_per_chunk)
    for ci in range(total_chunks):
        lo = ci * pages_per_chunk
        hi = min(n, lo + pages_per_chunk)
        frame = {
            "chunk": ci,
            "total_chunks": total_chunks,
            "page_start": base + lo,
            "page_count": hi - lo,
            "layout": layout.to_wire(),
            "data": raw_bytes(blocks[lo:hi]),
        }
        if total_pages is not None:
            frame["total_pages"] = total_pages
        yield frame


class BlockAssembler:
    """Puller-side reassembly of frames into one bundle. Streamed frames
    (`total_pages`) complete when every page arrived; classic frames at
    `total_chunks` frames."""

    def __init__(self) -> None:
        self._chunks: dict[int, tuple[int, int, bytes]] = {}  # by page_start
        self._layout: Optional[KvLayoutDescriptor] = None
        self._total: Optional[int] = None
        self._total_pages: Optional[int] = None

    def add(self, frame: dict) -> None:
        layout = KvLayoutDescriptor.from_wire(frame["layout"])
        if self._layout is None:
            self._layout = layout
        elif not self._layout.compatible(layout):
            raise ValueError("layout changed mid-transfer")
        if frame.get("total_pages") is not None:
            self._total_pages = int(frame["total_pages"])
        else:
            self._total = frame["total_chunks"]
        self._chunks[frame["page_start"]] = (
            frame["page_start"], frame["page_count"], frame["data"])

    @property
    def pages(self) -> int:
        return sum(c[1] for c in self._chunks.values())

    @property
    def complete(self) -> bool:
        if self._total_pages is not None:
            return self.pages >= self._total_pages
        return self._total is not None and len(self._chunks) == self._total

    def assemble(self) -> tuple[torch.Tensor, KvLayoutDescriptor]:
        """The bundle as a CPU tensor: [n, L, 2, ps, kh, hd] of the layout's
        dtype, or [n, page_bytes] uint8 for packed int8 pages. Raises
        ValueError on an incomplete transfer or a frame whose bytes do not
        fit the layout."""
        if not self.complete:
            raise ValueError("transfer incomplete")
        layout = self._layout
        page_bytes = layout.page_bytes()
        raw = np.empty((self.pages, page_bytes), np.uint8)
        for start, count, data in self._chunks.values():
            if len(data) != count * page_bytes:
                raise ValueError(
                    f"frame at page {start} holds {len(data)} bytes, not "
                    f"{count} pages of {page_bytes}")
            raw[start:start + count] = np.frombuffer(
                data, np.uint8).reshape(count, page_bytes)
        out = torch.from_numpy(raw).view(layout.torch_dtype())
        return out.reshape((self.pages,) + layout.page_shape()), layout
