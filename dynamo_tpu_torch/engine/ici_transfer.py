"""The in-process KV bridge for co-located disaggregation (`--mode comesh`).

Port of `split_mesh` and `IciKvBridge` in `dynamo_tpu/engine/ici_transfer.py`.
There a prefill pool and a decode pool run in one process on disjoint
sub-meshes of a TPU slice, and a prompt's pages move between them device to
device over ICI instead of through the host relay (`llm/kv_transfer.py`).
Here the pools are two runners in one process, each on its own CUDA device
(`split_devices`), or both on one card: a gather from the prefill pool, a
device-to-device copy (a peer copy across two cards, nothing on one card),
and an in-place scatter into the decode pool at admission. No byte goes
through the host.

Each stage runs on the thread that owns the buffer it touches:

  1. gather  - the prefill scheduler thread, in its dispatch/drain gap
               (`run_in_gap`): a fresh bundle queued on the step stream
               behind the writes it reads; prefill stepping goes on at once
  2. copy    - `bundle.to(decode device, non_blocking=True)` on a side
               stream that waits on the gather's event, off both scheduler
               threads (on one card the bundle stays where it is)
  3. scatter - the decode scheduler thread at admission, in place: the
               decode runner's CUDA graphs captured its pool's storage

The transfer's pages return to the prefill pool as soon as the gathers have
made their copies, not after admission. Any failure degrades to recomputing
the prefill, as the host relay's does, and counts as `pulls - hits`.

The host relay stays the link between pools that share no process, and a
drain handoff never takes the bridge (the worker drops the token). Not
ported: `ppermute_kv_handoff`, the union-mesh collective form, which needs
several devices in one program.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import Optional, Sequence

import torch

from .model_runner import DeviceBundle

log = logging.getLogger("dynamo_tpu_torch.ici_transfer")


def split_devices(
    prefill_devices: int,
    decode_devices: int,
    prefill_tp: Optional[int] = None,
    decode_tp: Optional[int] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> tuple[list[torch.device], list[torch.device]]:
    """Partition the local devices (the CUDA cards by default) into disjoint
    prefill and decode lists, as `split_mesh` partitions a slice. The count
    check and its message are the reference's. A pool is one device: tensor
    parallelism inside a pool (more than one device, or tp > 1) is not
    ported and raises."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    need = prefill_devices + decode_devices
    if len(devices) < need:
        raise ValueError(
            f"co-meshed disagg needs {need} devices "
            f"({prefill_devices}P + {decode_devices}D); have {len(devices)}")
    for pool, n, tp in (("prefill", prefill_devices, prefill_tp),
                        ("decode", decode_devices, decode_tp)):
        if (tp or n) > 1:
            raise ValueError(
                f"the {pool} pool spans {tp or n} devices: tensor "
                "parallelism inside a pool is not ported (one device a pool)")
    return list(devices[:prefill_devices]), list(devices[prefill_devices:need])


class IciKvBridge:
    """In-process broker for direct prefill -> decode page movement.

    One bridge per comesh process. The prefill side advertises `token` in
    its kv_transfer_params (`bridge_token`); a decode worker holding the same
    bridge pulls through it instead of over the wire. `pulls` counts the
    attempts and `hits` the bundles delivered."""

    def __init__(self) -> None:
        self.token = uuid.uuid4().hex
        self._prefill = None  # the prefill side's TorchWorker
        self.pulls = 0
        self.hits = 0
        self._streams: dict = {}  # decode device -> its copy stream

    def attach_prefill(self, worker) -> None:
        self._prefill = worker

    def _copy_stream(self, device: torch.device) -> "torch.cuda.Stream":
        key = torch.device(device).index
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(device)
        return self._streams[key]

    def _move(self, bundle: DeviceBundle, device: torch.device
              ) -> DeviceBundle:
        """The gathered bundle on the decode device: a copy on a side stream
        behind the gather's event (a peer copy between two cards; the same
        tensor on one card). The returned event marks its end."""
        tensor = bundle.tensor
        if tensor.device.type != "cuda":
            return DeviceBundle(tensor.to(device), None)
        stream = self._copy_stream(device)
        with torch.cuda.stream(stream):
            if bundle.ready is not None:
                stream.wait_event(bundle.ready)
            moved = tensor.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        # the side stream reads the source; the decode step stream reads
        # the copy (its scatter): neither block may be reused before
        tensor.record_stream(stream)
        if moved is not tensor:
            moved.record_stream(torch.cuda.current_stream(moved.device))
        return DeviceBundle(moved, event)

    def _join(self, parts: list, device: torch.device) -> DeviceBundle:
        """One bundle from a transfer's chunks, complete on the device when
        this returns (a worker thread waits, no scheduler thread does)."""
        if len(parts) == 1:
            bundle = parts[0]
        elif parts[0].tensor.device.type != "cuda":
            bundle = DeviceBundle(torch.cat([p.tensor for p in parts]), None)
        else:
            stream = self._copy_stream(device)
            with torch.cuda.stream(stream):
                for part in parts:
                    if part.ready is not None:
                        stream.wait_event(part.ready)
                tensor = torch.cat([p.tensor for p in parts])
                event = torch.cuda.Event()
                event.record(stream)
            tensor.record_stream(torch.cuda.current_stream(tensor.device))
            bundle = DeviceBundle(tensor, event)
        if bundle.ready is not None:
            bundle.ready.synchronize()
        return bundle

    async def pull(self, transfer_id: str, decode_runner,
                   timings: Optional[dict] = None
                   ) -> tuple[Optional[DeviceBundle], Optional[int]]:
        """Claim a parked transfer and return (bundle, first_token) with the
        bundle on the decode runner's device, or (None, None): the caller
        recomputes the prefill, the fallback the host relay takes. A
        streaming transfer is pulled chunk by chunk: chunk i's gather and
        copy run while the prefill pool computes chunk i+1, and the first
        token comes with the finished transfer. `timings`, when given,
        receives the pull's split in ms: `wait_ms` until the first pages
        were ready, `gather_ms` waiting on the prefill scheduler's gathers,
        `copy_ms` joining and completing the bundle, and `chunks`."""
        self.pulls += 1
        worker = self._prefill
        if worker is None:
            log.warning("ici pull with no prefill side attached")
            return None, None
        transfer = worker.transfers.claim(transfer_id)
        if transfer is None:
            log.warning("ici pull: unknown transfer %s", transfer_id)
            return None, None
        first_token = getattr(transfer, "first_token", None)
        spent = {"wait_ms": 0.0, "gather_ms": 0.0, "copy_ms": 0.0,
                 "chunks": 0}
        start = time.monotonic()
        parts: list[DeviceBundle] = []

        async def gather_move(ids: list[int]) -> bool:
            """Gather `ids` on the prefill scheduler (gap window), then
            start the copy; False: the caller recomputes."""
            if not parts:
                spent["wait_ms"] = (time.monotonic() - start) * 1e3
            t0 = time.monotonic()
            result = worker.scheduler.run_in_gap(
                lambda: worker.runner.gather_pages_device(ids))
            try:
                bundle, exc = await asyncio.to_thread(result.get, True, 60.0)
            except Exception as exc_:  # noqa: BLE001 — queue.Empty
                log.warning("ici gather timed out: %r", exc_)
                return False
            spent["gather_ms"] += (time.monotonic() - t0) * 1e3
            if exc is not None:
                log.warning("ici gather failed: %r", exc)
                return False
            try:
                parts.append(self._move(bundle, decode_runner.device))
            except Exception as exc_:  # noqa: BLE001 — degrade to recompute
                log.warning("ici copy failed (%r); recomputing prefill",
                            exc_)
                return False
            spent["chunks"] += 1
            return True

        try:
            if transfer.streaming:
                sent = 0
                # A stall window re-armed on every chunk of progress: a long
                # prompt may prefill for minutes beside other sequences;
                # only a 120 s lull with no new pages gives up.
                deadline = time.monotonic() + 120.0
                while True:
                    ids, done, failed = await asyncio.to_thread(
                        transfer.wait_ready, sent, 1.0)
                    if failed:
                        log.warning("ici pull: transfer %s aborted",
                                    transfer_id[:8])
                        return None, None
                    new = ids[sent:]
                    if not new and not done:
                        if time.monotonic() > deadline:
                            log.warning("ici pull timed out awaiting "
                                        "prefill chunks")
                            return None, None
                        continue
                    if new:
                        if not await gather_move(list(new)):
                            return None, None
                        sent += len(new)
                        deadline = time.monotonic() + 120.0
                    if done and sent >= len(ids):
                        first_token = transfer.first_token
                        break
            elif not await gather_move(list(transfer.page_ids)):
                return None, None
        finally:
            # the pages go back to the prefill pool as soon as the gathers
            # have made their copies (or failed), not after admission
            transfer.release()
        t0 = time.monotonic()
        try:
            dst = await asyncio.to_thread(self._join, parts,
                                          decode_runner.device)
        except Exception as exc:  # noqa: BLE001 — any failure recomputes
            log.warning("ici join failed (%r); recomputing prefill", exc)
            return None, None
        spent["copy_ms"] = (time.monotonic() - t0) * 1e3
        if timings is not None:
            timings.update(spent)
        self.hits += 1
        log.info("ici bridge pull %s: %d pages moved prefill->decode on "
                 "the device (%d chunk(s))", transfer_id[:8],
                 int(dst.tensor.shape[0]), len(parts))
        return dst, first_token
