"""Snapshot controller — the CRIU-analog worker startup protocol.

Port of `dynamo_tpu/runtime/snapshot.py`. The engine is prepared before any
runtime connection, so no socket is open at the dump point; the process
signals readiness, blocks until restored, then re-derives its identity and
connects. The expensive startup work (weights on the card, kernels built,
graphs captured) is what an external snapshotter or pre-warm orchestrator
captures or clones at the ready point:

    mode=off   normal startup (prepare + serve in one go)
    mode=dump  prepare the engine -> write <dir>/ready -> block until
               <dir>/restore appears -> serve (fresh runtime identity)

`DYNT_SNAPSHOT_MODE` / `DYNT_SNAPSHOT_DIR` configure it.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

from ..config import env

log = logging.getLogger("dynamo_tpu_torch.snapshot")


class SnapshotController:
    def __init__(self, mode: Optional[str] = None,
                 directory: Optional[str] = None) -> None:
        self.mode = (mode if mode is not None
                     else (env("DYNT_SNAPSHOT_MODE") or "off"))
        self.directory = (directory if directory is not None
                          else (env("DYNT_SNAPSHOT_DIR")
                                or "/tmp/dynamo_tpu_snapshot"))
        if self.mode not in ("off", "dump"):
            raise ValueError(f"bad snapshot mode {self.mode!r} "
                             "(off | dump)")

    @property
    def enabled(self) -> bool:
        return self.mode == "dump"

    @property
    def ready_path(self) -> str:
        return os.path.join(self.directory, "ready")

    @property
    def restore_path(self) -> str:
        return os.path.join(self.directory, "restore")

    def engine_ready(self) -> None:
        """Signal that the engine is fully prepared (weights on the card,
        kernels built) and no runtime connection is open — the point a
        snapshotter captures."""
        os.makedirs(self.directory, exist_ok=True)
        # A restore marker left over from an earlier run would make
        # wait_for_restore return at once — and the snapshotter would dump
        # a process with open sockets. Each ready signal starts clean.
        try:
            os.unlink(self.restore_path)
        except FileNotFoundError:
            pass
        with open(self.ready_path, "w") as f:
            f.write(str(os.getpid()))
        log.info("engine prepared; ready marker at %s — waiting for restore",
                 self.ready_path)

    async def wait_for_restore(self, poll: float = 0.2) -> None:
        """Block until the restore marker appears (written by the
        snapshotter after cloning, or by an operator to continue in
        place)."""
        while not os.path.exists(self.restore_path):
            await asyncio.sleep(poll)
        log.info("restore marker seen; connecting runtime with a fresh "
                 "identity")

    def clear(self) -> None:
        for path in (self.ready_path, self.restore_path):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
