"""Weight service server: shared-memory arenas + unix-socket control RPC.

Port of `dynamo_tpu/weights/service.py`, with the same protocol
(length-prefixed JSON over a unix stream socket; weights never cross the
socket — they move through POSIX shared memory):

    {"cmd": "alloc", "model": m, "params": [{"path", "shape", "dtype"}]}
        -> {"ok": true, "segments": {path: shm_name}, "token": t}
    {"cmd": "commit", "model": m, "token": t}  -> {"ok": true}
    {"cmd": "manifest", "model": m}    -> {"ok": true, "params": [...],
                                           "complete": bool} | {"ok": false}
    {"cmd": "delete", "model": m}      -> {"ok": true}
    {"cmd": "list"}                    -> {"ok": true, "models": [...]}
    {"cmd": "ping"}                    -> {"ok": true}

so a service of either package serves the clients of both. The server is
synchronous and threaded (one small RPC at a time per client); all bulk
data movement is client-side memcpy into the segments. Segment sizes come
from the dtype names through `weights/leaves.py` (bf16 included, without
ml_dtypes). A segment larger than the tmpfs behind /dev/shm is created
sparse, and the first write past its capacity kills the writer with
SIGBUS: check `os.statvfs("/dev/shm")` before publishing a large tree.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import socket
import struct
import threading
import time
import uuid
from multiprocessing import shared_memory
from typing import Optional

from .leaves import itemsize

log = logging.getLogger("dynamo_tpu_torch.weights.service")

# Segments a server in this process created: a client in the same process
# attaches them as they are (see client._attach_shm)
OWNED_SEGMENTS: set[str] = set()


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_msg(sock: socket.socket) -> Optional[dict]:
    header = b""
    while len(header) < 4:
        part = sock.recv(4 - len(header))
        if not part:
            return None
        header += part
    (n,) = struct.unpack(">I", header)
    data = b""
    while len(data) < n:
        part = sock.recv(min(65536, n - len(data)))
        if not part:
            return None
        data += part
    return json.loads(data)


@dataclasses.dataclass
class _Param:
    path: str
    shape: tuple
    dtype: str
    shm: shared_memory.SharedMemory

    def meta(self) -> dict:
        return {"path": self.path, "shape": list(self.shape),
                "dtype": self.dtype, "shm_name": self.shm.name}


@dataclasses.dataclass
class _Arena:
    model: str
    token: str = ""  # alloc ownership: only the allocator may commit
    params: dict[str, _Param] = dataclasses.field(default_factory=dict)
    complete: bool = False

    def nbytes(self) -> int:
        return sum(p.shm.size for p in self.params.values())


class WeightServiceServer:
    def __init__(self, socket_path: str) -> None:
        self.socket_path = socket_path
        self._arenas: dict[str, _Arena] = {}
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- commands ----------------------------------------------------------

    def _cmd_alloc(self, msg: dict) -> dict:
        model = msg["model"]
        with self._lock:
            old = self._arenas.pop(model, None)
            if old is not None:
                self._free_arena(old)
            arena = _Arena(model=model, token=uuid.uuid4().hex)
            segments = {}
            try:
                for spec in msg["params"]:
                    nbytes = (math.prod(spec["shape"]) or 1) * itemsize(
                        spec["dtype"])
                    shm = shared_memory.SharedMemory(
                        create=True, size=max(1, nbytes))
                    OWNED_SEGMENTS.add(shm.name)
                    arena.params[spec["path"]] = _Param(
                        path=spec["path"], shape=tuple(spec["shape"]),
                        dtype=spec["dtype"], shm=shm)
                    segments[spec["path"]] = shm.name
            except Exception as exc:  # noqa: BLE001 — e.g. /dev/shm full
                self._free_arena(arena)
                return {"ok": False, "error": f"alloc failed: {exc}"}
            self._arenas[model] = arena
        log.info("allocated arena for %s: %d params, %.1f MiB",
                 model, len(arena.params), arena.nbytes() / 2**20)
        return {"ok": True, "segments": segments, "token": arena.token}

    def _cmd_commit(self, msg: dict) -> dict:
        with self._lock:
            arena = self._arenas.get(msg["model"])
            if arena is None:
                return {"ok": False, "error": "no such arena"}
            if msg.get("token") != arena.token:
                # A concurrent publisher replaced this arena after the
                # caller's alloc: committing would mark the other writer's
                # half-written segments complete.
                return {"ok": False,
                        "error": "arena replaced by a concurrent publisher"}
            arena.complete = True
        return {"ok": True}

    def _cmd_manifest(self, msg: dict) -> dict:
        with self._lock:
            arena = self._arenas.get(msg["model"])
            if arena is None:
                return {"ok": False, "error": "no such arena"}
            return {"ok": True, "complete": arena.complete,
                    "params": [p.meta() for p in arena.params.values()]}

    def _cmd_delete(self, msg: dict) -> dict:
        with self._lock:
            arena = self._arenas.pop(msg["model"], None)
        if arena is not None:
            self._free_arena(arena)
        return {"ok": True}

    def _cmd_ping(self, _msg: dict) -> dict:
        return {"ok": True}

    def _cmd_list(self, _msg: dict) -> dict:
        with self._lock:
            return {"ok": True, "models": [
                {"model": a.model, "complete": a.complete,
                 "params": len(a.params), "bytes": a.nbytes()}
                for a in self._arenas.values()
            ]}

    @staticmethod
    def _free_arena(arena: _Arena) -> None:
        for p in arena.params.values():
            OWNED_SEGMENTS.discard(p.shm.name)
            try:
                p.shm.close()
                p.shm.unlink()
            except FileNotFoundError:
                pass

    # -- server loop -------------------------------------------------------

    def _handle_client(self, conn: socket.socket) -> None:
        try:
            while True:
                msg = _recv_msg(conn)
                if msg is None:
                    return
                cmd = msg.get("cmd", "")
                if cmd == "stop":
                    _send_msg(conn, {"ok": True})
                    self._stop.set()
                    return
                handler = getattr(self, f"_cmd_{cmd}", None)
                if handler is None:
                    _send_msg(conn, {"ok": False,
                                     "error": f"unknown cmd {cmd!r}"})
                    continue
                try:
                    _send_msg(conn, handler(msg))
                except Exception as exc:  # noqa: BLE001 — report per-RPC
                    _send_msg(conn, {"ok": False, "error": repr(exc)})
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def serve_forever(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(16)
        self._sock.settimeout(0.5)
        log.info("weight service listening on %s", self.socket_path)
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                threading.Thread(target=self._handle_client, args=(conn,),
                                 daemon=True).start()
        finally:
            self._sock.close()
            try:
                os.unlink(self.socket_path)
            except FileNotFoundError:
                pass
            with self._lock:
                for arena in self._arenas.values():
                    self._free_arena(arena)
                self._arenas.clear()

    def start(self) -> None:
        """Run the accept loop on a background thread (in-process mode)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="weight-service")
        self._thread.start()

    def stop(self) -> None:
        """Stop the accept loop; its exit frees every arena."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def serve_in_process(socket_path: str,
                     wait_ready: float = 5.0) -> WeightServiceServer:
    server = WeightServiceServer(socket_path)
    server.start()
    deadline = time.monotonic() + wait_ready
    while not os.path.exists(socket_path) and time.monotonic() < deadline:
        time.sleep(0.01)
    return server


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    from ..config import env

    parser = argparse.ArgumentParser("dynamo_tpu_torch.weights")
    parser.add_argument("--socket", default=None,
                        help="unix socket path (default: "
                             "DYNT_WEIGHT_SERVICE)")
    args = parser.parse_args(argv)
    path = args.socket or env("DYNT_WEIGHT_SERVICE") \
        or "/tmp/dynamo_tpu_weights.sock"
    logging.basicConfig(level=logging.INFO)
    WeightServiceServer(path).serve_forever()
