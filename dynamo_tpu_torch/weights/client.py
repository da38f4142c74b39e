"""Weight service client: store and fetch the port's weight tree through
shared memory.

Port of `dynamo_tpu/weights/client.py`. Bulk data moves by memcpy into and
out of POSIX shared memory; the socket carries only metadata. Fetched
leaves are copies of the segments (host tensors), so they stay valid after
the service frees or replaces its arenas.

`flatten_params` names a `Transformer`'s leaves as the JAX package names
its params pytree's (`jax.tree_util` paths joined by "/", dict keys sorted):
`embed`, `final_norm`, `layers/0/attn_norm`, ..., `lm_head`; a quantized
leaf flattens to the reference's dict (`layers/0/wq/q8`, `.../qs`). With
the same names and bytes, an arena, store entry or stream that one package
published loads into the other.
"""

from __future__ import annotations

import logging
import socket
from multiprocessing import shared_memory
from typing import Callable, Optional, Union

import torch

from ..models import Transformer
from .leaves import dtype_name, to_bytes, torch_dtype
from .service import _recv_msg, _send_msg

log = logging.getLogger("dynamo_tpu_torch.weights.client")

Flat = list[tuple[str, torch.Tensor]]

# Device leaves move through a page-locked buffer of this size: the DMA
# runs at the link's rate and the copy into or out of the segment on the
# CPU's threads, instead of one pageable copy that CUDA stages itself
STAGE_BYTES = 128 * 2**20


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _staged_copy(dst: torch.Tensor, src: torch.Tensor,
                 stage: torch.Tensor) -> None:
    """dst <- src, flat uint8 tensors on either side of the host-device
    link, through the pinned `stage`."""
    for lo in range(0, src.numel(), stage.numel()):
        n = min(stage.numel(), src.numel() - lo)
        stage[:n].copy_(src[lo: lo + n])
        dst[lo: lo + n].copy_(stage[:n])


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach without the resource tracker claiming ownership: on Python
    <= 3.12 a plain attach registers the segment with the client's tracker,
    which unlinks it when the client process dies — destroying the
    service's arena and defeating crash survival. The server alone owns
    segment lifetime. A segment a server in this process created is the
    process tracker's own entry: it is attached as it is, since
    unregistering it would leave the server's unlink without one."""
    from .service import OWNED_SEGMENTS

    if name in OWNED_SEGMENTS:
        return shared_memory.SharedMemory(name=name)
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:  # Python < 3.13: no track kwarg
        shm = shared_memory.SharedMemory(name=name)
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
        except Exception:  # noqa: BLE001 — best-effort untracking
            pass
        return shm


def _tree(model: Transformer) -> dict:
    """The reference's params pytree shape over the model's leaves."""
    def leaf(value):
        return value.leaf() if hasattr(value, "leaf") else value

    tree = {"embed": model.embed, "final_norm": model.final_norm,
            "layers": [{k: leaf(layer[k]) for k in layer.keys()}
                       for layer in model.layers]}
    if model.lm_head is not None:
        tree["lm_head"] = leaf(model.lm_head)
    return tree


def _walk(node, prefix: str, out: list) -> None:
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], f"{prefix}/{key}" if prefix else key, out)
    elif isinstance(node, (list, tuple)):
        for i, value in enumerate(node):
            _walk(value, f"{prefix}/{i}" if prefix else str(i), out)
    else:
        out.append((prefix, node))


def flatten_params(params: Transformer) -> Flat:
    """Stable path-addressed flattening of the model's leaves, in the JAX
    package's order. The tensors are the model's own (on its device)."""
    out: list = []
    _walk(_tree(params), "", out)
    return [(path, leaf.detach()) for path, leaf in out]


def unflatten_like(template: Transformer,
                   flat: dict[str, torch.Tensor]) -> Transformer:
    """A `Transformer` shaped like `template` (which may live on the meta
    device) over path-addressed leaves. Every leaf's shape and dtype is
    checked against the template's — a stale arena from an older model
    config must fail here, where callers fall down the ladder, not inside
    a forward. Raises KeyError on any mismatch; leaves stay where `flat`
    holds them."""
    tree: dict = {"layers": [dict() for _ in template.layers]}
    for key, tmpl_leaf in flatten_params(template):
        if key not in flat:
            raise KeyError(f"weight arena is missing parameter {key!r}")
        leaf = flat[key]
        want_shape = tuple(tmpl_leaf.shape)
        if (tuple(leaf.shape) != want_shape
                or dtype_name(leaf) != dtype_name(tmpl_leaf)):
            raise KeyError(
                f"weight arena parameter {key!r} is {tuple(leaf.shape)}/"
                f"{dtype_name(leaf)}, model expects {want_shape}/"
                f"{dtype_name(tmpl_leaf)}")
        parts = key.split("/")
        if parts[0] == "layers":
            tree["layers"][int(parts[1])][parts[2]] = leaf
        else:
            tree[parts[0]] = leaf
    return Transformer(template.config, tree)


class WeightClient:
    def __init__(self, socket_path: str, timeout: float = 30.0) -> None:
        self.socket_path = socket_path
        self.timeout = timeout

    def _rpc(self, msg: dict) -> dict:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        try:
            sock.connect(self.socket_path)
            _send_msg(sock, msg)
            reply = _recv_msg(sock)
            if reply is None:
                raise ConnectionError("weight service closed the connection")
            return reply
        finally:
            sock.close()

    def ping(self) -> bool:
        try:
            return bool(self._rpc({"cmd": "ping"}).get("ok"))
        except (OSError, ConnectionError):
            return False

    def list(self) -> list[dict]:
        return self._rpc({"cmd": "list"}).get("models", [])

    def delete(self, model: str) -> None:
        self._rpc({"cmd": "delete", "model": model})

    def store(self, model: str, params: Union[Transformer, Flat]) -> None:
        """Publish a weight tree (a Transformer on any device, or its
        flattening) into the service's shared-memory arenas. A device leaf
        is copied straight into its segment."""
        flat = (flatten_params(params) if isinstance(params, Transformer)
                else params)
        reply = self._rpc({
            "cmd": "alloc", "model": model,
            "params": [{"path": k, "shape": list(a.shape),
                        "dtype": dtype_name(a)} for k, a in flat],
        })
        if not reply.get("ok"):
            raise RuntimeError(f"weight alloc failed: {reply.get('error')}")
        segments = reply["segments"]
        token = reply.get("token", "")
        stage = None
        for key, arr in flat:
            shm = _attach_shm(segments[key])
            try:
                if isinstance(arr, torch.Tensor):
                    view = torch.frombuffer(
                        shm.buf, dtype=torch.uint8,
                        count=arr.numel() * arr.element_size())
                    if arr.device.type == "cpu":
                        view.copy_(_bytes(arr))
                    else:
                        if stage is None:
                            stage = torch.empty(STAGE_BYTES,
                                                dtype=torch.uint8,
                                                pin_memory=True)
                        _staged_copy(view, _bytes(arr), stage)
                    del view
                else:
                    data = to_bytes(arr)
                    shm.buf[:len(data)] = data
            finally:
                shm.close()
        reply = self._rpc({"cmd": "commit", "model": model, "token": token})
        if not reply.get("ok"):
            raise RuntimeError(f"weight commit failed: {reply.get('error')}")
        log.info("published %d params for %s to the weight service",
                 len(flat), model)

    def fetch(self, model: str, device: Optional[torch.device] = None
              ) -> Optional[dict[str, torch.Tensor]]:
        """Path-addressed tensors, or None if absent or incomplete: host
        copies, or with `device` each segment copied straight to the device
        (no host copy between the segment and the card)."""
        try:
            reply = self._rpc({"cmd": "manifest", "model": model})
        except (OSError, ConnectionError):
            return None
        if not reply.get("ok") or not reply.get("complete"):
            return None
        copy_to_host = device is None or torch.device(device).type == "cpu"
        stage = (None if copy_to_host else torch.empty(
            STAGE_BYTES, dtype=torch.uint8, pin_memory=True))
        out: dict[str, torch.Tensor] = {}
        try:
            for meta in reply["params"]:
                shm = _attach_shm(meta["shm_name"])
                try:
                    dtype = torch_dtype(meta["dtype"])
                    shape = tuple(meta["shape"])
                    count = torch.Size(shape).numel() * dtype.itemsize
                    view = torch.frombuffer(shm.buf, dtype=torch.uint8,
                                            count=count)
                    if copy_to_host:
                        leaf = view.clone()  # own the memory
                    else:
                        leaf = torch.empty(count, dtype=torch.uint8,
                                           device=device)
                        _staged_copy(leaf, view, stage)
                    out[meta["path"]] = leaf.view(dtype).view(shape)
                    del view
                finally:
                    shm.close()
        except (FileNotFoundError, ValueError) as exc:
            # Arena freed or replaced between manifest and attach
            # (concurrent store/delete): the fast path just misses — callers
            # fall down the ladder, they must never crash on it.
            log.warning("weight arena vanished mid-fetch (%r)", exc)
            return None
        return out

    def load_or_init(self, model: str, template: Transformer,
                     init_fn: Callable[[], Transformer]):
        """Attach the published weights if the service has them (crash
        survival, warm restart), else run `init_fn` (init or checkpoint
        read) and publish the result. Returns (Transformer, from_service)."""
        flat = self.fetch(model)
        if flat is not None:
            try:
                return unflatten_like(template, flat), True
            except KeyError as exc:
                log.warning("weight arena mismatch (%s); reinitializing", exc)
        params = init_fn()
        try:
            self.store(model, params)
        except (OSError, ConnectionError, RuntimeError) as exc:
            log.warning("weight publish failed (%r); continuing without "
                        "crash survival", exc)
        return params, False
