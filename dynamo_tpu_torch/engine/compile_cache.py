"""Shared compile cache — the compile rung of fast start.

Port of `dynamo_tpu/engine/compile_cache.py`. The port's compile products
are the kernel libraries `nvcc` builds into the build directory
(`ops/_build.build_dir()`: `build/dynamo_tpu_torch/<name>-<hash>.so`, or
DYNT_COMPILE_CACHE_DIR), and a library already there is reused. Spot
arrivals land on fresh hosts, so this module shares that directory through
the G4 object store (DYNT_COMPILE_CACHE_STORE, the fs/http client split of
the weight tree): `sync_down` pulls every published entry absent locally
before anything builds, `sync_up` publishes what this arrival built. An
entry's name carries the hash of its sources and flags, so a download can
never be stale.

Store layout under DYNT_COMPILE_CACHE_PREFIX (default "compile-cache"), as
the reference's:

    index.json          {"entries": [relative cache filename, ...]}
    files/<name>        the cache entry bytes (name /-escaped)

The index is read-merge-written (the union of what it held and what was
uploaded), so two concurrent arrivals publishing disjoint entries converge;
a lost race costs a future rebuild, never correctness.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile

from ..config import env

log = logging.getLogger("dynamo_tpu_torch.compile_cache")

# Partial files: the reference's temporaries, and an nvcc output still
# being written (`ops/_build` writes `<name>-<hash>.<pid>.tmp.so`)
_SKIP_SUFFIXES = (".tmp", ".lock", ".tmp.so")


def cache_dir() -> str:
    from ..ops._build import build_dir

    return str(build_dir())


def _store():
    root = env("DYNT_COMPILE_CACHE_STORE")
    if not root:
        return None
    from ..weights.objstore import make_store_client

    return make_store_client(root)


def _file_key(prefix: str, name: str) -> str:
    # Entries are flat hashed filenames today; escape "/" so a nested
    # layout cannot alias store keys.
    return f"{prefix}/files/{name.replace('/', '%2F')}"


def _local_entries(root: str) -> list[str]:
    out: list[str] = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            if fname.endswith(_SKIP_SUFFIXES):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), root)
            out.append(rel)
    return sorted(out)


def _read_index(store, prefix: str) -> list[str]:
    try:
        raw = store.get_bytes(f"{prefix}/index.json")
    except Exception:  # noqa: BLE001 — transient store error == empty
        log.exception("compile-cache index fetch failed")
        return []
    if raw is None:
        return []
    try:
        entries = json.loads(raw).get("entries", [])
    except ValueError:
        log.warning("corrupt compile-cache index; treating as empty")
        return []
    return [e for e in entries if isinstance(e, str)]


def sync_down(store=None) -> int:
    """Pull store entries absent locally into the cache dir. Returns the
    number downloaded; 0 (never raises) on any store trouble — a cold cache
    just means this arrival builds, it must not fail it."""
    if store is None:
        store = _store()
    if store is None:
        return 0
    root = cache_dir()
    prefix = env("DYNT_COMPILE_CACHE_PREFIX")
    os.makedirs(root, exist_ok=True)
    have = set(_local_entries(root))
    pulled = 0
    for name in _read_index(store, prefix):
        if name in have or os.path.isabs(name) or ".." in name.split("/"):
            continue
        try:
            data = store.get_bytes(_file_key(prefix, name))
        except Exception:  # noqa: BLE001 — skip, best-effort
            log.exception("compile-cache entry fetch failed (%s)", name)
            continue
        if data is None:
            continue
        dest = os.path.join(root, name)
        os.makedirs(os.path.dirname(dest) or root, exist_ok=True)
        # Atomic place: a loader may race a read while the dir warms.
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest) or root,
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, dest)
        except OSError:
            log.exception("compile-cache entry write failed (%s)", name)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
        pulled += 1
    if pulled:
        log.info("compile cache warmed: %d entr%s pulled from the store",
                 pulled, "y" if pulled == 1 else "ies")
    return pulled


def sync_up(store=None) -> int:
    """Publish local entries the store's index does not list, then merge
    the index. Returns the number uploaded; best-effort like sync_down."""
    if store is None:
        store = _store()
    if store is None:
        return 0
    root = cache_dir()
    prefix = env("DYNT_COMPILE_CACHE_PREFIX")
    if not os.path.isdir(root):
        return 0
    local = _local_entries(root)
    indexed = set(_read_index(store, prefix))
    pushed = 0
    for name in local:
        if name in indexed:
            continue
        try:
            with open(os.path.join(root, name), "rb") as f:
                data = f.read()
            store.put_bytes(_file_key(prefix, name), data)
        except Exception:  # noqa: BLE001 — skip, best-effort
            log.exception("compile-cache entry upload failed (%s)", name)
            continue
        indexed.add(name)
        pushed += 1
    if pushed:
        try:
            store.put_bytes(
                f"{prefix}/index.json",
                json.dumps({"entries": sorted(indexed)}).encode())
        except Exception:  # noqa: BLE001
            log.exception("compile-cache index publish failed")
            return pushed
        log.info("compile cache published: %d new entr%s", pushed,
                 "y" if pushed == 1 else "ies")
    return pushed


__all__ = ["cache_dir", "sync_down", "sync_up"]
