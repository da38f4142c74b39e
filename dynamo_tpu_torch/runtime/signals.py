"""Signal-driven graceful shutdown for the entry points.

Port of `dynamo_tpu/runtime/signals.py`: SIGTERM/SIGINT resolve an event so
a main falls through to its cleanup (deregister, drain in-flight requests,
revoke the lease) instead of dying mid-request. `request_shutdown()`
resolves the same event from code (tests stop a main this way).
"""

from __future__ import annotations

import asyncio
import logging
import signal
from typing import Optional

log = logging.getLogger("dynamo_tpu_torch.signals")

# One event per event loop, keyed by loop so several loops in one process
# (tests) never share a stale event.
_EVENTS: dict[int, tuple[asyncio.AbstractEventLoop, asyncio.Event]] = {}


def _shutdown_event(loop: Optional[asyncio.AbstractEventLoop] = None
                    ) -> asyncio.Event:
    loop = loop or asyncio.get_running_loop()
    key = id(loop)
    entry = _EVENTS.get(key)
    if entry is None:
        entry = (loop, asyncio.Event())
        _EVENTS[key] = entry
        for k, (lp, _ev) in list(_EVENTS.items()):
            if k != key and lp.is_closed():
                del _EVENTS[k]
    return entry[1]


def request_shutdown(reason: str = "requested") -> None:
    """Resolve the running loop's shutdown event."""
    log.info("shutdown requested (%s)", reason)
    _shutdown_event().set()


async def wait_for_shutdown_signal() -> None:
    loop = asyncio.get_running_loop()
    event = _shutdown_event(loop)

    def _handler(signame: str) -> None:
        log.info("received %s — shutting down gracefully", signame)
        event.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, _handler, sig.name)
        except (NotImplementedError, RuntimeError):  # not the main thread
            pass
    await event.wait()
