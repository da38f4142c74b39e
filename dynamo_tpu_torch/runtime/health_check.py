"""Canary health checks for served endpoints.

Port of `dynamo_tpu/runtime/health_check.py` (ref: lib/runtime/src/
health_check.rs:22-50). An endpoint that has been idle for
`canary_wait_time` gets its synthetic canary request through the full
request plane: loopback through the endpoint's own wire subject, so the
serving loop, codec and handler are all exercised. A canary that errors or
times out marks the endpoint unhealthy (its /health answers 503); after
`max_failures` consecutive failures the instance is deregistered from
discovery, so routers stop sending to it. Lease expiry catches a dead
process; the canary catches a live process with a wedged handler. A
deregistered instance keeps being probed and is re-registered when a
canary passes again.

Handlers opt in by passing `health_check_payload=` to `serve_endpoint`.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

log = logging.getLogger("dynamo_tpu_torch.health_check")


class HealthCheckManager:
    def __init__(self, runtime, canary_wait_time: float = 60.0,
                 check_interval: float = 10.0, canary_timeout: float = 10.0,
                 max_failures: int = 3) -> None:
        self.runtime = runtime
        self.canary_wait_time = canary_wait_time
        self.check_interval = check_interval
        self.canary_timeout = canary_timeout
        self.max_failures = max_failures
        self._failures: dict[int, int] = {}
        self._deregistered: set[int] = set()
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.check_interval)
            await self.check_now()

    async def check_now(self) -> None:
        """One sweep over the runtime's served endpoints."""
        now = time.monotonic()
        for served in list(self.runtime._served):
            if served.health_check_payload is None or served._shutting_down:
                continue
            if (served.instance_id not in self._deregistered
                    and now - served.last_activity < self.canary_wait_time):
                # Live traffic is the health signal; canaries probe idle
                # endpoints only, and deregistered ones always.
                self._failures.pop(served.instance_id, None)
                continue
            await self._probe(served)

    async def _probe(self, served) -> None:
        ok = False
        stream = None
        try:
            stream = self.runtime.request_client.call(
                self.runtime.request_server.address, served.wire_subject,
                served.health_check_payload, {"x-dynt-canary": "1"})

            async def _consume() -> None:
                async for _ in stream:
                    break

            await asyncio.wait_for(_consume(), self.canary_timeout)
            ok = True
        except Exception as exc:  # noqa: BLE001 — any failure is unhealthy
            log.warning("canary failed on %s instance=%x: %r",
                        served.endpoint.subject, served.instance_id, exc)
        finally:
            # Close the canary stream at once: its cancel frame frees the
            # wedged request this canary may just have found.
            if stream is not None:
                try:
                    await stream.aclose()
                except Exception:  # noqa: BLE001 — already unhealthy
                    pass
        iid = served.instance_id
        if ok:
            self._failures.pop(iid, None)
            served.health_ok = True
            if iid in self._deregistered:
                log.info("endpoint %s instance=%x recovered — re-registering",
                         served.endpoint.subject, iid)
                self._deregistered.discard(iid)
                try:
                    await self.runtime.put_leased(served.instance_key,
                                                  served.record)
                except Exception:  # noqa: BLE001 — retried next sweep
                    self._deregistered.add(iid)
            return
        failures = self._failures.get(iid, 0) + 1
        self._failures[iid] = failures
        served.health_ok = False
        if failures >= self.max_failures:
            log.error("endpoint %s instance=%x failed %d canaries — "
                      "deregistering", served.endpoint.subject, iid, failures)
            self._deregistered.add(iid)
            try:
                await self.runtime.delete_leased(served.instance_key)
            except Exception:  # noqa: BLE001 — best-effort deregistration
                pass
