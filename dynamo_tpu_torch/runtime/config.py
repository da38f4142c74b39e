"""Resolved runtime configuration.

Port of the `RuntimeConfig` part of `dynamo_tpu/runtime/config.py`: the same
DYNT_* names, defaults and parsing, read through this package's registry
(`dynamo_tpu_torch/config.py`). The etcd field is not carried: etcd
discovery is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..config import env


@dataclasses.dataclass
class RuntimeConfig:
    """Resolved runtime configuration (ref: DistributedConfig::from_settings,
    lib/runtime/src/distributed.rs:540)."""

    discovery_backend: str = "file"
    discovery_path: str = "/tmp/dynamo_tpu_discovery"
    lease_ttl_secs: float = 10.0
    request_plane: str = "tcp"
    tcp_host: str = "0.0.0.0"
    tcp_advertise_host: str = "127.0.0.1"
    tcp_port: int = 0
    request_timeout_secs: float = 600.0
    connect_timeout_secs: float = 5.0
    system_port: int = 0
    system_enabled: bool = True
    event_plane: str = "zmq"
    zmq_host: str = "127.0.0.1"
    event_journal_path: str = "/tmp/dynamo_tpu_events"
    event_journal_max_mb: int = 64

    @classmethod
    def from_env(cls, **overrides: Any) -> "RuntimeConfig":
        cfg = cls(
            discovery_backend=env("DYNT_DISCOVERY_BACKEND"),
            discovery_path=env("DYNT_DISCOVERY_PATH"),
            lease_ttl_secs=env("DYNT_LEASE_TTL_SECS"),
            request_plane=env("DYNT_REQUEST_PLANE"),
            tcp_host=env("DYNT_TCP_HOST"),
            tcp_advertise_host=env("DYNT_TCP_ADVERTISE_HOST"),
            tcp_port=env("DYNT_TCP_PORT"),
            request_timeout_secs=env("DYNT_REQUEST_TIMEOUT_SECS"),
            connect_timeout_secs=env("DYNT_CONNECT_TIMEOUT_SECS"),
            system_port=env("DYNT_SYSTEM_PORT"),
            system_enabled=env("DYNT_SYSTEM_ENABLED"),
            event_plane=env("DYNT_EVENT_PLANE"),
            zmq_host=env("DYNT_ZMQ_HOST"),
            event_journal_path=env("DYNT_EVENT_JOURNAL_PATH"),
            event_journal_max_mb=env("DYNT_EVENT_JOURNAL_MAX_MB"),
        )
        for key, val in overrides.items():
            if val is not None:
                setattr(cfg, key, val)
        return cfg
