"""The serving edge's runtime: discovery, the request plane, endpoints,
routing, metrics and the status server (port of `dynamo_tpu/runtime`), on
the standard library alone."""

from .config import RuntimeConfig
from .distributed import DistributedRuntime
from .health_check import HealthCheckManager

__all__ = ["DistributedRuntime", "HealthCheckManager", "RuntimeConfig"]
