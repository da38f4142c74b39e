"""Accelerator specifications for the analytical performance model.

Port of `dynamo_tpu/profiler/chips.py`, with the card this package runs
on: public per-device numbers (dense bf16 peak, memory size and rate,
interconnect rate) from NVIDIA's H100 SXM data sheet. The `cpu` entry is
the fallback where no card is found (tests, development boxes), so the
gauges built on it always publish something comparable.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float  # peak dense bf16 TFLOP/s
    hbm_gib: float
    hbm_gbps: float  # GB/s
    ici_gbps: float  # interconnect rate to a peer device, each way (GB/s)


CHIPS = {
    # NVIDIA H100 SXM: 989 TFLOP/s dense bf16, 80 GB of HBM3 at 3.35 TB/s,
    # NVLink 900 GB/s to the other cards of a host (450 GB/s each way)
    "h100": ChipSpec("h100", 989.0, 80.0, 3350.0, 450.0),
    # CPU fallback so the model runs anywhere (tests, development boxes)
    "cpu": ChipSpec("cpu", 0.5, 8.0, 50.0, 10.0),
}


def get_chip(name: str) -> ChipSpec:
    key = name.lower().replace(" ", "")
    if key in CHIPS:
        return CHIPS[key]
    raise ValueError(f"unknown chip {name!r}; one of {sorted(CHIPS)}")
