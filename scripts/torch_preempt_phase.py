"""Priority classes and preemption alone on one card: `chip_smoke.py`'s
preempt phase.

    python3 scripts/torch_preempt_phase.py

Builds the kernels, serves the W4A16 + int8 KV engine wave on mistral-7b
(`chip_smoke.phase_engine`, prewarmed), then `chip_smoke.phase_preempt` on
its weights: 16 batch streams and 4 interactive arrivals, with preemption
on (4 parks to a KVBM park store and 4 resumes), off, the batch alone, and
over HTTP with no KVBM (4 cooperative migrates). Prints the card's name and
power limit, the phases' JSON lines and the launch counts. ~3 minutes of
card time. Needs a CUDA card; exits non-zero without one.
"""

import faulthandler
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_preempt_phase: no CUDA card")
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engine import RunnerConfig

    faulthandler.dump_traceback_later(600, exit=True)
    t0 = time.perf_counter()
    dev = resolve_device("cuda")
    print(c.nvidia_smi(), flush=True)
    c.phase_build()
    worker, _, _ = c.phase_engine(
        dev, c.QMODEL, RunnerConfig(weight_dtype="int4", kv_dtype="int8"),
        label="engine_q", prewarm=True)
    try:
        print("preempt launches", c.phase_preempt(dev, worker), flush=True)
    finally:
        worker.close()
    faulthandler.cancel_dump_traceback_later()
    print("seconds", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
