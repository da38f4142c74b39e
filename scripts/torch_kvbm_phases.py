"""The KVBM tiers alone on one card: `chip_smoke.py`'s kvbm phases.

    python3 scripts/torch_kvbm_phases.py

Builds the kernels, serves the W4A16 + int8 KV engine wave on mistral-7b
(`chip_smoke.phase_engine`, prewarmed), then `chip_smoke.phase_kvbm` on its
weights (G2 128 pinned blocks, G3 64, G4; three waves over 4 shared
1,024-token prefixes; ITL beside an offload backlog, KVBM on and off), then
the bf16 engine wave on llama3-8b and `chip_smoke.phase_kvbm_bf16` (one
prefix through G2 and G4). Prints the card's name and power limit, the
phases' JSON lines and their launch counts. ~2 minutes of card time. Needs
a CUDA card; exits non-zero without one.
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
        raise SystemExit("torch_kvbm_phases: no CUDA card")
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engine import RunnerConfig

    faulthandler.dump_traceback_later(780, exit=True)
    t0 = time.perf_counter()
    dev = resolve_device("cuda")
    print(c.nvidia_smi(), flush=True)
    c.phase_build()
    worker, _, _ = c.phase_engine(
        dev, c.QMODEL, RunnerConfig(weight_dtype="int4", kv_dtype="int8"),
        label="engine_q", prewarm=True)
    try:
        print("kvbm launches", c.phase_kvbm(dev, worker), flush=True)
    finally:
        worker.close()
    del worker
    c.free_memory()
    worker, _, _ = c.phase_engine(dev)
    try:
        print("kvbm_bf16 launches", c.phase_kvbm_bf16(dev, worker),
              flush=True)
    finally:
        worker.close()
    faulthandler.cancel_dump_traceback_later()
    print("seconds", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
