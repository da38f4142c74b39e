"""Ring depth of the paged flash-decode body, measured on one card.

    python3 scripts/torch_attention_stages.py [--stages 2 3 4 3 2]

Builds `dynamo_tpu_torch/ops/csrc/paged_decode_pool.cu` once per ring depth
(`kStages`: tiles of 64 tokens resident in shared memory, kStages - 1 in
flight), each copy under build/attention_stages/, and runs `chip_smoke.py`'s
kernels phase with it: every attention case held against its plain version,
then timed. Prints one JSON line per depth with the kernel ms by case; the
depths run in the order given, so a repeated depth shows the spread.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int, nargs="+", default=[2, 3, 4, 3, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_stages: needs a CUDA card")

    import chip_smoke
    from dynamo_tpu_torch.ops import _build

    source = (_build.CSRC / "paged_decode_pool.cu").read_text()
    pattern = r"constexpr int kStages = \d+;"
    if not re.search(pattern, source):
        raise SystemExit("torch_attention_stages: kStages not found")
    dev = torch.device("cuda")
    print(json.dumps({"nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    for stages in args.stages:
        variant = ROOT / "build" / "attention_stages" / f"s{stages}"
        (variant / "csrc").mkdir(parents=True, exist_ok=True)
        (variant / "csrc" / "paged_decode_pool.cu").write_text(
            re.sub(pattern, f"constexpr int kStages = {stages};", source))
        _build.CSRC, _build.BUILD_DIR = variant / "csrc", variant / "lib"
        _build._libs.clear()
        t0 = time.perf_counter()
        _build.build_all(["paged_decode_pool"])
        build_s = time.perf_counter() - t0
        cases = chip_smoke.phase_kernels(dev)
        print(json.dumps({"stages": stages, "build_s": build_s,
                          "ms": {e["name"]: e["ms"] for e in cases}}),
              flush=True)


if __name__ == "__main__":
    main()
