"""The weight-only GEMM kernels of several checkouts, on one card, in turns.

    python3 scripts/torch_gemm_compare.py --trees build/parent . . build/parent
        [--ms 8 16 40 80 512]

For each checkout in the order given (a repeated tree shows the spread),
runs that checkout's own `chip_smoke.py` gemm phase in a child process: its
kernels built from its own sources into its own build/, each held against
its plain version and timed at mistral-7b's five projection geometries for
every M of --ms. Prints one JSON line per run with, per kernel and M, the
sums over the five geometries of the kernel's ms, `torch.matmul`'s ms on the
dequantized bf16 weight and the bound, and the nvidia-smi line of the card.
Use it to hold a kernel change against its parent commit (`git archive` the
parent into a directory that .gitignore lists). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import sys, torch
sys.path.insert(0, {tree!r})
import chip_smoke as c
c.GEMM_MS = {ms!r}
c.GEMM_TAILS = ()  # correctness-only cases; trees that predate it ignore it
c.emit("device", nvidia_smi=c.nvidia_smi())
c.phase_build()
c.phase_gemms(torch.device("cuda"))
"""


def run_tree(tree: Path, ms: tuple) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(tree=str(tree), ms=ms)],
        cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"torch_gemm_compare: {tree} failed:\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    sums, smi, build = {}, None, None
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if rec.get("phase") == "device":
            smi = rec["nvidia_smi"]
        elif rec.get("phase") == "build":
            build = {"seconds": rec["seconds"],
                     "ptxas": [p for p in rec["ptxas"]
                               if "registers" in p or "spill" in p
                               or "Compiling" in p]}
        elif rec.get("phase") == "gemm":
            key = f"{rec['name']} M={rec['M']}"
            acc = sums.setdefault(key, {"ms": 0.0, "library_ms": 0.0,
                                        "bound_ms": 0.0, "cases": 0})
            acc["ms"] += rec["ms"]
            acc["library_ms"] += rec["library_ms"]
            acc["bound_ms"] += rec["bound_ms"]
            acc["cases"] += 1
    for acc in sums.values():
        acc["x_library"] = acc["ms"] / acc["library_ms"]
        acc["x_bound"] = acc["ms"] / acc["bound_ms"]
    return {"tree": str(tree), "nvidia_smi": smi, "sums": sums,
            "build": build}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--ms", type=int, nargs="+", default=[8, 16, 40, 80, 512])
    args = ap.parse_args()
    for tree in args.trees:
        path = Path(tree).resolve()
        if not (path / "chip_smoke.py").exists():
            raise SystemExit(f"torch_gemm_compare: no chip_smoke.py in {path}")
        print(json.dumps(run_tree(path, tuple(args.ms))), flush=True)


if __name__ == "__main__":
    main()
