#!/usr/bin/env python3
"""Time the MRF step kernel (K2) stage by stage on one CUDA card.

    python3 tools/time_mrf_stages.py [--tree DIR] [--seed N] [--reps N] [--out PATH]

Run from the root of a checkout, on a machine with one CUDA card and `nvcc`.
It runs `chip_smoke.time_mrf_per_stage`: at every (C, T, k, d) of a 1024-frame
low-latency request (batch 1) and of a batch of 4 at 512 frames, K2 in bf16
and float32 is held against its plain version and timed beside it, beside the
unfused PyTorch sequence and the bound, and summed by stage. `--tree` takes
`matcha_tpu_torch` (and so K2's source) from another checkout, for example an
unpacked parent commit, while the timing code stays this checkout's: two trees
timed in one call, in turns, compare on one card.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose matcha_tpu_torch is timed (default: this one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "mrf_stages.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_mrf_stages: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    if not (tree / "matcha_tpu_torch" / "csrc").is_dir():
        print(f"time_mrf_stages: no matcha_tpu_torch in {tree}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    # this checkout's timing code, whichever tree's package is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import matcha_tpu_torch
    from matcha_tpu_torch import apply_tf32_policy
    from matcha_tpu_torch.models.hifigan import HiFiGANConfig

    if Path(matcha_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {matcha_tpu_torch.__file__}, not the one in {tree}")
    apply_tf32_policy()  # the float32 plain and unfused versions in full float32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"{card}; K2 from {tree}")
    res = chip_smoke.time_mrf_per_stage(torch.device("cuda", 0), HiFiGANConfig(), args.seed,
                                        args.reps)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "tree": str(tree), **res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
