#!/usr/bin/env python3
"""Time the serving engine's two request kinds on one CUDA card.

    python3 tools/time_serve.py [--tree DIR] [--seed N] [--reps N] [--out PATH]

Run from the root of a checkout, on a machine with one CUDA card and `nvcc`.
Builds `TTSEngine` at full width as `chip_smoke.py`'s serving path does
(MatchaConfig() and HiFi-GAN v1, random weights from `--seed`, bf16, int16
output), warms it for the path's two text buckets, then:
- `wall_ms`: the host clock around each of `--reps` requests, which end in
  their device-to-host copy (median, max, mean): a low-latency request at
  the 1024-frame budget, and `synthesise` of chip_smoke's 4 texts with
  per-request seeds;
- one request of each kind under torch.profiler (`chip_smoke.profile_request`:
  wall, device busy, idle share, kernels by group), and the CUDA runtime
  calls the host issued during it (`chip_smoke.host_calls`: kernel and graph
  launches, copies, by name).
`--tree` takes `matcha_tpu_torch` from another checkout (for example an
unpacked parent commit) while the timing code stays this checkout's: two
trees timed in one call, in turns (`tools/ab_turns.sh`), compare on one card.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def walls(call, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(times)), "max": max(times),
            "mean": float(np.mean(times)), "all": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose matcha_tpu_torch is timed (default: this one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "time_serve.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_serve: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    if not (tree / "matcha_tpu_torch" / "csrc").is_dir():
        print(f"time_serve: no matcha_tpu_torch in {tree}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    # this checkout's timing code, whichever tree's package is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import matcha_tpu_torch
    from matcha_tpu_torch import apply_tf32_policy
    from matcha_tpu_torch.models.hifigan import HiFiGANConfig
    from matcha_tpu_torch.models.matcha import MatchaConfig
    from matcha_tpu_torch.serve import ServeConfig, TTSEngine

    if Path(matcha_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {matcha_tpu_torch.__file__}, not the one in {tree}")
    apply_tf32_policy()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    mcfg, hcfg = MatchaConfig(), HiFiGANConfig()
    msd, gsd = cs.model_weights(mcfg, hcfg, args.seed)
    engine = TTSEngine(msd, mcfg, ServeConfig(bf16=True, vocoder="hifigan", output_dtype="int16"),
                       gsd, hcfg, device=dev)
    seeds = list(range(100, 100 + len(cs.TEXTS)))
    t0 = time.perf_counter()
    engine.warmup((len(cs.TEXTS),), cs.TEXTS[2])
    engine.warmup((1,), cs.LONG_TEXT)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    requests = {
        "lowlatency": lambda: engine.synthesise_lowlatency(cs.LONG_TEXT, seed=7, budget=1024),
        "synthesise": lambda: engine.synthesise(cs.TEXTS, seeds=seeds)}
    res = {"card": card, "tree": str(tree), "warmup_s": warm_s, "reps": args.reps}
    for name, call in requests.items():
        call()
        res[name] = {"wall_ms": walls(call, args.reps), "profile": cs.profile_request(call),
                     "host_calls": cs.host_calls(call)}
        p, w = res[name]["profile"], res[name]["wall_ms"]
        print(f"{name}: wall median {w['median']:.2f} ms, max {w['max']:.2f}, mean "
              f"{w['mean']:.2f} over {args.reps}; profiled wall {p['wall_ms']:.2f} ms, busy "
              f"{p['device_ms']:.2f} ms, idle {p['idle_share']:.3f}, {p['kernel_launches']} "
              f"kernels; host calls {res[name]['host_calls']}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
