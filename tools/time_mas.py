#!/usr/bin/env python3
"""Time whole `maximum_path` calls at the training path's shapes on one CUDA card.

    python3 tools/time_mas.py [--tree DIR] [--seed N] [--reps N] [--out PATH]

Run from the root of a checkout, on a machine with one CUDA card and `nvcc`.
At every (Tx, Ty, lengths) of the MAS calls `chip_smoke.py`'s training path
makes (`chip_smoke.training_batches`: 3 epochs of 4 micro-steps and a
validation batch, B = 16), it holds `maximum_path` on the card bit-equal to
`maximum_path_plain` and times the whole call, wrapper included:
- `device_ms`: CUDA events around back-to-back calls behind a spin kernel
  (`chip_smoke.cuda_ms`), the call's kernels on the card;
- `wall_ms`: the host clock around back-to-back calls and a synchronise, what
  a caller waits;
- `kernels_us`: one call under torch.profiler, device time by kernel name
  (for a tree whose MAS is several kernels, each of them).
Sums over the path weigh each shape by its calls. One more row, outside the
sums, is a batch at `DataConfig`'s caps (B = 16, Tx = 256, Ty = 1024, random
lengths, the first utterance at the caps), the widest a real dataset gives
(8 text positions a DP lane of `csrc/mas.cu`). `--tree` takes
`matcha_tpu_torch` from another checkout (for example an unpacked parent
commit) while the timing code stays this checkout's: two trees timed in one
call, in turns, compare alignment against alignment on one card.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def profile_call(call):
    """{kernel name: device µs} of one call, from torch.profiler's CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name[:80]] = out.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose matcha_tpu_torch is timed (default: this one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "time_mas.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_mas: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    if not (tree / "matcha_tpu_torch" / "csrc").is_dir():
        print(f"time_mas: no matcha_tpu_torch in {tree}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    # this checkout's timing code, whichever tree's package is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import matcha_tpu_torch
    from matcha_tpu_torch.data.dataset import DataConfig
    from matcha_tpu_torch.models.matcha import MatchaConfig
    from matcha_tpu_torch.ops.mas import maximum_path, maximum_path_plain

    if Path(matcha_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {matcha_tpu_torch.__file__}, not the one in {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cs.log(f"{card}; maximum_path from {tree}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    batches = [(cs.mas_batch_inputs(key, dev, gen), count)
               for key, count in cs.mas_keys(cs.training_batches(MatchaConfig())).items()]
    dcfg = DataConfig()
    value, mask, t_x, t_y = cs.mas_inputs(dcfg.batch_size, dcfg.max_text_len, dcfg.max_mel_len,
                                          dev, gen)
    batches.append(((-1000.0 + 30.0 * value, mask, t_x, t_y), 0))  # log-prior sized scores
    rows = []
    for (value, mask, t_x, t_y), count in batches:

        def call():
            return maximum_path(value, mask, t_x, t_y)

        if not torch.equal(call(), maximum_path_plain(value, mask, t_x, t_y)):
            raise AssertionError(f"maximum_path at {list(value.shape)} differs from the plain "
                                 f"version")
        device_ms = cs.cuda_ms(call, args.reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps
        kernels = profile_call(call)
        max_t_y = int(t_y.max())
        rows.append({"shape": list(value.shape), "max_t_y": max_t_y, "count": count,
                     "device_ms": device_ms, "wall_ms": wall_ms, "kernels_us": kernels})
        cs.log(f"maximum_path {list(value.shape)} max t_y {max_t_y} x{count}: device "
               f"{device_ms:.4f} ms, wall {wall_ms:.4f} ms, {len(kernels)} kernels "
               f"{ {k[:40]: round(v, 2) for k, v in kernels.items()} }")
    total = {k: sum(r["count"] * r[k] for r in rows) for k in ("device_ms", "wall_ms")}
    total["calls"] = sum(r["count"] for r in rows)
    by_kernel = {}
    for r in rows:
        for name, us in r["kernels_us"].items():
            by_kernel[name] = by_kernel.get(name, 0.0) + r["count"] * us / 1e3
    total["kernels_ms"] = by_kernel
    cs.log({"maximum_path_over_training_path": total})
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "tree": str(tree), "rows": rows,
                                    "total": total}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
