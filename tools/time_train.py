#!/usr/bin/env python3
"""Time training micro-steps on one CUDA card, on any checkout's package.

    python3 tools/time_train.py [--tree DIR] [--seed N] [--reps N] [--out PATH]

Run from the root of a checkout, on a machine with one CUDA card and `nvcc`.
At full width (`MatchaConfig()`, batch 16, fp32 and bf16) on `chip_smoke.py`'s
bucket set (128 synthetic items of 300-400 frames; its two largest batch
shapes, Ty 384 and 448), for each shape:
- `eager_ms`: the host clock around each of `--reps` / 2 eager `train_step`
  calls, each ended by a synchronise (median, all);
- `graph_ms`, where the package has `Trainer.dispatch` (CUDA graphs): the
  same around `--reps` 1-step replays;
- two steps of each kind (an accumulation: one step that emits no update,
  one that does) under torch.profiler (`chip_smoke.per_step_profile`: wall,
  device busy and kernels a step, by group) and the CUDA runtime calls the
  host issued for one step (`chip_smoke.host_calls`).
`--tree` takes `matcha_tpu_torch` from another checkout (for example an
unpacked parent commit) while the timing code stays this checkout's: two
trees timed in one call, in turns (`tools/ab_turns.sh`), compare on one card.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose matcha_tpu_torch is timed (default: this one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "time_train.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_train: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    if not (tree / "matcha_tpu_torch" / "csrc").is_dir():
        print(f"time_train: no matcha_tpu_torch in {tree}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    # this checkout's timing code, whichever tree's package is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import matcha_tpu_torch
    from matcha_tpu_torch import apply_tf32_policy
    from matcha_tpu_torch.models.matcha import MatchaConfig
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    if Path(matcha_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {matcha_tpu_torch.__file__}, not the one in {tree}")
    apply_tf32_policy()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    mcfg = MatchaConfig()
    _, _, _, groups = cs.bucket_batches(mcfg)
    graphs = hasattr(Trainer, "dispatch")
    res = {"card": card, "tree": str(tree), "graphs": graphs, "reps": args.reps}
    with tempfile.TemporaryDirectory(prefix="time_train_") as tmp:
        for precision in ("fp32", "bf16"):
            trainer = Trainer(mcfg, TrainConfig(ckpt_dir=str(Path(tmp) / precision),
                                                seed=args.seed, precision=precision), device=dev)
            trainer.init_optimizer(8)
            rows = []
            for group in groups[:2]:
                one = group[:1]
                b, i = one[0]
                kinds = {"eager": (lambda: trainer.train_step(b, 0, i), args.reps // 2)}
                if graphs:
                    kinds["graph"] = (lambda: trainer.dispatch(one, 0), args.reps)
                row = {"tx_ty": [b["x"].shape[1], b["y"].shape[1]]}
                for kind, (call, reps) in kinds.items():
                    call()  # build, capture and warm up both kinds of step
                    call()
                    walls = cs.synced_walls(call, reps)
                    prof = cs.per_step_profile(call)
                    row[kind] = {"ms": walls, "ms_median": float(np.median(walls)),
                                 "profile": prof, "host_calls": cs.host_calls(call)}
                    print(f"{precision} {row['tx_ty']} {kind}: wall median "
                          f"{row[kind]['ms_median']:.2f} ms over {reps}; a step profiled: wall "
                          f"{prof.get('wall_ms_per_step')} ms, busy "
                          f"{prof.get('busy_ms_per_step')} ms, {prof.get('kernels_per_step')} "
                          f"kernels; host calls {row[kind]['host_calls']}", flush=True)
                rows.append(row)
            res[precision] = rows
            del trainer
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
