#!/usr/bin/env python3
"""Sweep the key split of the attention forward kernel (K1) on one CUDA card.

    python3 tools/tune_key_splits.py [--seed N] [--reps N] [--out PATH]

Run from the root of a checkout, on a machine with one CUDA card and `nvcc`.
At the serving shapes of `chip_smoke.PER_CALL_SHAPES` (H = 4, D = 64, ragged
lengths), in bf16 and float32, it forces every split count from 1 to 8 key
ranges a query tile (at least one 64-key tile each), holds each result against
the plain version at chip_smoke's bars and times a call. It prints one JSON
line per shape: the mean ms by split count and the count that
`matcha_tpu_torch.ops.attention.key_splits` chooses. This is the measurement
behind `key_splits`; rerun it after a change to K1 or to the rule.
"""

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]


def sweep(dev, seed, reps):
    import chip_smoke
    from matcha_tpu_torch.ops import attention as attention_ops

    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for b, t in chip_smoke.PER_CALL_SHAPES[:4]:
            q, k, v, bias = chip_smoke.attention_inputs(b, 4, t, 64, dtype, dev, gen,
                                                        [t - 37 * (i % 2) for i in range(b)])
            want = attention_ops.attention_plain(q, k, v, bias, 0.125)
            ms = {}
            for s in range(1, min(8, -(-t // 64)) + 1):
                with mock.patch.object(attention_ops, "key_splits", lambda *a, s=s: s):
                    chip_smoke.max_err_within(attention_ops.attention_cuda(q, k, v, bias, 0.125),
                                              want, *chip_smoke.TOL[name],
                                              f"K1 {name} B={b} T={t} split {s}")
                    ms[s] = chip_smoke.cuda_ms(
                        lambda: attention_ops.attention_cuda(q, k, v, bias, 0.125), reps)
            row = {"dtype": name, "shape": [b, 4, t, 64], "ms_by_splits": ms,
                   "chosen": attention_ops.key_splits(b, 4, t, dtype, sms)}
            chip_smoke.log(row)
            out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "key_splits.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_key_splits: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from matcha_tpu_torch import apply_tf32_policy

    apply_tf32_policy()  # the float32 plain version in full float32
    dev = torch.device("cuda", 0)
    rows = sweep(dev, args.seed, args.reps)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
