#!/usr/bin/env python3
"""Sweep the tile plans of the MRF step kernel (K2) on one CUDA card.

    python3 tools/tune_mrf_plans.py [--seed N] [--reps N] [--dtypes bfloat16 float32]
                                    [--define MACRO=VALUE ...] [--out PATH]

Run from the root of a checkout, on a machine with one CUDA card and `nvcc`.
At every (C, T, k, d) of `chip_smoke.MRF_STAGE_REQUESTS` (a 1024-frame request
at batch 1, a batch of 4 at 512), it forces every plan of
`matcha_tpu_torch.ops.mrf.mrf_plans` (z tile, weight chunk and ring depth),
holds each result against the plain version at
chip_smoke's bars and times a call. It prints one JSON line per shape: the
mean ms by plan and the plan `mrf_plan` chooses. This is the measurement
behind `mrf_plan`; rerun it after a change to K2 or to the rule.

`--define MRF_COPY_BYTES=4096` (or any macro of csrc/mrf_step.cu) times a
variant of the kernel, compiled here with that macro.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def variant_entry(defines):
    """The C entry of csrc/mrf_step.cu compiled with `-D` each of `defines`."""
    from matcha_tpu_torch.ops import _build

    tag = "_".join(d.replace("=", "") for d in defines)
    lib = _build.BUILD_DIR / f"libmrf_step_{tag}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(lib),
           str(_build.CSRC / "mrf_step.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed for {defines}:\n{log.stdout}{log.stderr}")
    fn = ctypes.CDLL(str(lib)).mrf_step
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sweep(dev, seed, reps, dtypes, dilations):
    import chip_smoke
    from matcha_tpu_torch.models.hifigan import HiFiGANConfig
    from matcha_tpu_torch.ops import mrf

    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for req, b, budget in chip_smoke.MRF_STAGE_REQUESTS:
        for c, t, k, d in chip_smoke.mrf_shapes(HiFiGANConfig(), budget):
            if d not in dilations:
                continue
            for dtype in dtypes:
                name = str(dtype).split(".")[1]
                tol = chip_smoke.TOL_MRF_F32 if dtype == torch.float32 else chip_smoke.TOL[name]
                args = chip_smoke.mrf_inputs(b, c, t, k, dtype, dev, gen)
                packed = mrf.pack_weights(args[1], args[3])
                want = mrf.mrf_step_plain(*args, d)
                elt = args[0].element_size()
                ms = {}
                for plan in mrf.mrf_plans(b, c, t, k, d, elt):
                    label = f"lz{plan.lz} tt{plan.tt} chunk{plan.chunk} stages{plan.stages}"
                    chip_smoke.max_err_within(mrf.mrf_step_cuda(*args, d, packed, plan), want,
                                              *tol, f"K2 {name} {[b, c, t]} k={k} d={d} {label}")
                    ms[label] = chip_smoke.cuda_ms(
                        lambda: mrf.mrf_step_cuda(*args, d, packed, plan), reps)
                chosen = mrf.mrf_plan(b, c, t, k, d, elt, sms)
                row = {"request": req, "dtype": name, "shape": [b, c, t], "k": k, "d": d,
                       "ms_by_plan": ms, "chosen": chosen.__dict__,
                       "best": min(ms, key=ms.get)}
                chip_smoke.log(row)
                out.append(row)
                del args, packed, want
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--dilations", nargs="+", type=int, default=[1, 3, 5])
    ap.add_argument("--define", nargs="*", default=[], help="MACRO=VALUE for csrc/mrf_step.cu")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "mrf_plans.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_mrf_plans: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from matcha_tpu_torch import apply_tf32_policy
    from matcha_tpu_torch.ops import mrf

    apply_tf32_policy()  # the float32 plain version in full float32
    if args.define:
        entry = variant_entry(args.define)
        mrf._entry = lambda: entry
    rows = sweep(torch.device("cuda", 0), args.seed, args.reps,
                 [getattr(torch, n) for n in args.dtypes], args.dilations)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"define": args.define, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
