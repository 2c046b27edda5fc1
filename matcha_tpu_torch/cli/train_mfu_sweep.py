"""The training-MFU variant matrix at batch 128 bf16, each variant in its own process.

    python -m matcha_tpu_torch.cli.train_mfu_sweep [--iters 4] [--only a,b]
        [--out build/train_mfu_sweep.json]

The port of `tools/train_mfu_sweep_r5.py`. Each variant runs
`bench.bench_train(batch=128, precision="bf16", k=8, ...)` (Tx 64, Ty 512,
`Trainer.dispatch` at K 1 and 8, CUDA graph replays) in a child process of
its own, since cuDNN's settings and the caching allocator are global to a
process, and returns one JSON row: `train_step_ms_k1`, `train_step_ms_k8`,
`step_flops` (`bench.train_step_flops`, which under remat counts the
recompute's products too, as XLA's cost analysis did for the JAX sweep),
`mfu_k8` (over bench's `PEAK_FLOPS`, dense bf16),
`samples_per_s_k8`, the first K = 1 dispatch's metrics (so that the
variants can be held against one another), and its graphs' launches. The
card's SM clock, power draw and temperature (nvidia-smi) are sampled into
each row before and after its child. A variant that fails (an algorithm
search inside a graph capture, an out-of-memory) records its error, and the
sweep goes on; the run then exits 1.

Variants and their counterparts in the JAX sweep:
  * `base`: the decoder runs K1 and K4, so this is the JAX sweep's
    `attn_pallas` row;
  * `remat_full`, `remat_dots`: `DecoderConfig.remat` (the JAX sweep's
    `remat_*` and `attn_pallas_remat_dots`);
  * `no_accum`: `accumulate_steps=1`;
  * `cudnn_benchmark`, `cudnn_benchmark_remat_dots`:
    `torch.backends.cudnn.benchmark = True` in the child before the trainer
    is built, the counterpart of the JAX sweep's two compiler-setting
    variants. The search runs in the eager run that precedes each capture.
Variants without one are listed under "no_counterpart" in the output.

Without `--device` the sweep runs on the card and raises without one;
`--device cpu` (with `--tiny`) is for the tests.
"""

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

from matcha_tpu_torch import bench, resolve_device
from matcha_tpu_torch.train.trainer import METRICS
from matcha_tpu_torch.utils.profiling import FLOP_COUNTER

BASE = {"batch": 128, "precision": "bf16"}
VARIANTS = {
    "base": {},
    "remat_full": {"remat": "full"},
    "remat_dots": {"remat": "dots"},
    "no_accum": {"accumulate_steps": 1},
    "cudnn_benchmark": {"cudnn_benchmark": True},
    "cudnn_benchmark_remat_dots": {"cudnn_benchmark": True, "remat": "dots"},
}
NO_COUNTERPART = {
    "attn_xla": "the decoder's attention has one implementation on the card, K1 and K4: "
                "`base` is the JAX sweep's attn_pallas row",
    "lhs_flag": "an XLA TPU scheduler flag; no compiler schedules the captured step "
                "(cudnn_benchmark stands for the compiler settings)",
    "aggressive_fusion": "XLA TPU fusion flags; no compiler fuses the captured step "
                         "(cudnn_benchmark stands for the compiler settings)",
}
CLOCKS = "clocks.sm,power.draw,temperature.gpu"


def child(cfg: dict) -> dict:
    """One variant's row, in this process: `cfg` holds the variant's settings
    and `iters` (the tests add `device`, `tiny`, `tx` and `ty`)."""
    t0 = time.perf_counter()
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = bool(cfg.get("cudnn_benchmark", False))
    try:
        device = resolve_device(cfg.get("device"))
        mcfg = bench.configs(cfg.get("tiny", False))[0]
        mcfg = replace(mcfg, decoder=replace(mcfg.decoder, remat=cfg.get("remat")))
        record = []
        t_single, t_scan, k, flops = bench.bench_train(
            batch=cfg["batch"], tx=cfg.get("tx", 64), ty=cfg.get("ty", 512), k=8,
            iters=cfg["iters"], precision=cfg["precision"],
            accumulate_steps=cfg.get("accumulate_steps", 2), device=device, mcfg=mcfg,
            record=record)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    (train,) = record
    peak = bench.PEAK_FLOPS.get(bench.card_line(device)[0])
    return {"train_step_ms_k1": t_single, "train_step_ms_k8": t_scan, "step_flops": flops,
            "mfu_k8": None if peak is None else flops / (t_scan / 1e3) / peak,
            "samples_per_s_k8": cfg["batch"] / (t_scan / 1e3),
            "first_metrics": dict(zip(METRICS, train["first_metrics"])),
            "micro_steps": train["micro_steps"], "launches": train["launches"],
            "child_s": time.perf_counter() - t0}


def clocks(device) -> str:
    """nvidia-smi's SM clock, power draw and temperature of `device`."""
    if device.type != "cuda":
        return "not measured (no card)"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={CLOCKS}", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not measured ({type(e).__name__})"
    return out.stdout.strip()


def run_variant(name: str, cfg: dict, device, timeout_s: int = 1500) -> dict:
    """`child(cfg)` in a process of its own; the row, or its error."""
    row = {"variant": name, **cfg, "clocks_before": clocks(device)}
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", "matcha_tpu_torch.cli.train_mfu_sweep",
                               "--child", json.dumps(cfg)], capture_output=True, text=True,
                              cwd=bench.ROOT, timeout=timeout_s)
        result = [line for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
        if proc.returncode == 0 and result:
            row.update(json.loads(result[-1][len("RESULT "):]))
        else:
            row["error"] = (proc.stderr or proc.stdout)[-600:]
    except subprocess.TimeoutExpired:
        row["error"] = f"timed out after {timeout_s} s"
    row["wall_s"] = time.perf_counter() - t0
    row["clocks_after"] = clocks(device)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The training-MFU variant matrix")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--only", default=None, help="comma-separated variants to run")
    ap.add_argument("--out", default=str(bench.ROOT / "build" / "train_mfu_sweep.json"))
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true", help="reduced widths, for tests")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print("RESULT " + json.dumps(child(json.loads(args.child))))
        return {}

    device = resolve_device(args.device)
    names = list(VARIANTS) if args.only is None else args.only.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    card, limit = bench.card_line(device)
    rows = []
    for name in names:
        cfg = dict(BASE, **VARIANTS[name], iters=args.iters)
        if device.type != "cuda" or args.tiny:
            cfg.update(device=str(device), tiny=args.tiny)
        print(f"=== {name} ===", file=sys.stderr)
        rows.append(run_variant(name, cfg, device))
        print(json.dumps(rows[-1]), file=sys.stderr)
    out = {"device": card, "power_limit_w": limit, "tx": 64, "ty": 512, "k": 8,
           "iters": args.iters, "peak_flops_bf16": bench.PEAK_FLOPS.get(card),
           "flop_counter": FLOP_COUNTER,
           "note": "bench.bench_train at batch 128 bf16: k1 = one micro-step a dispatch, k8 = a "
                   "micro-step's share of an 8-micro-step dispatch (one CUDA graph replay); "
                   "MFU = products of a micro-step / time / dense bf16 peak; each variant in "
                   "its own process",
           "no_counterpart": NO_COUNTERPART, "rows": rows}
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps({"wrote": str(path), "n_rows": len(rows),
                      "failed": [r["variant"] for r in rows if "error" in r]}))
    return out


if __name__ == "__main__":
    sys.exit(int(any("error" in r for r in main().get("rows", []))))
