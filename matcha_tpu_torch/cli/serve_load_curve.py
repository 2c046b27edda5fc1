"""Offered load -> latency and throughput of the serving engine's batching front end.

    python -m matcha_tpu_torch.cli.serve_load_curve [--threads 1 2 4 8 16]
        [--per-thread 8] [--max-batch 8] [--mel-budgets 256 512] [--max-wait-ms 5]
        [--out build/serve_load_curve.json | --append-to PATH] [--device cuda|cpu]

The port of `tools/serve_load_curve.py`. At each level, that many closed-loop
clients (`bench.run_clients`, the bench's own) drive `TTSEngine.serve` at the
bench's serving configuration (bf16, 10 Euler steps, HiFi-GAN, int16 output,
random weights) with max(16, per-thread x clients) requests. Each level's row:
requests/s, p50, p90 and p99 of enqueue -> delivery, the median of each
request's own compute path (`wall_p50_ms`) and the mean group size, which
show where batching saturates and whether groups fill to `max_batch`. One
budget is the zero-sync engine (no host read before a group's decode).
`--append-to` adds rows tagged with this run's engine to an existing file.
On the card unless `--device` says otherwise.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from matcha_tpu_torch import bench


def run_level(eng, threads: int, n_requests: int) -> dict:
    """One level of the curve: `threads` closed-loop clients, `n_requests`."""
    lat, wall_ms, group_sizes, wall = bench.run_clients(eng, bench.SERVE_TEXTS, n_requests,
                                                        threads, closed_loop=True)
    return {
        "threads": threads,
        "n_requests": n_requests,
        "requests_per_s": round(n_requests / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)), 1),
        "p90_ms": round(float(np.percentile(lat, 90)), 1),
        "p99_ms": round(float(np.percentile(lat, 99)), 1),
        "wall_p50_ms": round(float(np.median(wall_ms)), 1),
        "mean_group_size": round(float(np.mean(group_sizes)), 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="Serving load curve (PyTorch/CUDA port)")
    ap.add_argument("--out", default=str(bench.ROOT / "build" / "serve_load_curve.json"))
    ap.add_argument("--per-thread", type=int, default=8,
                    help="requests per client at each level (at least 16 a level)")
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8, 16],
                    help="closed-loop client counts to sweep")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--mel-budgets", type=int, nargs="+", default=[256, 512],
                    help="one value: the zero-sync single-budget engine")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="batching window; longer waits fill bigger groups")
    ap.add_argument("--append-to", default=None,
                    help="append rows tagged with this run's engine to this file")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true", help="reduced widths, for tests")
    args = ap.parse_args(argv)

    from matcha_tpu_torch import resolve_device

    device = resolve_device(args.device)
    mcfg, hcfg = bench.configs(args.tiny)
    eng = bench._full_size_engine(steps=10, max_batch=args.max_batch,
                                  mel_budgets=tuple(args.mel_budgets), device=device,
                                  mcfg=mcfg, hcfg=hcfg)
    warm = sorted({1, 2, 4, args.max_batch} | {b for b in (8, 16) if b < args.max_batch})
    eng.warmup(batch_sizes=tuple(warm), text=bench.SERVE_TEXTS[0])
    eng.start_batching(max_wait_ms=args.max_wait_ms)
    rows = []
    try:
        for threads in args.threads:
            row = run_level(eng, threads, max(16, args.per_thread * threads))
            if args.append_to:
                row.update(max_batch=args.max_batch, mel_budgets=list(args.mel_budgets),
                           max_wait_ms=args.max_wait_ms,
                           zero_sync=len(args.mel_budgets) == 1)
            rows.append(row)
            print(json.dumps(row), file=sys.stderr)
    finally:
        eng.stop_batching()

    if args.append_to:
        path = Path(args.append_to)
        out = json.loads(path.read_text())
        out["rows"].extend(rows)
        path.write_text(json.dumps(out, indent=1))
        print(json.dumps({"appended_to": str(path), "n_new": len(rows)}))
        return
    name, limit = bench.card_line(device)
    out = {"config": {"steps": 10, "precision": "bf16", "vocoder": "hifigan", "wire": "int16",
                      "max_batch": eng.cfg.max_batch, "max_wait_ms": args.max_wait_ms,
                      "mel_budgets": list(eng.cfg.mel_budgets)},
           "device": name, "power_limit_w": limit,
           "note": "closed-loop clients; latency = enqueue -> delivery; wall = the "
                   "request's own compute path (its group's encode and its sub-group's "
                   "decode replay and copy, waits included).",
           "rows": rows}
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps({"wrote": str(path), "n_rows": len(rows)}))


if __name__ == "__main__":
    main()
