"""Device time of a torch.profiler trace, by kernel group.

    python -m matcha_tpu_torch.cli.trace_table TRACE [--dispatches N] [--top 20]

The port of `tools/trace_table.py`. TRACE is a Chrome-trace JSON written by
`utils.profiling.trace` (the trainer's `profile_dir`, the bench's
`--profile`), or a directory holding such traces (the newest
`trace_*.json`). It sums the durations of the device's kernel events,
those replayed inside CUDA graphs included, by group: the port's kernels
(K1, K2, K3a+K3b, K4) and the library's kernels by kind, and prints the
groups and the heaviest kernels, in ms a dispatch when `--dispatches` says
how many dispatches the trace holds.
"""

import argparse
import json
from pathlib import Path

# (group, a lower-case piece of the kernel's name), the first match wins
GROUPS = (("K1 attention_fwd", "attn_fwd"), ("K2 mrf_step", "mrf_step"),
          ("K3a+K3b mas", "mas_path"),
          ("K4 attention_bwd", "attn_bwd"),
          ("convolution", "conv"),
          ("convolution", "fprop"), ("convolution", "dgrad"),
          ("convolution", "nchwtonhwc"), ("convolution", "nhwctonchw"),
          ("matmul", "gemm"), ("matmul", "gemv"), ("matmul", "nvjet"), ("fft", "fft"),
          ("normalization", "moments"),
          ("normalization", "norm"), ("elementwise", "elementwise"),
          ("reduction", "reduce"), ("nccl", "nccl"))


def kernel_group(name: str) -> str:
    low = name.lower()
    return next((group for group, key in GROUPS if key in low), "other")


def trace_path(path) -> Path:
    """`path`, or the newest `trace_*.json` in the directory `path`."""
    path = Path(path)
    if path.is_dir():
        traces = sorted(path.glob("trace_*.json"), key=lambda p: p.stat().st_mtime)
        if not traces:
            raise SystemExit(f"no trace_*.json under {path}")
        path = traces[-1]
    return path


def aggregate(path):
    """({group: [ms, kernels]}, {kernel name: ms}, total ms) of the device's
    kernel events in the trace at `path`."""
    events = json.loads(trace_path(path).read_text())["traceEvents"]
    groups, names, total = {}, {}, 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        ms = e["dur"] / 1e3
        g = groups.setdefault(kernel_group(e["name"]), [0.0, 0])
        g[0] += ms
        g[1] += 1
        names[e["name"]] = names.get(e["name"], 0.0) + ms
        total += ms
    return groups, names, total


def main(argv=None):
    ap = argparse.ArgumentParser(description="Device time of a torch.profiler trace by group")
    ap.add_argument("trace", help="a Chrome-trace JSON, or a directory of trace_*.json")
    ap.add_argument("--dispatches", type=int, default=1,
                    help="dispatches (replays, steps) the trace holds: times are per one")
    ap.add_argument("--top", type=int, default=20, help="kernels listed by name")
    args = ap.parse_args(argv)

    groups, names, total = aggregate(args.trace)
    n = args.dispatches
    print(f"device total: {total:.3f} ms over {n} dispatch(es), {total / n:.3f} ms each")
    for group, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        share = 100 * ms / total if total else 0.0
        print(f"  {ms / n:10.3f} ms/disp {share:5.1f}% {count / n:8.1f} kernels  {group}")
    print("heaviest kernels:")
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {ms / n:10.3f} ms/disp  {name[:110]}")


if __name__ == "__main__":
    main()
