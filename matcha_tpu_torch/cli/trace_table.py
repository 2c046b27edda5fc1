"""Device time of a torch.profiler trace, by kernel group.

    python -m matcha_tpu_torch.cli.trace_table TRACE [--dispatches N] [--top 20]

The port of `tools/trace_table.py`. TRACE is a Chrome-trace JSON written by
`utils.profiling.trace` (the trainer's `profile_dir`, the bench's
`--profile`), or a directory holding such traces (the newest
`trace_*.json`). It sums the durations of the device's kernel events,
those replayed inside CUDA graphs included, by group: the port's kernels
(K1, K2, K3a+K3b, K4) and the library's kernels by kind, and prints the
groups and the heaviest kernels, in ms a dispatch when `--dispatches` says
how many dispatches the trace holds. Its reader (`read_events`, `nesting`,
`work`, `tabulate_work`) also serves `cli.trace_train_step` and
`cli.profile_vocoder`.
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


def read_events(path) -> list:
    """The events of the Chrome trace at `path` (`trace_path`)."""
    return json.loads(trace_path(path).read_text())["traceEvents"]


def is_kernel(e) -> bool:
    return e.get("ph") == "X" and e.get("cat") == "kernel"


def nesting(events) -> list:
    """The index of each event's innermost enclosing event on its thread
    (None at the top), for the complete events ("X") of `events`; a thread's
    host events nest, as torch.profiler records them."""
    parent = [None] * len(events)
    by_thread = {}
    for i, e in enumerate(events):
        if e.get("ph") == "X" and e.get("cat") != "kernel":
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(i)
    for idx in by_thread.values():
        stack = []  # the open events, outermost first, with their ends
        for i in sorted(idx, key=lambda i: (events[i]["ts"], -events[i].get("dur", 0))):
            while stack and stack[-1][1] <= events[i]["ts"]:
                stack.pop()
            parent[i] = stack[-1][0] if stack else None
            stack.append((i, events[i]["ts"] + events[i].get("dur", 0)))
    return parent


def work(events):
    """([(index in `events`, ms)], "device" or "host"): the trace's units of
    work, its device kernels, or in a trace without any (a run on the CPU)
    its host ops, each with its self time (its span less its children's)."""
    kernels = [(i, e["dur"] / 1e3) for i, e in enumerate(events) if is_kernel(e)]
    if kernels:
        return kernels, "device"
    parent = nesting(events)
    self_us = {i: e["dur"] for i, e in enumerate(events)
               if e.get("ph") == "X" and e.get("cat") == "cpu_op"}
    for i, p in enumerate(parent):
        if p in self_us:
            self_us[p] -= events[i]["dur"]
    return [(i, us / 1e3) for i, us in self_us.items()], "host"


def tabulate(units):
    """({group: [ms, count]}, {name: ms}, total ms) of (name, ms) pairs, by
    `kernel_group`."""
    groups, names, total = {}, {}, 0.0
    for name, ms in units:
        g = groups.setdefault(kernel_group(name), [0.0, 0])
        g[0] += ms
        g[1] += 1
        names[name] = names.get(name, 0.0) + ms
        total += ms
    return groups, names, total


def tabulate_work(events):
    """(`tabulate` of a trace's units of work (`work`), whose work it is:
    "device" or "host")."""
    units, where = work(events)
    return tabulate((events[i]["name"], ms) for i, ms in units), where


def aggregate(path):
    """({group: [ms, kernels]}, {kernel name: ms}, total ms) of the device's
    kernel events in the trace at `path`."""
    return tabulate((e["name"], e["dur"] / 1e3) for e in read_events(path) if is_kernel(e))


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
