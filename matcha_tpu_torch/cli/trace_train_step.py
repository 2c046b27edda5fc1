"""Device trace of the batch-128 bf16 training dispatch, by kernel group and by layer.

    python -m matcha_tpu_torch.cli.trace_train_step OUT_DIR [--remat full|dots]
        [--batch 128] [--k 8] [--eager-attribution]

The port of `tools/trace_train_step.py`. A `Trainer` at full width
(`MatchaConfig()`, `DecoderConfig.remat` from `--remat`) with
`TrainConfig(log_grad_norm=False, precision="bf16")` and
`init_optimizer(steps_per_epoch=16)` runs one `Trainer.dispatch` of K
micro-steps on K copies of the bench's fixed batch (`bench.train_batch`: Tx
64, Ty 512, numpy's default_rng(2)), which captures and runs its CUDA graph.
Two more dispatches (replays) are traced (`utils.profiling.trace`, one more
in its warm-up step) and ended by a synchronisation. It prints the device
ms a dispatch and a micro-step beside the synchronised wall of the same two
dispatches, the card's name and power limit, and the heaviest kernel groups
and kernels (`cli.trace_table`).

The JAX tool's `--attn-impl` has no counterpart: on the card the decoder
always runs K1 and K4, and the flag is not accepted.

`--eager-attribution`: a replay's trace names kernels, not layers, where the
JAX trace's op names carry their shapes. So one more micro-step runs eagerly
(`Trainer.dispatch(chunk, epoch, eager=True)`, after another in the trace's
warm-up step) under torch.profiler with the ops' input shapes, while
forward hooks on the tool's own model open a `record_function` range named
after each submodule's qualified name (the hooks are removed after the
trace; no module of the package changes). Each device kernel goes to the
op that launched it, the outermost op inside the innermost module range,
with that op's input shapes (for a convolution its batch, channels, length,
kernel size and groups). A backward kernel goes to
its autograd node, named beside its forward op, that op's module and shapes
where the profiler links the node to the op (its forward-backward flow,
paired by sequence number), and by the node alone, shapes empty, where it
does not. Kernels of activation checkpointing's recompute run inside module
ranges opened in the backward and are marked "recompute". It prints device
ms by (module, op, shapes) for the heaviest rows, FFT-group kernels marked,
and the eager micro-step's ms by kernel group beside the replay's ms a
micro-step. The attribution stands for the replay only where both ran the
same convolution, FFT and product kernels (the libraries' algorithms), and
the tool says whether they did.

Without `--device` the tool runs on the card and raises without one;
`--device cpu` (with `--tiny`) is for the tests, where the work traced is
the host ops' self time. Traces go under OUT_DIR: the replays' there, the eager
step's in OUT_DIR/eager.
"""

import argparse
import contextlib
import itertools
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import torch

from matcha_tpu_torch import bench, resolve_device
from matcha_tpu_torch.cli.trace_table import (kernel_group, nesting, read_events, tabulate_work,
                                              trace_path, work)
from matcha_tpu_torch.models.matcha import MatchaConfig
from matcha_tpu_torch.train.trainer import COUNTED, METRICS, TrainConfig, Trainer
from matcha_tpu_torch.utils.profiling import synchronize, trace

TX, TY = 64, 512  # the fixed batch of tools/trace_train_step.py
FFT = "fft"  # the kernel group of cuDNN's FFT convolution kernels
EVALUATE = "autograd::engine::evaluate_function: "  # an autograd node's span in the backward
NO_MODULE = "(no module)"


def is_module(e) -> bool:
    """A module's range (`module_ranges`): a user annotation, not the
    profiler's own step."""
    return e.get("cat") == "user_annotation" and not e["name"].startswith("ProfilerStep#")

# the kernel groups whose kernels are a library's choice of algorithm
ALGORITHMS = ("convolution", FFT, "matmul")


@contextlib.contextmanager
def module_ranges(model: torch.nn.Module):
    """A `record_function` range named after each submodule's qualified name
    around every call of its forward, by hooks removed on exit."""
    opened = {}

    def pre(name):
        def hook(module, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            opened.setdefault(id(module), []).append(rf)
        return hook

    def post(module, args, out):
        opened[id(module)].pop().__exit__(None, None, None)

    handles = []
    for name, m in model.named_modules():
        if name:
            handles.append(m.register_forward_pre_hook(pre(name)))
            handles.append(m.register_forward_hook(post, always_call=True))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def op_shapes(e) -> str:
    """An op's input shapes: a 1-d convolution's B, C, L, output channels,
    kernel size and groups, else each tensor input's dims."""
    args = e.get("args", {})
    dims, concrete = args.get("Input Dims") or [], args.get("Concrete Inputs") or []
    name = e["name"]
    if name in ("aten::conv1d", "aten::conv_transpose1d") and len(dims) > 1 \
            and len(dims[0]) == 3 and len(dims[1]) == 3:
        (b, c, length), (w0, w1, k) = dims[0], dims[1]
        try:
            groups = int(concrete[6])  # the groups argument of both schemas
        except (IndexError, ValueError):
            groups = None if "transpose" in name else c // w1
        cout = w0 if "transpose" not in name else (w1 * groups if groups else "?")
        return f"B={b} C={c} L={length} Cout={cout} k={k} groups={groups}"
    return " ".join(str(list(d)) for d in dims if d)


def attribute(events) -> dict:
    """Each unit of work of a trace (`trace_table.work`: its device kernels,
    or on the CPU its host ops' self time) by (module, op, shapes):
    {"rows": [{"module", "op", "shapes", "pass", "ms", "kernels", "fft_ms",
    "fft_kernels"}, ...] heaviest first, "total_ms", "where", "fft_ms",
    "fft_without_shapes"}. The rules are the module docstring's."""
    units, where = work(events)
    parent = nesting(events)
    at = {}  # (pid, tid, ts) -> the innermost host event starting there
    for i, e in enumerate(events):
        if e.get("ph") == "X" and e.get("cat") != "kernel":
            key = (e.get("pid"), e.get("tid"), e["ts"])
            if key not in at or parent[i] == at[key]:
                at[key] = i
    # a kernel's launch call: the runtime's or the CUDA API's, by correlation id
    launch = {e["args"]["correlation"]: i for i, e in enumerate(events)
              if e.get("cat", "").startswith("cuda_") and e.get("ph") == "X"
              and "correlation" in e.get("args", {})}

    def chain(i):
        """`i` and its enclosing host events, innermost first."""
        out = []
        while i is not None:
            out.append(i)
            i = parent[i]
        return out

    def first(ch, pred):
        return next((p for p, j in enumerate(ch) if pred(events[j])), None)

    def site(ch):
        """(module, op event or None) of the work whose host chain is `ch`."""
        pm = first(ch, is_module)
        inside = ch if pm is None else ch[:pm]
        ops = [j for j in inside if events[j].get("cat") == "cpu_op"
               and not events[j]["name"].startswith(EVALUATE)]
        return NO_MODULE if pm is None else events[ch[pm]]["name"], (ops[-1] if ops else None)

    # an autograd node's span -> the forward op that made the node, by the
    # profiler's forward-backward flows
    starts = {e["id"]: (e.get("pid"), e.get("tid"), e["ts"]) for e in events
              if e.get("cat") == "fwdbwd" and e.get("ph") == "s"}
    forward_of = {}
    for e in events:
        if e.get("cat") != "fwdbwd" or e.get("ph") != "f" or e["id"] not in starts:
            continue
        node, fwd = at.get((e.get("pid"), e.get("tid"), e["ts"])), at.get(starts[e["id"]])
        ch = chain(node) if node is not None else []
        pe = first(ch, lambda ev: ev["name"].startswith(EVALUATE))
        if pe is not None and fwd is not None:
            forward_of[ch[pe]] = fwd

    rows = {}
    for unit, ms in units:
        item = events[unit]
        # the host event a kernel hangs from is its launch call; a host op is its own
        anchor = (launch.get(item.get("args", {}).get("correlation")) if where == "device"
                  else unit)
        ch = chain(anchor) if anchor is not None else []
        pm = first(ch, is_module)
        pe = first(ch, lambda e: e["name"].startswith(EVALUATE))
        group = kernel_group(item["name"])
        if not ch:
            key = ("(unlinked)", f"({group})", "", "")
        elif pe is not None and (pm is None or pm > pe):  # the backward, outside a recompute
            node = events[ch[pe]]["name"][len(EVALUATE):]
            fwd = forward_of.get(ch[pe])
            if fwd is None:
                key = ("(backward)", node, "", "backward")
            else:
                module, op = site(chain(fwd))
                op = fwd if op is None else op
                key = (module, f"{node} of {events[op]['name']}", op_shapes(events[op]),
                       "backward")
        else:
            module, op = site(ch)
            key = (module, f"({group})" if op is None else events[op]["name"],
                   "" if op is None else op_shapes(events[op]),
                   "recompute" if pe is not None else "forward")
        r = rows.setdefault(key, {"ms": 0.0, "kernels": 0, "fft_ms": 0.0, "fft_kernels": 0})
        r["ms"] += ms
        r["kernels"] += 1
        if group == FFT:
            r["fft_ms"] += ms
            r["fft_kernels"] += 1
    out = [dict(zip(("module", "op", "shapes", "pass"), key), **r) for key, r in rows.items()]
    out.sort(key=lambda r: -r["ms"])
    return {"rows": out, "where": where, "total_ms": sum(r["ms"] for r in out),
            "fft_ms": sum(r["fft_ms"] for r in out),
            "fft_without_shapes": sum(r["fft_kernels"] for r in out if not r["shapes"])}


def run(out_dir, remat=None, batch: int = 128, k: int = 8, eager_attribution: bool = False,
        device=None, mcfg=None) -> dict:
    """The traced dispatches and, with `eager_attribution`, the eager
    micro-step by layer; returns what `report` prints."""
    device = resolve_device(device)
    mcfg = mcfg or MatchaConfig()
    mcfg = replace(mcfg, decoder=replace(mcfg.decoder, remat=remat))
    out_dir = Path(out_dir)
    card, limit = bench.card_line(device)
    b = bench.train_batch(batch, TX, TY, mcfg.n_feats)
    index = itertools.count()  # a fresh schedule index, so fresh noise, every micro-step
    res = {"card": card, "power_limit_w": limit, "remat": remat, "batch": batch, "k": k,
           "tx": TX, "ty": TY}
    with tempfile.TemporaryDirectory(prefix="matcha_trace_") as tmp:
        trainer = Trainer(mcfg, TrainConfig(log_grad_norm=False, precision="bf16",
                                            steps_per_dispatch=k, ckpt_dir=tmp), device=device)
        try:
            trainer.init_optimizer(steps_per_epoch=16)

            def dispatch(n, eager=False):
                return trainer.dispatch([(b, next(index)) for _ in range(n)], epoch=0,
                                        eager=eager)

            res["first_metrics"] = dict(zip(METRICS, dispatch(k)[0].tolist()))  # capture, run
            with trace(out_dir, device, warmup=lambda: dispatch(k)):
                t0 = time.perf_counter()
                for _ in range(2):
                    out = dispatch(k)
                synchronize(out)
                res["wall_ms_per_dispatch"] = (time.perf_counter() - t0) * 1e3 / 2
            res["trace"] = str(trace_path(out_dir))
            events = read_events(res["trace"])
            (groups, names, total), res["where"] = tabulate_work(events)
            res["ms_per_dispatch"] = total / 2
            res["by_group"] = {g: ms / 2 for g, (ms, _) in groups.items()}
            res["kernels_per_dispatch_by_group"] = {g: n / 2 for g, (_, n) in groups.items()}
            res["top_kernels"] = dict(sorted(((n, ms / 2) for n, ms in names.items()),
                                             key=lambda kv: -kv[1])[:14])
            # the replays' launches by the graph accounting, then the eager steps' by the wrappers
            res["launches"] = dict(trainer.launches)
            res["replays"] = dict(trainer.replays)
            if eager_attribution:
                before = {n: w.launches for n, w in COUNTED.items()}
                with module_ranges(trainer.model), trace(
                        out_dir / "eager", device, record_shapes=True,
                        warmup=lambda: dispatch(1, eager=True)):
                    synchronize(dispatch(1, eager=True))
                eager_launches = {n: w.launches - before[n] for n, w in COUNTED.items()}
                for n, c in eager_launches.items():
                    res["launches"][n] += c
                res["eager_launches"] = eager_launches
                res["eager_trace"] = str(trace_path(out_dir / "eager"))
                eager_events = read_events(res["eager_trace"])
                res["attribution"] = attribute(eager_events)
                (eager_groups, eager_names, _), _ = tabulate_work(eager_events)
                res["eager_by_group"] = {g: ms for g, (ms, _) in eager_groups.items()}
                res["replay_by_group_per_micro_step"] = {g: ms / k
                                                         for g, ms in res["by_group"].items()}
                # the libraries' algorithms: their convolution, FFT and product kernels
                eager_names, replay_names = ({n for n in ns if kernel_group(n) in ALGORITHMS}
                                             for ns in (eager_names, names))
                res["only_eager"] = sorted(eager_names - replay_names)
                res["only_replay"] = sorted(replay_names - eager_names)
        finally:
            trainer.logger.close()
    return res


def _share(part: dict, group: str) -> float:
    total = sum(part.values())
    return part.get(group, 0.0) / total if total else 0.0


def report(res: dict, top_layers: int = 20) -> None:
    """Print `run`'s result: the JAX tool's table, then the attribution."""
    per = res["ms_per_dispatch"]
    print(f"variant remat={res['remat']} batch={res['batch']} K={res['k']} "
          f"(Tx {res['tx']}, Ty {res['ty']}, bf16) on {res['card']}, {res['power_limit_w']} W: "
          f"{res['where']} {per:.1f} ms/dispatch ({per / res['k']:.1f} ms/step), synchronised "
          f"wall {res['wall_ms_per_dispatch']:.1f} ms/dispatch")
    for group, ms in sorted(res["by_group"].items(), key=lambda kv: -kv[1])[:14]:
        print(f"  {100 * ms / per if per else 0.0:5.1f}%  {ms:8.2f} ms/dispatch  {group}")
    print("heaviest kernels:")
    for name, ms in res["top_kernels"].items():
        print(f"  {ms:8.2f} ms/dispatch  [{kernel_group(name)}] {name[:100]}")
    if "attribution" not in res:
        return
    att = res["attribution"]
    print(f"eager micro-step by layer ({att['where']} ms): total {att['total_ms']:.2f} ms, "
          f"FFT-group kernels {att['fft_ms']:.2f} ms, {att['fft_without_shapes']} of them "
          f"without shapes; module | op | shapes")
    for r in att["rows"][:top_layers]:
        fft = f" [FFT {r['fft_ms']:.2f} ms, {r['fft_kernels']} kernels]" if r["fft_kernels"] else ""
        print(f"  {r['ms']:8.3f} ms {r['kernels']:5d} k  {r['pass']:9s} {r['module']} | "
              f"{r['op']} | {r['shapes']}{fft}")
    eager, replay = res["eager_by_group"], res["replay_by_group_per_micro_step"]
    print("by kernel group: eager micro-step ms | replay ms a micro-step")
    for group in sorted(set(eager) | set(replay), key=lambda g: -replay.get(g, 0.0)):
        print(f"  {eager.get(group, 0.0):9.3f} | {replay.get(group, 0.0):9.3f}  {group}")
    print(f"FFT group's share: eager {100 * _share(eager, FFT):.1f}%, "
          f"replay {100 * _share(replay, FFT):.1f}%")
    if res["only_eager"] or res["only_replay"]:
        print(f"eager and replay ran different {'/'.join(ALGORITHMS)} kernels: the "
              f"attribution holds for the eager step alone; only eager "
              f"{res['only_eager'][:8]}, only replay {res['only_replay'][:8]}")
    else:
        print(f"eager and replay ran the same {'/'.join(ALGORITHMS)} kernels")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Device trace of the training dispatch")
    ap.add_argument("out_dir", help="where the traces go (the eager step's in OUT_DIR/eager)")
    ap.add_argument("--remat", choices=("full", "dots"), default=None)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--k", type=int, default=8, help="micro-steps a dispatch")
    ap.add_argument("--eager-attribution", action="store_true",
                    help="trace one eager micro-step and attribute its kernels to layers")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true", help="reduced widths, for tests")
    args = ap.parse_args(argv)
    res = run(args.out_dir, args.remat, args.batch, args.k, args.eager_attribution,
              args.device, bench.configs(args.tiny)[0])
    report(res)
    return res


if __name__ == "__main__":
    main()
