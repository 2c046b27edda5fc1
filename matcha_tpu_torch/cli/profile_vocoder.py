"""Device time of the HiFi-GAN generator's serving graph, by kernel group and kernel.

    python -m matcha_tpu_torch.cli.profile_vocoder [--batch 8] [--frames 256] [--bf16]
        [--trace-dir build/voc_trace]

The port of `tools/profile_vocoder.py`. The serving-form generator,
`Generator(HiFiGANConfig(), weight_norm=False)` from the bench's seed
(`bench.init_generator`), cast to bf16 under `--bf16`, runs on a mel drawn by
numpy's `default_rng(0).standard_normal((batch, frames, 80))` in the port's
public layout (B, T, n_mels). Its forward is captured as one CUDA graph (the
counterpart of `jax.jit`; `bench._stage`): one replay, then the median wall
of 8 replays each ended by a synchronisation, then 4 replays traced
(`utils.profiling.trace`, one more replay in its warm-up step). It prints
the wall and the device total over the 4 replays beside the card's name and
power limit, then the 25 heaviest rows by kernel group and by kernel
(`cli.trace_table`).

The JAX tool's `--impl` and `--resblock` have no counterpart: on the card the
generator runs `ConvTranspose1d` upsampling and K2 in every MRF step, and the
header says `up=conv_transpose res=K2`.

Without `--device` the tool runs on the card and raises without one;
`--device cpu` (with `--tiny`) is for the tests: there the graph is an eager
call and the time traced is the host ops' self time.
"""

import argparse
import time

import numpy as np
import torch

from matcha_tpu_torch import apply_tf32_policy, bench, resolve_device
from matcha_tpu_torch.cli.trace_table import read_events, tabulate_work, trace_path
from matcha_tpu_torch.models.hifigan import HiFiGANConfig
from matcha_tpu_torch.utils.profiling import synchronize, trace

TIMED, TRACED = 8, 4  # replays timed, then traced


def capture(batch: int, frames: int, bf16: bool, trace_dir, device=None, hcfg=None) -> dict:
    """The generator's graph timed and traced; returns the median wall, the
    graph's launches a replay, its replays, the output of the last replay
    (a copy), the generator, its input and the trace's path."""
    device = resolve_device(device)
    hcfg = hcfg or HiFiGANConfig()
    dtype = torch.bfloat16 if bf16 else torch.float32
    gen = bench.init_generator(hcfg).eval().to(device, dtype)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, frames, hcfg.num_mels))).to(device, dtype)

    def forward(m):
        with torch.no_grad():
            return gen(m)

    stage = bench._stage(forward, (mel,), device)
    synchronize(stage.run(mel))
    times = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        synchronize(stage.run(mel))
        times.append(time.perf_counter() - t0)
    with trace(trace_dir, device, warmup=lambda: stage.run(mel)):
        for _ in range(TRACED):
            out = stage.run(mel)
    return {"wall_ms": float(np.median(times)) * 1e3, "launches": dict(stage.launches),
            "replays": getattr(stage, "replays", 0), "out": out.clone(), "generator": gen,
            "mel": mel, "trace": str(trace_path(trace_dir))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Device time of the HiFi-GAN generator's graph")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--trace-dir", default=str(bench.ROOT / "build" / "voc_trace"))
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true", help="reduced widths, for tests")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        apply_tf32_policy()  # float32 in full float32, as the package runs it
    res = capture(args.batch, args.frames, args.bf16, args.trace_dir, device,
                  bench.configs(args.tiny)[1])
    card, limit = bench.card_line(device)
    (groups, names, total), where = tabulate_work(read_events(res["trace"]))
    res.update(card=card, power_limit_w=limit, where=where, total_ms=total,
               by_group={g: ms for g, (ms, _) in groups.items()},
               kernels_by_group={g: n for g, (_, n) in groups.items()}, by_kernel=names)
    print(f"generator fwd ({args.batch}x{args.frames}, {'bf16' if args.bf16 else 'fp32'}, "
          f"up=conv_transpose res=K2) on {card}, {limit} W: {res['wall_ms']:.2f} ms wall")
    print(f"{where} total ({TRACED} replays): {total:.2f} ms")
    for title, rows in (("by kernel group", res["by_group"]), ("by kernel", names)):
        print(f"{title}:")
        for name, ms in sorted(rows.items(), key=lambda kv: -kv[1])[:25]:
            print(f"  {ms:8.3f} ms  {100 * ms / total if total else 0.0:5.1f}%  {name[:110]}")
    return res


if __name__ == "__main__":
    main()
