"""Data-parallel scaling benchmark of the port's training step.

    python -m matcha_tpu_torch.cli.bench_scaling [--devices 8] [--batch-per-device 4]
        [--steps 5] [--cpu] [--out FILE]

The port of `matcha_tpu/cli/bench_scaling.py`: training throughput
(utterances/s) at world sizes 1, 2, 4, ... up to `--devices`, and the scaling
efficiency of each against world 1, for `MatchaConfig()` at
`--batch-per-device` synthetic utterances of 200 frames a rank. Each world
size is its own group of processes (rendezvous on a free localhost port):
one a card over NCCL (the cards this host has), or with `--cpu` gloo ranks
on the CPU. Every rank trains through `Trainer(mesh=...)`: on the card a
micro-step is one CUDA graph replay with its gradient all-reduce captured;
after two warm-up steps rank 0 times `--steps` steps, each ended by a
synchronise. Prints one JSON line a world size and one a scaling efficiency,
as the JAX CLI does; `--out` writes the table as JSON.
"""

import argparse
import json
import os
import socket
import tempfile
import time
from pathlib import Path

FRAMES = 200  # the JAX CLI's utterance length
SIZES = (1, 2, 4, 8, 16, 32)


def world_sizes(devices: int, available: int) -> list:
    """The world sizes to run: the powers of two up to both limits."""
    return [d for d in SIZES if d <= min(devices, available)]


def scaling_efficiency(results: list) -> dict:
    """{world size: utterances/s over world size x world 1's}, for sizes > 1."""
    base = results[0]["utterances_per_s"]
    return {str(r["devices"]): r["utterances_per_s"] / (base * r["devices"])
            for r in results[1:]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, cpu: bool, batch: int, steps: int, out: str):
    """One rank of one world size (a spawned process): DP training steps on
    its cut of a global batch; rank 0 writes its mean step seconds to `out`."""
    import torch
    import torch.distributed as dist

    from matcha_tpu_torch.data.dataset import DataConfig, SyntheticDataset, batch_iterator
    from matcha_tpu_torch.models.matcha import MatchaConfig
    from matcha_tpu_torch.parallel import make_mesh
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    if cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        device = "cpu" if cpu else torch.device("cuda", rank)
        data_cfg = DataConfig(batch_size=batch)
        ds = SyntheticDataset(n_items=batch * world, min_frames=FRAMES, max_frames=FRAMES)
        (b,) = batch_iterator(ds, data_cfg, shuffle=False, process_index=rank,
                              process_count=world)
        b.pop("n_real")
        with tempfile.TemporaryDirectory() as ckpt:
            trainer = Trainer(MatchaConfig(), TrainConfig(accumulate_steps=1, log_grad_norm=False,
                                                          ckpt_dir=ckpt),
                              data_cfg, device=device, mesh=make_mesh(model=None))
            trainer.init_optimizer(100)

            def step(i):
                trainer.dispatch([(b, i)], 0)
                if not cpu:
                    torch.cuda.synchronize()

            for i in range(2):  # warm-up: the kernels' first use, the graph's capture
                step(i)
            dist.barrier()
            t0 = time.perf_counter()
            for i in range(steps):
                step(i)
            wall = (time.perf_counter() - t0) / steps
            trainer.logger.close()
        if rank == 0:
            Path(out).write_text(json.dumps({"step_s": wall}))
    finally:
        dist.destroy_process_group()


def run_world(world: int, cpu: bool, batch: int, steps: int) -> float:
    """Mean step seconds of `world` spawned ranks."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "rank0.json")
        mp.start_processes(_rank, args=(world, _free_port(), cpu, batch, steps, out),
                           nprocs=world, join=True, start_method="spawn")
        return json.loads(Path(out).read_text())["step_s"]


def bench(sizes, batch_per_device: int, steps: int, cpu: bool):
    """(a row a world size of `sizes`, the scaling efficiencies), each printed
    as a JSON line."""
    results = []
    for nd in sizes:
        wall = run_world(nd, cpu, batch_per_device, steps)
        batch = batch_per_device * nd
        results.append({"devices": nd, "batch": batch, "step_s": round(wall, 4),
                        "utterances_per_s": round(batch / wall, 2)})
        print(json.dumps(results[-1]), flush=True)
    efficiency = scaling_efficiency(results)
    for d, eff in efficiency.items():
        print(json.dumps({"devices": int(d), "scaling_efficiency": eff}), flush=True)
    return results, efficiency


def main(argv=None):
    ap = argparse.ArgumentParser(description="Data-parallel training scaling (PyTorch port)")
    ap.add_argument("--devices", type=int, default=8, help="the largest world size")
    ap.add_argument("--batch-per-device", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU instead of cards")
    ap.add_argument("--out", help="write the result table to this JSON file")
    args = ap.parse_args(argv)

    import torch

    from matcha_tpu_torch import resolve_device

    if args.cpu:
        available, kind = args.devices, "cpu"
    else:
        resolve_device(None)  # the cards, or an error
        available, kind = torch.cuda.device_count(), torch.cuda.get_device_name(0)

    results, efficiency = bench(world_sizes(args.devices, available), args.batch_per_device,
                                args.steps, args.cpu)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"platform": "cpu" if args.cpu else "gpu", "device_kind": kind,
                       "batch_per_device": args.batch_per_device, "results": results,
                       "scaling_efficiency": {d: round(e, 3) for d, e in efficiency.items()}},
                      f, indent=1)


if __name__ == "__main__":
    main()
