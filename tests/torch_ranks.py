"""Run the port's ranks as processes on the CPU (gloo) for the parallel tests.

Each rank is a fresh interpreter that imports only torch and the port (and
numpy): it reads its inputs from an .npz file, joins the group through the
torchrun variables (`init_distributed(device="cpu")`), runs `body`, and writes
what it returns, a dict of arrays, to its own .npz file.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

_PRELUDE = """
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from matcha_tpu_torch.parallel import init_distributed
inputs = dict(np.load(sys.argv[1], allow_pickle=False))
rank = int(os.environ["RANK"])
assert init_distributed(device="cpu")
import torch.distributed as dist
assert dist.get_world_size() == int(os.environ["WORLD_SIZE"])
"""

_POSTLUDE = """
out = body(inputs, rank)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
               WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def run_ranks(body: str, world: int, inputs: dict, tmp_path, timeout: float = 240) -> list:
    """Run `body` (source defining `body(inputs, rank) -> dict of arrays`) on
    `world` gloo ranks; returns each rank's outputs, in rank order."""
    tmp_path = Path(tmp_path)
    np.savez(tmp_path / "inputs.npz", **inputs)
    code = _PRELUDE + textwrap.dedent(body) + _POSTLUDE
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path / "inputs.npz"), str(tmp_path / f"out{r}.npz")],
        env=rank_env(r, world, port), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]
