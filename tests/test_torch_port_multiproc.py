"""Serving over several devices, the CLIs under several processes, and the
scaling benchmark (CPU).

- `TTSEngine(mesh=make_mesh(devices=[cpu] * 4))` against the engine without a
  mesh: `tests/test_serve.py::test_engine_mesh_sharded_matches_single_device`'s
  texts and seeds (3 requests padded to 4 rows), batch-seed and low-latency
  calls, and `serve()` through the batching worker; atol 1e-3, rtol 1e-4, as
  that test, at the Griffin-Lim engine tests' `mel_mean` of -8
  (`tests/test_torch_port_serve.py::GL_MEL_MEAN`: speech's amplitude, where
  an absolute bar on the waveform means what it says).
- `cli.train` and `cli.train_vocoder` as 2 processes on gloo (`--device cpu`,
  the torchrun variables set), in the spirit of `tests/test_multihost.py`:
  both ranks finish, their validation rows agree (rtol 1e-6), each logged the
  global step count, and rank 0 alone writes the checkpoint.
- `cli.bench_scaling`: its world sizes, table and JSON; a 2-rank CPU run is
  marked slow (about 50 s: two processes build and train `MatchaConfig()`).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from matcha_tpu_torch.audio.mel import MelConfig
from matcha_tpu_torch.cli import bench_scaling
from matcha_tpu_torch.models.matcha import MatchaTTS, tiny_config
from matcha_tpu_torch.parallel import make_mesh
from matcha_tpu_torch.serve import ServeConfig, TTSEngine
from tests.test_torch_port_serve import GL_MEL_MEAN
from tests.torch_ranks import ROOT, free_port, rank_env

TINY = dataclasses.replace(tiny_config(), mel_mean=GL_MEL_MEAN)
TEXTS = ["hello world", "abc", "sharded serving test"]
SEEDS = [7, 8, 9]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def engines():
    torch.manual_seed(0)
    params = MatchaTTS(TINY).state_dict()
    cfg = ServeConfig(n_timesteps=2, mel_budgets=(32, 64, 128), max_batch=8,
                      vocoder="griffin_lim", mel_cfg=MelConfig(n_mels=8))
    one = TTSEngine(params, TINY, cfg, device="cpu")
    four = TTSEngine(params, TINY, cfg, mesh=make_mesh(data=4, devices=["cpu"] * 4))
    return one, four


def _close(a, b):
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-4)


def test_engine_mesh_matches_single_device(engines):
    one, four = engines
    w1, i1 = one.synthesise(TEXTS, seeds=SEEDS)
    w4, i4 = four.synthesise(TEXTS, seeds=SEEDS)
    assert i1["budget"] == i4["budget"] and i1["mel_lengths"] == i4["mel_lengths"]
    for a, b in zip(w1, w4):
        _close(a, b)
    # 3 requests ran as 4 rows, one a device: each device holds its own stages
    assert [set(r.stages) for r in four._replicas] == [
        {("encode", 1, 32), ("decode", 1, 32, i4["budget"])}] * 4


def test_engine_mesh_batch_seed_and_low_latency(engines):
    one, four = engines
    for a, b in zip(one.synthesise(TEXTS, seed=3)[0], four.synthesise(TEXTS, seed=3)[0]):
        _close(a, b)
    wl1, il1 = one.synthesise_lowlatency("hello world", seed=5, budget=64)
    wl4, il4 = four.synthesise_lowlatency("hello world", seed=5, budget=64)
    assert il1["mel_lengths"] == il4["mel_lengths"] and wl4.ndim == 1
    _close(wl1, wl4)


def test_engine_mesh_batching_worker(engines):
    _, four = engines
    solo = [four.synthesise([t], seeds=[s])[0][0] for t, s in zip(TEXTS, SEEDS)]
    four.start_batching(max_wait_ms=50)
    try:
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(3) as ex:
            got = list(ex.map(lambda ts: four.serve(*ts)[0], zip(TEXTS, SEEDS)))
    finally:
        four.stop_batching()
    for a, b in zip(solo, got):
        _close(a, b)


# ------------------------------------------------------------------ CLIs
def _val_rows(path):
    rows = [json.loads(line) for line in Path(path).read_text().splitlines()]
    return [r for r in rows if any(k.startswith("val/") for k in r)]


def _run_cli(module, args, tmp_path, world=2):
    port = free_port()
    procs = []
    for r in range(world):
        env = rank_env(r, world, port)
        env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen([sys.executable, "-m", module, *args], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def _check_run(ckpt, keys, steps):
    rows0 = _val_rows(ckpt / "logs" / "metrics.jsonl")
    rows1 = _val_rows(ckpt / "logs" / "metrics_rank1.jsonl")
    assert len(rows0) == len(rows1) == 1
    for k in keys:
        np.testing.assert_allclose(rows0[0][k], rows1[0][k], rtol=1e-6, err_msg=k)
    assert rows0[0]["step"] == rows1[0]["step"] == steps
    index = json.loads((ckpt / "index.json").read_text())
    assert len(index["entries"]) == 1  # one writer: rank 0
    assert len([p for p in ckpt.iterdir() if p.name.startswith("step_")]) == 1


def test_cli_train_two_processes(tmp_path):
    ckpt = tmp_path / "ck"
    _run_cli("matcha_tpu_torch.cli.train",
             ["--tiny", "--device", "cpu", "--ckpt-dir", str(ckpt), "--batch-size", "2",
              "--max-epochs", "1", "--no-resume"], tmp_path)
    # 16 items / (2 a rank x 2 ranks) = 4 global steps
    _check_run(ckpt, ("val/loss", "val/dur_loss", "val/prior_loss", "val/diff_loss"), 4)


def test_cli_train_vocoder_two_processes(tmp_path):
    ckpt = tmp_path / "vck"
    _run_cli("matcha_tpu_torch.cli.train_vocoder",
             ["--tiny", "--device", "cpu", "--ckpt-dir", str(ckpt), "--batch-size", "2",
              "--epochs", "1", "--segment-size", "2048", "--no-resume"], tmp_path)
    # 8 items / (2 a rank x 2 ranks) = 2 global GAN steps
    _check_run(ckpt, ("val/mel_l1",), 2)


def test_cli_train_refuses_tp_without_ranks(monkeypatch):
    from matcha_tpu_torch.cli import train

    for var in ("MASTER_ADDR", "MATCHA_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit):
        train.main(["--tiny", "--device", "cpu", "--tp", "2"])


# ------------------------------------------------------------ bench_scaling
def test_bench_scaling_sizes_and_table(monkeypatch, tmp_path, capsys):
    assert bench_scaling.world_sizes(8, 3) == [1, 2]
    assert bench_scaling.world_sizes(4, 8) == [1, 2, 4]
    walls = {1: 0.5, 2: 0.625}
    monkeypatch.setattr(bench_scaling, "run_world", lambda nd, cpu, batch, steps: walls[nd])
    out = tmp_path / "scaling.json"
    bench_scaling.main(["--cpu", "--devices", "2", "--batch-per-device", "4", "--out", str(out)])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines == [{"devices": 1, "batch": 4, "step_s": 0.5, "utterances_per_s": 8.0},
                     {"devices": 2, "batch": 8, "step_s": 0.625, "utterances_per_s": 12.8},
                     {"devices": 2, "scaling_efficiency": 0.8}]
    table = json.loads(out.read_text())
    assert table["platform"] == "cpu" and table["scaling_efficiency"] == {"2": 0.8}
    assert [r["devices"] for r in table["results"]] == [1, 2]


@pytest.mark.slow
def test_bench_scaling_two_cpu_ranks(tmp_path):
    """The real thing on gloo: world 1 then 2, one step each (about 50 s)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "matcha_tpu_torch.cli.bench_scaling", "--cpu",
                          "--devices", "2", "--batch-per-device", "1", "--steps", "1",
                          "--out", str(tmp_path / "s.json")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    table = json.loads((tmp_path / "s.json").read_text())
    assert [r["devices"] for r in table["results"]] == [1, 2]
    assert all(r["utterances_per_s"] > 0 for r in table["results"])
