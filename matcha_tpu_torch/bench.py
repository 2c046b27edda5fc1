"""Benchmark: the repository's matrix (root `bench.py`) on the CUDA card.

    python -m matcha_tpu_torch.bench [--fast] [--no-bf16] [--profile DIR]
    python -m matcha_tpu_torch.bench --train-sweep [--out PATH]

The port of the JAX package's `bench.py`, row for row and key for key,
through the port's entry points (`MatchaTTS.synthesise_fixed`, `TTSEngine`,
`Trainer`, `ops.mas`) at that bench's shapes, on random weights (the Matcha
model from seed 0, the HiFi-GAN v1 generator from seed 1). It prints one JSON
line, every key of the JAX bench's and the card's name and power limit:

  * headline (`value`, x_realtime: seconds of audio a second of wall): bf16
    `synthesise_fixed` at batch 128, Tx 64, a budget of 512 frames, 10 Euler
    steps; `fp32_x_realtime`, the same in float32 at batch 64;
  * `ode_sweep_x_realtime`: 2, 4 and 10 steps at batch 64;
  * `single_sentence`: one sentence text -> wav at 50 steps and budget 256,
    float32, Griffin-Lim (32 iterations) or HiFi-GAN v1 in one CUDA graph,
    and bf16 through the engine's low-latency graph (`*_fused_bf16`);
  * `serve_latency_ms`, `serve_throughput_tuned`, `serve_zero_sync`:
    concurrent `TTSEngine.serve` requests (bf16, HiFi-GAN, int16 output);
  * `train_*`: a `Trainer.dispatch` of K = 1 and of K = 8 micro-steps (a CUDA
    graph replay each) at batch 16 (fp32 and bf16) and the tuned batch 128;
  * `mas_*`: the fused MAS kernel against the C++/OpenMP MAS at (16, 100,
    500) and (32, 150, 800), bit-equal paths required, and the kernel inside
    `compute_losses` at batch 128 (`mas_fused_paths_equal`). The `pallas`
    keys keep the JAX bench's names: here they hold the CUDA kernel's time.

Timing: host walls ended by `torch.cuda.synchronize()`, medians. Synthesis
replays one CUDA graph of `synthesise_fixed`, whose noise a generator
registered with the graph draws afresh, INNER times between synchronisations.
MFU: `utils.profiling.product_flops` (products only, counted on the CPU at
batch 1 and scaled by the batch, and by the steps for synthesis, one
estimator call a step) over the card's dense bf16 peak, for the float32 rows
too. A row that fails prints its error to stderr and leaves its key null, and
the run then exits 1. Without `--device` the bench runs on the card and
raises without one; `--device cpu` (with `--tiny`) is for the tests.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch import apply_tf32_policy, resolve_device
from matcha_tpu_torch.audio.griffin_lim import mel_to_audio
from matcha_tpu_torch.audio.mel import MelConfig
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS, tiny_config
from matcha_tpu_torch.models.precision import bf16_serving
from matcha_tpu_torch.ops.attention import attention, attention_backward
from matcha_tpu_torch.ops.mas import mas_cuda
from matcha_tpu_torch.ops.mrf import mrf_step
from matcha_tpu_torch.serve import ServeConfig, TTSEngine, _Eager, _Graph
from matcha_tpu_torch.text import simple_text_to_sequence
from matcha_tpu_torch.utils.profiling import FLOP_COUNTER, product_flops, trace

SR = 22050
HOP = 256
ROOT = Path(__file__).resolve().parents[1]

# dense bf16 tensor-core peak by card name (NVIDIA's data sheet, SXM part):
# the MFU denominator of every row, float32 included
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
# synthesis replays between two synchronisations (the JAX bench's in-graph scan)
INNER = 4
# the JAX bench's shapes, which `main` runs (the tests shrink them): batches of
# the headline, parity, tuned-training and fused-MAS rows, the synthesis
# texts' ids and mel budget, and the MAS rows' (B, Tx, Ty)
SHAPES = {"headline_batch": 128, "parity_batch": 64, "tuned_batch": 128, "fused_batch": 128,
          "tx": 64, "ty": 512, "mas": ((16, 100, 500), (32, 150, 800))}
# every kernel wrapper: the launches a bench graph records at capture
COUNTED = {"attention_fwd": attention, "attention_bwd": attention_backward, "mas": mas_cuda,
           "mrf_step": mrf_step}

# one sentence for every single-sentence row
SINGLE_SENTENCE_TEXT = "the quick brown fox jumps over the lazy sleeping dog today"
# the serving rows' texts, all in one 64-token text bucket
SERVE_TEXTS = [
    "the quick brown fox jumps over the lazy sleeping dog today",
    "flow matching synthesis runs fast on tensor processing units",
    "monotonic alignment search now runs directly on the accelerator",
    "this sentence exists to measure serving latency percentiles now",
]


# ------------------------------------------------------------------ helpers
def configs(tiny: bool = False):
    """(MatchaConfig, HiFiGANConfig): full width, or reduced widths at 80
    mels (Griffin-Lim's `MelConfig()`) for the tests."""
    if not tiny:
        return MatchaConfig(), HiFiGANConfig()
    return tiny_config(80), HiFiGANConfig(upsample_initial_channel=16)


def init_model(mcfg: MatchaConfig, seed: int = 0) -> MatchaTTS:
    """MatchaTTS with PyTorch's initialisation drawn from `seed`, on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return MatchaTTS(mcfg)


def init_generator(hcfg: HiFiGANConfig, seed: int = 1) -> Generator:
    """The serving-form HiFi-GAN generator from `seed`, on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return Generator(hcfg, weight_norm=False)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_time(call, iters, device):
    """Median seconds of `iters` calls, each between two synchronisations."""
    times = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        call()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _stage(fn, args, device, generators=()):
    """`fn` over fixed-shape tensors `args`: on the card one CUDA graph
    (`serve._Graph`, its own pool) that draws from `generators` afresh at
    each replay; on the CPU an eager call."""
    if device.type == "cpu":
        return _Eager(fn)
    return _Graph(fn, args, device, torch.cuda.graph_pool_handle(), generators, COUNTED)


def _graph_entry(row, stage, **what) -> dict:
    """A record entry: a stage's replays and the launches each replay makes."""
    return dict(what, row=row, replays=getattr(stage, "replays", 0),
                launches=dict(stage.launches))


def _engine_entry(row, eng) -> dict:
    """A record entry: each stage the engine replayed, by its key."""
    return {"row": row, "bf16": eng.cfg.bf16, "vocoder": eng.cfg.vocoder,
            "stages": [{"key": list(key), "replays": getattr(s, "replays", 0),
                        "launches": dict(s.launches)} for key, s in eng._stages.items()]}


def card_line(device):
    """(card name, power limit in W or None): nvidia-smi's name and
    power.limit, or the card's name from torch where nvidia-smi is absent."""
    if device.type != "cuda":
        return "cpu", None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
        name, limit = (p.strip() for p in out[device.index or 0].split(","))
        return name, float(limit.split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return torch.cuda.get_device_name(device), None


# -------------------------------------------------------------- FLOP counts
def estimator_flops(mcfg: MatchaConfig, ty: int, batch: int = 1) -> int:
    """Products of one U-Net (CFM estimator) forward at (batch, ty), counted
    on the CPU in float32 on one thread."""
    est = init_model(mcfg).decoder.estimator.eval()
    x = torch.zeros(batch, mcfg.n_feats, ty)
    with _one_thread(), torch.no_grad():
        return product_flops(est, x, torch.ones(batch, 1, ty), x, torch.full((batch,), 0.5))


def train_step_flops(mcfg: MatchaConfig, tx: int, ty: int, out_size=None, batch: int = 1) -> int:
    """Products of one training micro-step's forward and backward
    (`compute_losses` and the gradients of its loss) on `train_batch`,
    counted on the CPU in float32 on one thread. The optimizer's elementwise
    passes are not counted."""
    from matcha_tpu_torch.train.trainer import total_loss

    model = init_model(mcfg).train()
    b = {k: torch.from_numpy(v) for k, v in train_batch(batch, tx, ty, mcfg.n_feats).items()}
    params = list(model.parameters())
    gen = torch.Generator().manual_seed(0)

    def step():
        out = model.compute_losses(b["x"], b["x_lengths"], b["y"], b["y_lengths"],
                                   out_size=out_size, generator=gen)
        torch.autograd.grad(total_loss(out), params, allow_unused=True)

    with _one_thread():
        return product_flops(step)


# -------------------------------------------------------------- synthesis
def make_synthesis(batch, tx, ty, n_timesteps, bf16, device, mcfg):
    """(model, x, xl, generator, stage): seed-0 weights on `device` (bf16
    when asked), `batch` random texts of `tx` ids (numpy's default_rng(0)),
    and `synthesise_fixed` at budget `ty` as one stage (`_stage`) returning
    (mel, mel lengths), its noise drawn from `generator`."""
    model = init_model(mcfg).eval().to(device)
    if bf16:
        bf16_serving(model)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(3, 140, size=(batch, tx))).to(device)
    xl = torch.full((batch,), tx, dtype=torch.int64, device=device)
    gen = torch.Generator(device=device).manual_seed(1)

    def synth(x, xl):
        out = model.synthesise_fixed(x, xl, ty, n_timesteps, generator=gen)
        return out["mel"], out["mel_lengths"]

    return model, x, xl, gen, _stage(synth, (x, xl), device, [gen])


def bench_synthesis(batch=64, tx=64, ty=512, n_timesteps=10, iters=5, bf16=False,
                    with_cost=False, device=None, mcfg=None, record=None, profile_dir=None):
    """Batched synthesis throughput. Returns (x_realtime, wall s a batch,
    audio s a batch, products of the batch or None): `synthesise_fixed`
    replayed INNER times between synchronisations, the median of `iters`.
    `profile_dir`: a torch.profiler trace of INNER more replays goes there."""
    device = resolve_device(device)
    mcfg = mcfg or MatchaConfig()
    _, x, xl, _, stage = make_synthesis(batch, tx, ty, n_timesteps, bf16, device, mcfg)

    def repeated():
        for _ in range(INNER):
            out = stage.run(x, xl)
        return out

    repeated()
    wall = _median_time(repeated, iters, device) / INNER
    if profile_dir is not None:
        with trace(profile_dir, device):
            repeated()
    flops = n_timesteps * batch * estimator_flops(mcfg, ty) if with_cost else None
    if record is not None:
        record.append(_graph_entry("synthesis", stage, batch=batch, ty=ty,
                                   n_timesteps=n_timesteps, bf16=bf16,
                                   mel_lengths=stage.run(x, xl)[1].tolist()))
    audio_seconds = batch * ty * HOP / SR
    return audio_seconds / wall, wall, audio_seconds, flops


def bench_single_sentence(vocoder: str, n_timesteps=50, ty=256, iters=5, device=None,
                          mcfg=None, hcfg=None, record=None):
    """Single-sentence text -> wav latency in float32, the whole path in one
    stage: `synthesise_fixed` at 50 steps and budget `ty`, then Griffin-Lim
    (32 iterations, its phase drawn in the stage) or HiFi-GAN v1. Returns
    (x_realtime, wall s, audio s), the audio of the sentence's predicted
    length under these weights."""
    device = resolve_device(device)
    mcfg, hcfg = mcfg or MatchaConfig(), hcfg or HiFiGANConfig()
    model = init_model(mcfg).eval().to(device)
    seq = simple_text_to_sequence(SINGLE_SENTENCE_TEXT)
    x = torch.tensor([seq], dtype=torch.int64, device=device)
    xl = torch.tensor([len(seq)], dtype=torch.int64, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    if vocoder == "hifigan":
        voc = init_generator(hcfg).eval().to(device)

        def wav_fn(mel):
            return voc(mel)
    elif vocoder == "griffin_lim":
        mel_cfg = MelConfig()

        def wav_fn(mel):
            return mel_to_audio(mel_cfg, mel.transpose(1, 2), generator=gen)
    else:
        raise ValueError(f"unknown vocoder {vocoder!r}")

    def full(x, xl):
        out = model.synthesise_fixed(x, xl, ty, n_timesteps, generator=gen)
        return wav_fn(out["mel"]), out["mel_lengths"]

    stage = _stage(full, (x, xl), device, [gen])
    frames = int(stage.run(x, xl)[1][0])  # the one host read, before the timed calls
    wall = _median_time(lambda: stage.run(x, xl), iters, device)
    if record is not None:
        record.append(_graph_entry("single_sentence", stage, vocoder=vocoder, ty=ty,
                                   n_timesteps=n_timesteps, mel_frames=frames))
    audio_seconds = frames * HOP / SR
    return audio_seconds / wall, wall, audio_seconds


# ---------------------------------------------------------------- serving
def _full_size_engine(vocoder="hifigan", steps=10, bf16=True, mel_budgets=(256, 512),
                      max_batch=8, device=None, mcfg=None, hcfg=None):
    """A `TTSEngine` on the bench's weights, int16 output (PCM16 on the card)."""
    mcfg, hcfg = mcfg or MatchaConfig(), hcfg or HiFiGANConfig()
    cfg = ServeConfig(n_timesteps=steps, bf16=bf16, vocoder=vocoder,
                      mel_budgets=tuple(mel_budgets), max_batch=max_batch,
                      output_dtype="int16")
    gsd = init_generator(hcfg).state_dict() if vocoder == "hifigan" else None
    return TTSEngine(init_model(mcfg).state_dict(), mcfg, cfg, gsd, hcfg, device=device)


def run_clients(eng, texts, n_requests, threads, closed_loop=True):
    """`n_requests` calls of `eng.serve` (its batching worker started), text
    i % len(texts) and seed i: from `threads` persistent closed-loop clients,
    each sending its next request when its last returns, or else one thread a
    request with at most `threads` at once. Returns (latency ms, own wall ms,
    group sizes, seconds of the whole run)."""
    lat_ms, wall_ms, group_sizes = [], [], []
    lock = threading.Lock()

    def request(i):
        _, info = eng.serve(texts[i % len(texts)], seed=i)
        with lock:
            lat_ms.append(info["latency_s"] * 1e3)
            wall_ms.append(info["wall_s"] * 1e3)
            group_sizes.append(info["group_size"])

    t0 = time.perf_counter()
    if closed_loop:
        nxt = iter(range(n_requests))

        def client():
            while True:
                with lock:
                    i = next(nxt, None)
                if i is None:
                    return
                request(i)

        pool = [threading.Thread(target=client) for _ in range(threads)]
        for t in pool:
            t.start()
    else:
        pool = []
        for i in range(n_requests):
            pool.append(threading.Thread(target=request, args=(i,)))
            pool[-1].start()
            if len(pool) >= threads:
                pool.pop(0).join()
    for t in pool:
        t.join()
    return lat_ms, wall_ms, group_sizes, time.perf_counter() - t0


def bench_serve_latency(n_requests=32, threads=8, steps=10, max_batch=8, eng=None,
                        closed_loop=False, device=None, mcfg=None, hcfg=None, record=None):
    """Request latency through the batching front end (`serve()`): p50 and
    p99 of enqueue -> delivery, the median of each request's own compute path
    (`wall_p50`), requests/s and the mean group size. Given an engine, its own
    `max_batch` is warmed and reported; the texts share one text bucket."""
    if eng is None:
        eng = _full_size_engine(steps=steps, max_batch=max_batch, device=device, mcfg=mcfg,
                                hcfg=hcfg)
    else:
        max_batch, steps = eng.cfg.max_batch, eng.cfg.n_timesteps
    warm = sorted({1, 2, 4, 8, max_batch})
    eng.warmup(batch_sizes=tuple(b for b in warm if b <= max_batch), text=SERVE_TEXTS[0])
    eng.start_batching(max_wait_ms=5)
    try:
        lat_ms, wall_ms, group_sizes, wall_total = run_clients(eng, SERVE_TEXTS, n_requests,
                                                               threads, closed_loop)
    finally:
        eng.stop_batching()
    if record is not None:
        record.append(_engine_entry("serve", eng))
    lat = np.asarray(lat_ms)
    return {
        "p50": round(float(np.percentile(lat, 50)), 1),
        "p99": round(float(np.percentile(lat, 99)), 1),
        "wall_p50": round(float(np.median(wall_ms)), 1),
        "requests_per_s": round(n_requests / wall_total, 1),
        "mean_group_size": round(float(np.mean(group_sizes)), 2),
        "n": n_requests, "threads": threads, "steps": steps, "max_batch": max_batch,
        "precision": "bf16" if eng.cfg.bf16 else "fp32", "vocoder": eng.cfg.vocoder,
    }


def bench_single_sentence_fused(vocoder: str, steps=50, budget=256, iters=5, device=None,
                                mcfg=None, hcfg=None, record=None):
    """Single-sentence latency through the engine's low-latency graph (one
    replay from ids to packed int16 rows) at bf16, 50 steps, one budget.
    Returns (x_realtime, wall s, audio s)."""
    eng = _full_size_engine(vocoder=vocoder, steps=steps, mel_budgets=(budget,), max_batch=1,
                            device=device, mcfg=mcfg, hcfg=hcfg)
    text = SINGLE_SENTENCE_TEXT
    eng.synthesise_lowlatency(text, seed=0)  # capture
    wall = _median_time(lambda: eng.synthesise_lowlatency(text, seed=1), iters, eng.device)
    _, info = eng.synthesise_lowlatency(text, seed=1)
    if record is not None:
        record.append(_engine_entry("single_sentence_fused", eng))
    audio_seconds = info["mel_lengths"][0] * HOP / SR
    return audio_seconds / wall, wall, audio_seconds


# ---------------------------------------------------------------- training
def train_batch(batch, tx, ty, n_feats=80) -> dict:
    """The fixed synthetic training batch (numpy's default_rng(2)): random
    ids, full lengths, a random-walk mel."""
    rng = np.random.default_rng(2)
    mel = np.cumsum(0.1 * rng.standard_normal((batch, ty, n_feats)), axis=1)
    return {"x": rng.integers(3, 140, size=(batch, tx)).astype(np.int32),
            "x_lengths": np.full((batch,), tx, np.int32),
            "y": mel.astype(np.float32),
            "y_lengths": np.full((batch,), ty, np.int32)}


def bench_train(batch=16, tx=64, ty=512, k=8, iters=6, precision="fp32", out_size=None,
                accumulate_steps=2, device=None, mcfg=None, record=None, profile_dir=None):
    """Training-step time through `Trainer.dispatch`: one micro-step a
    dispatch (K = 1) and K micro-steps a dispatch (one graph replay on the
    card) over K copies of the batch, each dispatch ended by a
    synchronisation; reference hyperparameters, 2-step accumulation.
    `profile_dir`: a torch.profiler trace of one more K dispatch goes there.
    `record`: an entry with the micro-steps, the graphs' launches and the
    first micro-step's metrics row (`trainer.METRICS`).

    Returns (ms a K = 1 dispatch, ms a micro-step at K, K, products of one
    micro-step's forward and backward at `batch`)."""
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(device)
    mcfg = mcfg or MatchaConfig()
    b = train_batch(batch, tx, ty, mcfg.n_feats)
    index = iter(range(1 << 30))  # a fresh schedule index, so fresh noise, every micro-step
    with tempfile.TemporaryDirectory(prefix="matcha_bench_") as tmp:
        trainer = Trainer(mcfg, TrainConfig(log_grad_norm=False, precision=precision,
                                            out_size=out_size, accumulate_steps=accumulate_steps,
                                            steps_per_dispatch=k, ckpt_dir=tmp), device=device)
        try:
            trainer.init_optimizer(steps_per_epoch=16)

            def dispatch(n):
                return trainer.dispatch([(b, next(index)) for _ in range(n)], epoch=0)

            first = dispatch(1)[0].tolist()  # the first micro-step's metrics (`METRICS`)
            for _ in range(accumulate_steps - 1):  # each other emit pattern's graph
                dispatch(1)
            t_single = _median_time(lambda: dispatch(1), iters, device)
            dispatch(k)
            t_scan = _median_time(lambda: dispatch(k), iters, device) / k
            if profile_dir is not None:
                with trace(profile_dir, device):
                    dispatch(k)
            if record is not None:
                steps = sum(kk * n for kk, n in trainer.replays.items())
                record.append({"row": "train", "batch": batch, "tx": tx, "ty": ty,
                               "precision": precision, "out_size": out_size,
                               "micro_steps": steps, "launches": dict(trainer.launches),
                               "first_metrics": first})
        finally:
            trainer.logger.close()
    step_flops = batch * train_step_flops(mcfg, tx, ty, out_size)
    return t_single * 1e3, t_scan * 1e3, k, step_flops


def mas_fused_check(batch=128, device=None, mcfg=None, record=None):
    """The MAS kernel inside the whole loss graph against the C++ MAS.

    `compute_losses` on a `SyntheticDataset` batch runs as one stage (a CUDA
    graph on the card); the scores, mask and lengths that reached
    `maximum_path` in it are recorded, and its path must equal
    `maximum_path_cpp` on those same scores and mask bit for bit."""
    from matcha_tpu_torch.data.dataset import DataConfig, SyntheticDataset, batch_iterator
    from matcha_tpu_torch.models import matcha
    from matcha_tpu_torch.ops.mas_cpp import maximum_path_cpp

    device = resolve_device(device)
    mcfg = mcfg or MatchaConfig()
    model = init_model(mcfg).eval().to(device)
    ds = SyntheticDataset(n_items=2048, n_mels=mcfg.n_feats, seed=0)
    b = next(batch_iterator(ds, DataConfig(batch_size=batch), epoch=0))
    args = tuple(torch.from_numpy(b[k]).to(device) for k in ("x", "x_lengths", "y", "y_lengths"))
    gen = torch.Generator(device=device).manual_seed(1)
    seen, search = [], matcha.maximum_path

    def recording(value, mask, t_x=None, t_y=None):
        path = search(value, mask, t_x, t_y)
        seen.append((value, mask, path))
        return path

    def losses(x, xl, y, yl):
        with torch.no_grad():
            return model.compute_losses(x, xl, y, yl, generator=gen)["attn"]

    matcha.maximum_path = recording
    try:
        stage = _stage(losses, args, device, [gen])
        stage.run(*args)
    finally:
        matcha.maximum_path = search
    # the last call's tensors: on the card the capture's, which the replay rewrote
    value, mask, path = seen[-1]
    want = maximum_path_cpp(value.float().cpu().numpy(), mask.float().cpu().numpy())
    if record is not None:
        record.append(_graph_entry("mas_fused", stage, batch=batch, shape=list(value.shape),
                                   x_lengths=b["x_lengths"].tolist(),
                                   y_lengths=b["y_lengths"].tolist()))
    return bool(np.array_equal(path.float().cpu().numpy(), want))


def _pin_omp():
    """Pin OpenMP's thread count before the C++ MAS library loads (recorded in
    the JSON line): its time floats with ambient load otherwise."""
    os.environ.setdefault("OMP_NUM_THREADS", str(os.cpu_count() or 1))


def bench_mas(b=32, tx=150, ty=800, device=None, record=None):
    """The MAS kernel against the C++/OpenMP MAS at one of the reference's
    bench shapes (`cli.bench_mas`'s problem and timers): (C++ ms over kernel
    ms, kernel ms, C++ ms, paths bit-equal). The kernel's ms are device time
    by CUDA events; on the CPU the plain version's host time."""
    from matcha_tpu_torch.cli import bench_mas as cli
    from matcha_tpu_torch.ops import mas
    from matcha_tpu_torch.ops.mas_cpp import maximum_path_cpp

    _pin_omp()
    device = resolve_device(device)
    value, mask = cli.make_problem(b, tx, ty)
    tv, tm = torch.from_numpy(value).to(device), torch.from_numpy(mask).to(device)
    t_x, t_y = mas.lengths_from_mask(tm)
    before = mas_cuda.launches
    paths_equal = bool(np.array_equal(mas.maximum_path(tv, tm, t_x, t_y).cpu().numpy(),
                                      maximum_path_cpp(value, mask)))
    timer = cli.device_ms if device.type == "cuda" else cli.host_ms
    t_kernel = timer(lambda: mas.maximum_path(tv, tm, t_x, t_y))
    if record is not None:
        record.append({"row": "mas", "shape": [b, tx, ty],
                       "launches": {"mas": mas_cuda.launches - before}})
    t_cpp = cli.host_ms(lambda: maximum_path_cpp(value, mask))
    return t_cpp / t_kernel, t_kernel, t_cpp, paths_equal


# ------------------------------------------------------------- train sweep
def train_sweep(out_path=None, device=None, mcfg=None, iters=4):
    """Training throughput over batch {16, 32, 64, 128} x out_size {None,
    256} in bf16, and fp32 at 16 and 128, each at K 1 and 8 (Tx 64, Ty 512).
    Writes one JSON file (default build/train_sweep.json): per row the step
    times, MFU and samples/s, or the error of a row that failed."""
    device = resolve_device(device)
    out_path = Path(out_path) if out_path is not None else ROOT / "build" / "train_sweep.json"
    name, limit = card_line(device)
    peak = PEAK_FLOPS.get(name)
    configs_ = [dict(batch=batch, precision="bf16", out_size=out_size)
                for batch in (16, 32, 64, 128) for out_size in (None, 256)]
    configs_ += [dict(batch=16, precision="fp32", out_size=None),
                 dict(batch=128, precision="fp32", out_size=None)]
    rows = []
    for c in configs_:
        t0 = time.perf_counter()
        try:
            t_single, t_scan, k, flops = bench_train(iters=iters, k=8, device=device,
                                                     mcfg=mcfg, **c)
        except Exception as e:  # a row that does not fit is recorded, and the sweep goes on
            rows.append(dict(c, error=f"{type(e).__name__}: {e}"[:300]))
            print(f"sweep row {c} failed: {e!r}", file=sys.stderr)
            if device.type == "cuda":
                torch.cuda.empty_cache()
            continue
        rows.append(dict(
            c, train_step_ms_k1=round(t_single, 2), train_step_ms_k8=round(t_scan, 2),
            step_flops=flops,
            mfu_k1=None if peak is None else round(flops / (t_single / 1e3) / peak, 4),
            mfu_k8=None if peak is None else round(flops / (t_scan / 1e3) / peak, 4),
            samples_per_s_k8=round(c["batch"] / (t_scan / 1e3), 1),
            wall_s=round(time.perf_counter() - t0, 1)))
        print(json.dumps(rows[-1]), file=sys.stderr)
    out = {"device": name, "power_limit_w": limit, "tx": 64, "ty": 512, "k": 8,
           "iters": iters, "peak_flops_bf16": peak, "flop_counter": FLOP_COUNTER,
           "note": "k1 = one micro-step a Trainer.dispatch; k8 = a micro-step's share of "
                   "an 8-micro-step dispatch (one CUDA graph replay). MFU = products of "
                   "a micro-step / time / dense bf16 peak.",
           "rows": rows}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    print(json.dumps({"wrote": str(out_path), "n_rows": len(rows)}))
    return out


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The bench matrix on the PyTorch/CUDA port")
    ap.add_argument("--fast", action="store_true",
                    help="headline, fp32 and MAS rows only (MATCHA_BENCH_FAST)")
    ap.add_argument("--no-bf16", action="store_true",
                    help="skip the bf16 rows; fp32 becomes the headline (MATCHA_BENCH_NO_BF16)")
    ap.add_argument("--train-sweep", action="store_true", help="the training sweep instead")
    ap.add_argument("--out", default=None, help="the training sweep's JSON file "
                                                "(default build/train_sweep.json)")
    ap.add_argument("--profile", default=None,
                    help="torch.profiler traces into this dir: the headline's INNER replays "
                         "(synthesis/) and one K dispatch of each tuned training row (train/, "
                         "train_out_size256/)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true", help="reduced widths, for tests")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        apply_tf32_policy()
    mcfg, hcfg = configs(args.tiny)
    if args.train_sweep:
        out = train_sweep(args.out, device, mcfg)
        return int(any("error" in r for r in out["rows"]))
    _pin_omp()
    fast, no_bf16 = args.fast, args.no_bf16
    name, limit = card_line(device)
    peak = PEAK_FLOPS.get(name)
    kw = {"device": device, "mcfg": mcfg}
    syn = {"tx": SHAPES["tx"], "ty": SHAPES["ty"]}
    failed = []

    def row(what, fn, *a, **k):
        try:
            return fn(*a, **k)
        except Exception:  # a failed row leaves its key null; the run exits 1
            print(f"{what} failed:\n{traceback.format_exc()}", file=sys.stderr)
            failed.append(what)
            return None

    def _mfu(flops, wall):
        return None if (flops is None or peak is None) else round(flops / wall / peak, 4)

    def profile(name):
        return None if args.profile is None else str(Path(args.profile) / name)

    # fp32 parity row at batch 64
    fp32 = row("fp32 synthesis", bench_synthesis, batch=SHAPES["parity_batch"], with_cost=True,
               **syn, **kw)
    fp32_xrt = fp32_mfu = None
    if fp32 is not None:
        fp32_xrt, fp32_mfu = fp32[0], _mfu(fp32[3], fp32[1])
    if no_bf16:
        head = fp32
        batch, precision = SHAPES["parity_batch"], "fp32"
    else:
        batch, precision = SHAPES["headline_batch"], "bf16"
        head = row("bf16 synthesis", bench_synthesis, batch=batch, bf16=True, with_cost=True,
                   profile_dir=profile("synthesis"), **syn, **kw)
    xrt, wall, audio_s, mfu = (None,) * 4
    if head is not None:
        xrt, wall, audio_s, mfu = head[0], head[1], head[2], _mfu(head[3], head[1])

    ode_sweep, single = {}, {}
    serve_latency = serve_throughput = serve_zero_sync = None
    if not fast:
        for steps in (2, 4, 10):
            r = row(f"ode sweep {steps}", bench_synthesis, batch=SHAPES["parity_batch"],
                    n_timesteps=steps, iters=3, bf16=not no_bf16, **syn, **kw)
            ode_sweep[str(steps)] = None if r is None else round(r[0], 1)
        for voc in ("griffin_lim", "hifigan"):
            r = row(f"single sentence {voc}", bench_single_sentence, voc, iters=3, hcfg=hcfg,
                    **kw)
            single[voc] = None if r is None else {
                "x_realtime": round(r[0], 1), "wall_s": round(r[1], 4),
                "audio_s": round(r[2], 3), "mel_frames": round(r[2] * SR / HOP)}
        if not no_bf16:
            for voc in ("griffin_lim", "hifigan"):
                r = row(f"single sentence fused {voc}", bench_single_sentence_fused, voc,
                        iters=3, hcfg=hcfg, **kw)
                single[voc + "_fused_bf16"] = None if r is None else {
                    "x_realtime": round(r[0], 1), "wall_s": round(r[1], 4),
                    "audio_s": round(r[2], 3), "mel_frames": round(r[2] * SR / HOP)}
            serve_latency = row("serve latency", bench_serve_latency, hcfg=hcfg, **kw)
            # throughput: a single-budget (zero-sync) engine, groups of 16, 32 clients
            serve_throughput = row(
                "serve throughput", lambda: dict(bench_serve_latency(
                    n_requests=256, threads=32, closed_loop=True, eng=_full_size_engine(
                        steps=10, mel_budgets=(256,), max_batch=16, hcfg=hcfg, **kw)),
                    mel_budgets=[256], zero_sync=True))
            serve_zero_sync = row(
                "serve zero sync", lambda: dict(bench_serve_latency(
                    n_requests=32, threads=8, eng=_full_size_engine(
                        steps=10, mel_budgets=(256,), max_batch=8, hcfg=hcfg, **kw)),
                    mel_budgets=[256]))
        for key in ("griffin_lim", "hifigan"):
            if single.get(key) is not None:
                print(f"single sentence {key}: {single[key]['mel_frames']} predicted mel "
                      f"frames ({single[key]['audio_s']} s of audio)", file=sys.stderr)

    train_ms = train_scan_ms = scan_k = train_mfu = None
    train_scan_bf16_ms = train_mfu_bf16 = train_tuned = None
    if not fast:
        r = row("train fp32 batch 16", bench_train, **kw)
        if r is not None:
            train_ms, train_scan_ms, scan_k, flops = r
            train_mfu = _mfu(flops, train_scan_ms / 1e3)
        if not no_bf16:
            r = row("train bf16 batch 16", bench_train, precision="bf16", iters=4, **kw)
            if r is not None:
                train_scan_bf16_ms, train_mfu_bf16 = r[1], _mfu(r[3], r[1] / 1e3)
            # the tuned recipe: batch 128, and its out_size=256 random crops
            tb = SHAPES["tuned_batch"]
            tuned = row(f"train bf16 batch {tb}", bench_train, batch=tb, precision="bf16",
                        iters=3, profile_dir=profile("train"), **kw)
            cropped = row(f"train bf16 batch {tb} out_size 256", bench_train, batch=tb,
                          precision="bf16", iters=3, out_size=256,
                          profile_dir=profile("train_out_size256"), **kw)
            if tuned is not None and cropped is not None:
                train_tuned = {
                    "batch": tb, "k": 8, "precision": "bf16", "step_ms": round(tuned[1], 2),
                    "mfu": _mfu(tuned[3], tuned[1] / 1e3),
                    "samples_per_s": round(tb / (tuned[1] / 1e3), 1),
                    "out_size256_step_ms": round(cropped[1], 2),
                    "out_size256_samples_per_s": round(tb / (cropped[1] / 1e3), 1)}

    # MAS at both large reference shapes; the largest is the summary row
    mas_shapes = {}
    for b, tx, ty in SHAPES["mas"]:
        r = row(f"mas {b}x{tx}x{ty}", bench_mas, b, tx, ty, device=device)
        mas_shapes[f"{b}x{tx}x{ty}"] = last = None if r is None else {
            "pallas_ms": round(r[1], 4), "cpp_ms": round(r[2], 4), "speedup": round(r[0], 2),
            "paths_equal": r[3]}
    mas_equal = None if None in mas_shapes.values() else all(
        v["paths_equal"] for v in mas_shapes.values())
    mas_fused_equal = row("mas fused check", mas_fused_check, batch=SHAPES["fused_batch"], **kw)

    def r2(v, n=2):
        return None if v is None else round(v, n)

    result = {
        "metric": "audio_seconds_per_second_per_chip",
        "value": r2(xrt),
        "unit": "x_realtime",
        "vs_baseline": r2(xrt),
        "backend": device.type,
        "precision": precision,
        "batch": batch,
        "ode_steps": 10,
        "wall_s_per_batch": r2(wall, 4),
        "audio_s_per_batch": r2(audio_s),
        "mfu": mfu,
        "fp32_x_realtime": r2(fp32_xrt, 1),
        "fp32_mfu": fp32_mfu,
        "ode_sweep_x_realtime": ode_sweep,
        "single_sentence": single,
        "serve_latency_ms": serve_latency,
        "serve_throughput_tuned": serve_throughput,
        "serve_zero_sync": serve_zero_sync,
        "mas_pallas_ms": None if last is None else last["pallas_ms"],
        "mas_cpp_ms": None if last is None else last["cpp_ms"],
        "mas_pallas_vs_cpp_speedup": None if last is None else last["speedup"],
        "mas_shapes": mas_shapes,
        "mas_paths_equal": mas_equal,
        "mas_fused_paths_equal": mas_fused_equal,
        "omp_num_threads": int(os.environ["OMP_NUM_THREADS"]),
        "train_step_ms": r2(train_ms),
        "train_step_ms_scan_dispatch": r2(train_scan_ms),
        "train_step_ms_scan_bf16": r2(train_scan_bf16_ms),
        "train_scan_dispatch_k": scan_k,
        "train_mfu": train_mfu,
        "train_mfu_bf16": train_mfu_bf16,
        "train_tuned": train_tuned,
        "device": name,
        "power_limit_w": limit,
        "peak_flops_bf16": peak,
        "flop_counter": FLOP_COUNTER,
        "mfu_note": "MFU = counted products / wall / the card's dense bf16 peak, fp32 rows too",
        "failed_rows": failed,
    }
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
