#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`matcha_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out PATH]

Run from the root of a checkout, on a machine with one CUDA card, `nvcc` and
PyTorch built for CUDA. In order:

1. prints the card's name and power limit, builds every kernel of
   `matcha_tpu_torch/csrc/` with nvcc (all sources in parallel);
2. holds each kernel against its plain PyTorch version on the card:
   K1 (attention, output and row log-sum-exp) at B=2, H=4, T in {128, 1000,
   1024} and at B=1, T in {512, 1024} (the key-split path), D=64 with a
   ragged 0/1 bias, K2 (MRF step) at every (C, k, d) of the generator at
   B=2, T=4099 (prime) and B=1, T in {1, 7, 8192}, both in float32 and bf16;
   the fused MAS kernel (K3a and K3b in one launch) bit-equal to the plain
   version, its path and its decisions, at B=16, Tx in {1, 45, 64, 256}, Ty
   in {45, 448, 1024}, at Tx = Ty = 1024, with a bf16 value (f32 and bf16
   masks), with a mask with holes and with lengths and widths at their
   edges (0, past Tx and Ty, t_y < t_x, Tx 32, 33, 129, 513, Ty 1, 2, 65);
   one `maximum_path` call profiled (one CUDA kernel); the DP chain's step
   latency L measured by a probe; K4
   (attention backward, dbias included) in float32 and bf16 at the shapes of
   K1, fed the plain forward's (o, lse) and once K1's own;
3. the serving paths, through the engine's CUDA graphs (captured by
   `warmup`, whose seconds and graph-pool bytes are recorded): `TTSEngine` at
   full width (MatchaConfig() and HiFi-GAN v1, random weights from `--seed`,
   bf16, int16 output), 4 texts with per-request seeds, then one
   `synthesise_lowlatency` at the 1024-frame budget, with the counts set to 0
   just before and read just after (the graph replays' K1 and K2 launches as
   derived, no eager launch); both requests against the same calls made
   eagerly on the card with the same noise (bit-equal expected); each request
   replayed under the profiler (wall, busy, idle, kernels; the profiler's K1
   and K2 counts equal the graph accounting); 20 low-latency walls. Then the
   same for a full-width Griffin-Lim engine in f32 at `MelConfig()`, with
   Griffin-Lim card vs CPU, and 8 threads through `serve()` across two
   budgets, each equal to its solo synthesis. Then one batch of 16 texts
   (the engine's `max_batch`) through `synthesise` at budget 512 on the
   graphs of a bf16 HiFi-GAN engine, counted the same way (K1 60, K2 36 a
   replay, none eager), profiled and timed; and each feed-forward variant of
   the decoder block ("gelu", "gelu-approximate", "geglu", "snake",
   "snakebeta") at full width, card against CPU in f32 through K1;
4. the training path: `Trainer.fit` at full width on 64 synthetic items
   (batch 16: 4 micro-steps, 2 updates and a validation batch an epoch), one
   epoch in fp32, one in bf16, then the bf16 run resumed for a second at
   steps_per_dispatch 2, every micro-step a CUDA graph replay, with the
   counts set to 0 just before and read just after (the replays' K1, K4 and
   MAS launches as derived; eager launches only in the graphs' captures and
   warm-ups; every validation batch a replay of the validation graph of its
   shapes, MAS 1 and K1 6 each). Then the training graphs on a bucket set
   (128 items of 300-400 frames): the same micro-steps eagerly and as K = 2
   and 1-step replays, fp32 and bf16 (metrics within their bars, parameters
   within the drift bars, bit equality reported beside a second eager run);
   a `fit` epoch at K = 1 against K = 4 (per-step logs within rtol 1e-4),
   its profile trace holding the graphs' kernels; one replay with remat
   "full" and "dots" against none; launches per replay by the graph
   accounting and by the profiler's kernel names; micro-step walls (median
   of 20 replays, 10 eager steps), busy, idle, host calls a dispatch,
   capture seconds and the graph pool's bytes; validation on its graphs
   against the same batches eagerly on the same weights (64 items, fp32 and
   bf16 trainers; losses within rtol 2e-5), a pass's launches by the graph
   accounting and by the profiler, and the walls of a pass eager and
   replayed;
5. the vocoder training path at full width (`HiFiGANConfig()`, v1's
   discriminators, `VocoderTrainConfig()`, batch 16 of 8192 samples, 64
   synthetic items: 4 GAN steps an epoch): `VocoderTrainer.fit` two epochs
   at K = 4 with 8 validation items, resumed for a third at K = 1, every GAN
   step and every validation batch a CUDA graph replay (none eager, no K2 in
   training), all losses finite; validation replayed against eager on the
   same weights, and a pass's walls; an epoch at K = 1 against the K = 4 run's first (per-step logs
   within rtol 1e-4); the same 4 steps eagerly on the card, twice, against
   the replays (metrics, parameters); one GAN step at batch 2 card vs CPU;
   GAN-step walls replayed and eager, busy, idle, host calls, capture
   seconds and pool bytes; then the trained generator folded by
   `load_generator_for_inference` and served by an f32 and a bf16
   `TTSEngine(vocoder="hifigan")`, one low-latency request each through its
   graph with the counts set to 0 just before and read just after (K2 36
   and K1 60 a replay, none eager; K2 36 recorded at capture; the profiler
   agrees), each waveform against the training-form generator on the
   engine's own mel within K2's f32 and bf16 bars;
6. the entry points as a user calls them, on the card with no --device, from
   the reference's file formats (a Lightning `.ckpt` and a weight-normed
   `generator_v1`, written from the same random weights): `cli.generate` at
   10 steps with HiFi-GAN (K1 60 and K2 36 counted between a reset and a
   read) and with Griffin-Lim (K1 60, K2 0), mel and wav against the same
   calls made directly; `cli.serve --bf16 --int16` with HiFi-GAN on 4 texts,
   plain, --concurrent and --low-latency, every wav bit-equal to the CLI's
   engine's direct call with the same seed, the engine's launches whole
   replays of K1 60 and K2 36 a decode graph, none eager but the captures;
   `cli.bench_mas` (the fused MAS kernel bit-equal to the plain version and
   the C++ MAS at (8, 50, 200), (16, 100, 500) and (32, 150, 800), then
   timed); `cli.vocoder_report --synthetic --n 4` on the trained vocoder
   store (K2 36 an item, each item's waveform against the training-form
   generator on the same mel within K2's f32 bar); then the examples at full
   width with no --device: `examples/demo_torch.py` (K1 60, K2 36, mel and
   both waveforms against the same calls made directly) and
   `examples/demo_serving_torch.py --bf16` (launches replayed and at capture
   equal to a fresh engine's driven directly through the same calls, every
   wav bit-equal);
7. holds the port on the card against itself on the CPU in float32 with TF32
   off (one served text; one training forward and backward, losses and
   gradients) and against the frozen reference outputs of
   `tests/fixtures/golden_e2e*.npz`;
8. at every shape each path gave each kernel (the Griffin-Lim engine's K1 in
   f32, the trained vocoder's K1 and K2 in both dtypes, generate's K1 and K2
   and vocoder_report's K2 in f32 and bench_mas's MAS included), holds
   the kernel against its plain version and times the kernel, its plain
   version and the matching PyTorch call (SDPA for K1, K2's unfused
   sequence), beside the least time the card could take, the batch of 16
   included (path `serve16`); times K1 and K4
   a call at the serving shapes (batch 1 and 4) and at training's B=16,
   T=448 in both dtypes; times K2 at every (C, T, k, d) of a 1024-frame
   request and of a batch of 4 at 512, in both dtypes, beside its plain
   version, the unfused PyTorch sequence and its bound, summed by stage.

9. (run after 6) the `parallel` phase: this process as one rank of a
   torchrun-style group on NCCL (`init_distributed`, idempotent), at full
   width: `Trainer.fit` (one epoch of the bucket set at K = 2, fp32) on a
   data group and with the tensor-parallel path at model 1, every
   micro-step a replay with its all-reduces captured, launches per
   micro-step and validation as without a group, logs and parameters within
   the training graphs' bars of a trainer without a group, and a micro-step's
   median replayed wall and busy ms with and without; one K = 4 graph of GAN
   steps on a data group against none, and a GAN step's wall and busy ms;
   `TTSEngine(mesh=)` over the card bit-equal to the engine without a mesh,
   with the same launches; `ring_attention` at one rank and the ring's K1
   block steps with their f32 lse merge over 4 blocks for 4 ranks in this
   process, at (B, T) = (4, 512) and (4, 256) in f32 and bf16, against K1
   over the whole T; `decode_fixed` with `seq_axis` on a one-rank mesh
   against `decode_fixed` (budget 512, 10 steps, f32); `cli.bench_scaling
   --devices 1`. The path's launches are the runs' with a group, a mesh or a
   ring (the references' are not counted), timed at their shapes as path
   `parallel`.

10. the `bench` phase: the port's bench (`matcha_tpu_torch.bench`) at the
   JAX bench's shapes, the counts set to 0 just before and read just after:
   bf16 synthesis at batch 128 and f32 at 64 (budget 512, 10 steps, one
   CUDA graph replayed), MAS at (16, 100, 500) and (32, 150, 800) against
   the C++ MAS and inside the loss graph at batch 128, training at batch
   128 bf16 through `Trainer.dispatch` at K 1 and 8, the bf16 HiFi-GAN
   sentence at 50 steps, and 256 `serve()` requests from 32 clients (groups
   up to 16); any null or unequal row fails. The path's launches come from
   the rows' record (graph replays, engine stages, trainer micro-steps,
   eager MAS calls), split by shape and held against the graph accounting;
   the headline's replay bit-equal (or within 1e-6 relative) to an eager
   call on the same noise, its K1 launches (60 a replay) against the
   profiler's; row 0 of a batch-128 f32 replay against a batch-1 call on
   the same text and noise (the card-vs-CPU mel bar); K1 and K4 a call at
   (128, 4, 512, 64) in both dtypes beside SDPA; every kernel timed at
   every shape the path gave it, as path `bench`.

11. the `tools` phase: the JAX package's last instruments' counterparts as a
   user runs them, the counts set to 0 just before and read just after:
   `cli.trace_train_step` at batch 128 bf16, K 8, with attribution (the
   traced device ms a dispatch within 0.8-1.05 of the synchronised wall of
   the same dispatches; launches by the graph accounting and, for the traced
   replays, by the profiler; every FFT-group kernel of the eager micro-step
   on an op with shapes; the three heaviest rows printed);
   `cli.profile_vocoder` at 8 x 256 in bf16 and f32 (K2 36 a replay by the
   graph and by the profiler; the graph's output against the generator
   through K2's plain version); `cli.train_mfu_sweep`'s `remat_dots` and
   `cudnn_benchmark` children at --iters 2 (no error, no null, their graphs'
   launches, first losses against `base`, the bench phase's `bench_train`
   at batch 128 bf16, within 1e-6 and 1e-3 relative). The in-process tools'
   kernels are timed at their shapes as path `tools`.

Prints one JSON line per result; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises and the script exits non-zero; so does a machine with
no CUDA card or a directory without the package. Details (every check,
the profiles and each kernel's per-shape times) go to `--out`, by default
build/chip_smoke.json.
"""

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, float32 rate outside
# the tensor cores, and HBM3 bandwidth. The attention kernels compute their
# float32 products as three TF32 tensor-core products (f32 accuracy), so the
# least time for f32-accurate products there is at a third of the dense TF32
# rate, 495/3 TFLOP/s; MAS does float32 work on the CUDA cores and is bound
# by its chain of dependent frames (`chain_step_ns`).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_F32_3XTF32_FLOPS = 495e12 / 3
PEAK_FLOPS = {torch.bfloat16: PEAK_BF16_FLOPS, torch.float32: PEAK_F32_3XTF32_FLOPS}
PEAK_BYTES = 3.35e12

# tolerances of a kernel against its plain version on the same inputs
# (|kernel - plain| <= atol + rtol * |plain| elementwise). float32: sums in
# another order, the JAX package's bar for its attention kernel. bf16: the bar
# of the JAX package's bf16 attention test, a few bf16 steps (2^-8 relative)
# of the output: both versions round the output once, and K2 also rounds
# lrelu(x) and z to bf16 for the tensor cores where the plain version keeps f32.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
TOL_MRF_F32 = (1e-4, 1e-4)  # up to C*k = 2816 products summed per output
# K4 against its plain version, max |kernel - plain| over max |plain| per gradient:
# float32 takes the JAX package's bar for its fused backward; in bf16 both
# versions round p and ds at the same places, so what differs is summation
# order and the rounding of the outputs (2^-9 of the largest)
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
# card vs CPU, float32 with TF32 off, one training step: the loss bars of
# tests/test_loss_parity.py (duration, prior, flow matching, relative), and
# the gradients' error over their max |grad| (sums in other orders through
# the whole backward)
TOL_LOSS = {"dur_loss": 2e-4, "prior_loss": 2e-4, "diff_loss": 2e-3}
TOL_GRAD = 1e-3
# card vs CPU, float32 end to end: the mel and mu_y bars of
# tests/test_golden_e2e.py; the waveform, bounded by tanh, takes the mel's
TOL_MEL, TOL_MU, TOL_WAV = 1e-3, 5e-4, 1e-3

DURATION_BIAS = "encoder.duration_predictor.output_projection.bias"
TEXTS = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It is easy to tell the depth of a well, when the rope is long enough.",
    "Four hours of steady work faced us.",
]
LONG_TEXT = ("A large size in stockings is hard to sell, but the shop on the corner "
             "keeps a few pairs for the winter.")


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def module_weights(module, seed, overrides=None):
    """Random weights for `module`'s state dict, one PCG64 stream per sorted key.

    Norm gammas near 1, biases near 0, weights scaled by their fan-in;
    `overrides` maps a key to a bias mean.
    """
    out = {}
    for idx, (key, val) in enumerate(sorted(module.state_dict().items())):
        shape = tuple(val.shape)
        n = np.random.default_rng([seed, idx]).standard_normal(shape).astype(np.float32)
        if key in (overrides or {}):
            arr = overrides[key] + 0.02 * n
        elif len(shape) == 1:
            arr = 1.0 + 0.05 * n if key.endswith(".weight") else 0.02 * n
        else:
            arr = n / np.sqrt(int(np.prod(shape[1:])))
        out[key] = torch.from_numpy(arr.astype(np.float32))
    return out


def model_weights(mcfg, hcfg, seed):
    """Random Matcha and HiFi-GAN state dicts from `seed`. The duration bias
    mean 0.3 puts predictions at 6-7 mel frames a character at full width,
    near speech's 5-6."""
    from matcha_tpu_torch.models.hifigan import Generator
    from matcha_tpu_torch.models.matcha import MatchaTTS

    return (module_weights(MatchaTTS(mcfg), seed, {DURATION_BIAS: 0.3}),
            module_weights(Generator(hcfg), seed + 1))


def max_err_within(got, want, atol, rtol, what):
    """Max |got - want| (f32); raises if any element is outside atol + rtol*|want|."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max())
    if bool((diff > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{what}: max abs err {err:.3g} over atol {atol} rtol {rtol}")
    return err


def cuda_ms(fn, reps, sleep_cycles=50_000_000):
    """Mean device time of `fn` in ms, by CUDA events around `reps` calls.

    A spin kernel ahead of the first timed call keeps the card busy while the
    host enqueues the calls, so the events time them back to back on the card
    and not the host's launch rate (a call costs the host tens of µs, more
    than many of these kernels take). The spin is lengthened until it outlasts
    the host's enqueueing.
    """
    fn()
    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    marks[0].record()
    torch.cuda._sleep(sleep_cycles)
    marks[1].record()
    for _ in range(reps):
        fn()
    marks[2].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= marks[0].elapsed_time(marks[1]):
        if sleep_cycles > 10 ** 11:
            raise RuntimeError("the host cannot enqueue the timed calls ahead of the card")
        return cuda_ms(fn, reps, 4 * sleep_cycles)
    return marks[1].elapsed_time(marks[2]) / reps


def events_ms(fn, reps):
    """Mean time of `fn` in ms by CUDA events around `reps` calls, with no spin
    ahead of them: for a function of thousands of small launches (the plain
    MAS, ~15 a mel frame), which fill the card's launch queue behind any spin,
    so that its time is the host's launch rate, as it is in use."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 2
def attention_inputs(b, h, t, d, dtype, dev, gen, lengths=None, frames=None):
    """q, k, v (b, h, t, d) and a 0/1 key bias with keys [0, lengths[i]) of row
    i on. With `frames`, the bias is the first t keys of a `frames`-key mask, a
    row-strided view, as the decoder's truncated masks are."""
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    lengths = torch.tensor(lengths if lengths is not None else [t, max(1, t - 37)][:b],
                           device=dev)
    keys = torch.arange(t if frames is None else frames, device=dev)
    bias = (keys[None, :] < lengths[:, None]).to(dtype)[:, :t]
    return q, k, v, bias


def mrf_inputs(b, c, t, k, dtype, dev, gen):
    x = torch.randn((b, c, t), generator=gen, device=dev)
    w1, w2 = (torch.randn((c, c, k), generator=gen, device=dev) / math.sqrt(c * k)
              for _ in range(2))
    b1, b2 = (0.05 * torch.randn((c,), generator=gen, device=dev) for _ in range(2))
    return tuple(a.to(dtype).contiguous() for a in (x, w1, b1, w2, b2))


# (B, T) of the K1 and K4 checks: B = 1 at T = 512 and 1024 takes K1's key split
ATTENTION_CHECKS = ((2, 128), (2, 1000), (2, 1024), (1, 512), (1, 1024))
# (B, T) of the K2 checks at every (C, k, d): a prime T (no vector loads, a
# ragged last tile), one frame, fewer frames than a halo, and stage 0's batch-1 T
MRF_CHECKS = ((2, 4099), (1, 1), (1, 7), (1, 8192))


def check_kernels(dev, seed):
    """Each kernel against its plain version on the card; returns max errors."""
    from matcha_tpu_torch.ops.attention import (attention_cuda, attention_plain,
                                                key_splits)
    from matcha_tpu_torch.ops.mrf import mrf_step_cuda, mrf_step_plain

    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {"attention_fwd": {}, "mrf_step": {}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        atol, rtol = TOL[name]
        worst = worst_lse = 0.0
        for b, t in ATTENTION_CHECKS:
            q, k, v, bias = attention_inputs(b, 4, t, 64, dtype, dev, gen)
            for bb in (bias, None):
                what = (f"K1 {name} B={b} T={t} splits={key_splits(b, 4, t, dtype, sms)} "
                        f"bias={'ragged' if bb is not None else 'none'}")
                got, lse = attention_cuda(q, k, v, bb, 0.125, with_lse=True)
                alone = attention_cuda(q, k, v, bb, 0.125)
                torch.cuda.synchronize()
                want, want_lse = attention_plain(q, k, v, bb, 0.125, with_lse=True)
                worst = max(worst, max_err_within(got, want, atol, rtol, what))
                worst_lse = max(worst_lse, max_err_within(lse, want_lse, atol, rtol,
                                                          f"{what} lse"))
                if not torch.equal(alone, got):
                    raise AssertionError(f"{what}: the output differs between two launches")
        errs["attention_fwd"][name] = {"max_abs_err": worst, "lse_max_abs_err": worst_lse,
                                       "atol": atol, "rtol": rtol}
        log(f"K1 attention_fwd {name}: max abs err {worst:.3g}, lse {worst_lse:.3g} "
            f"(tolerance atol {atol} rtol {rtol})")

        atol, rtol = TOL_MRF_F32 if dtype == torch.float32 else TOL[name]
        worst = 0.0
        for c in (256, 128, 64, 32):
            for k in (3, 7, 11):
                for d in (1, 3, 5):
                    for b, t in MRF_CHECKS:
                        args = mrf_inputs(b, c, t, k, dtype, dev, gen)
                        got = mrf_step_cuda(*args, d)
                        torch.cuda.synchronize()
                        worst = max(worst, max_err_within(
                            got, mrf_step_plain(*args, d), atol, rtol,
                            f"K2 {name} B={b} T={t} C={c} k={k} d={d}"))
        errs["mrf_step"][name] = {"max_abs_err": worst, "atol": atol, "rtol": rtol}
        log(f"K2 mrf_step {name}: max abs err {worst:.3g} at (B, T) in {list(MRF_CHECKS)} "
            f"(tolerance atol {atol} rtol {rtol})")
    return errs


def mas_inputs(b, tx, ty, dev, gen, full_first=True):
    """(B, Tx, Ty) scores and a mask of random lengths with t_x <= t_y; the first
    utterance at the caps (t_x = min(Tx, Ty), t_y = Ty)."""
    value = torch.randn((b, tx, ty), generator=gen, device=dev)
    t_x = torch.randint(1, min(tx, ty) + 1, (b,), generator=gen, device=dev)
    t_y = torch.maximum(torch.randint(1, ty + 1, (b,), generator=gen, device=dev), t_x)
    if full_first:
        t_x[0], t_y[0] = min(tx, ty), ty
    mask = ((torch.arange(tx, device=dev)[None, :, None] < t_x[:, None, None])
            & (torch.arange(ty, device=dev)[None, None, :] < t_y[:, None, None])).float()
    return value, mask, t_x.to(torch.int32), t_y.to(torch.int32)


def check_mas(value, mask, t_x, t_y, what):
    """The fused MAS kernel bit-equal to the plain version: its path (dtype
    included) to `maximum_path_plain`'s, its decisions (`bits_out`) to
    `mas_forward_plain`'s on the same scores, and `maximum_path` to both."""
    from matcha_tpu_torch.ops import mas

    want = mas.maximum_path_plain(value, mask, t_x, t_y)
    path, words = mas.mas_cuda(value, mask, t_x, t_y, with_bits=True)
    score = (value * mask).float().transpose(1, 2).contiguous()
    bits = mas.mas_forward_plain(score, t_x, t_y)
    got = mas.unpack_words(words, value.shape[1])
    frames = torch.arange(score.shape[1], device=score.device)[None, :, None] < t_y[:, None, None]
    if not torch.equal(got & frames, bits & frames):
        raise AssertionError(f"MAS {what}: take-diagonal bits differ from the plain version "
                             f"(a fault of the DP)")
    if path.dtype != want.dtype or not torch.equal(path, want):
        raise AssertionError(f"MAS {what}: path differs from the plain version "
                             f"(a fault of the walk back or the output)")
    if not torch.equal(mas.maximum_path(value, mask, t_x, t_y), want):
        raise AssertionError(f"MAS {what}: maximum_path differs from the plain version")
    return want


def mas_checks(dev, gen):
    """(what, (value, mask, t_x, t_y)) of the fused MAS kernel's checks besides
    the 12 training shapes: Tx = Ty = 1024 (32 cells a lane, 2 stages), bf16
    values with f32 and bf16 masks (some mask cells at 0.3, so that a bf16
    product rounds), masks with holes (not an outer product of the lengths)
    at a vector-load shape and at an odd Ty (element loads), and lengths and
    widths at their edges."""
    out = [("B=16 Tx=1024 Ty=1024", mas_inputs(16, 1024, 1024, dev, gen))]
    value, mask, t_x, t_y = mas_inputs(16, 64, 448, dev, gen)
    frac = torch.where(torch.rand(mask.shape, generator=gen, device=dev) < 0.2, 0.3, 1.0) * mask
    out += [("bf16 value, f32 mask", (value.bfloat16(), frac, t_x, t_y)),
            ("bf16 value, bf16 mask", (value.bfloat16(), frac.bfloat16(), t_x, t_y))]
    for b, tx, ty in ((16, 64, 448), (16, 45, 45)):
        value, mask, t_x, t_y = mas_inputs(b, tx, ty, dev, gen)
        holes = mask * (torch.rand(mask.shape, generator=gen, device=dev) > 0.15)
        out.append((f"mask with holes B={b} Tx={tx} Ty={ty}", (value, holes, t_x, t_y)))
    # lengths at and past the edges, and Tx, Ty around the kernel's cell and
    # chunk sizes
    for what, tx, ty, t_x, t_y in (
            ("t_x or t_y 0", 10, 30, [10, 0, 5], [30, 20, 0]),
            ("lengths past Tx, Ty", 10, 30, [12, 10, 10], [30, 40, 35]),
            ("t_y < t_x", 20, 30, [20, 15, 20], [10, 12, 20]),
            ("Tx 32", 32, 97, [32, 16, 1], [97, 90, 32]),
            ("Tx 33", 33, 97, [33, 16, 1], [97, 90, 33]),
            ("Tx 129", 129, 97, [129, 64, 1], [97, 90, 50]),
            ("Tx 513", 513, 97, [513, 256, 1], [97, 90, 50]),
            ("Ty 1", 40, 1, [1, 1], [1, 1]),
            ("Ty 2", 40, 2, [2, 1], [2, 1]),
            ("Ty 65", 40, 65, [40, 7], [65, 64])):
        t_x = torch.tensor(t_x, device=dev, dtype=torch.int32)
        t_y = torch.tensor(t_y, device=dev, dtype=torch.int32)
        mask = ((torch.arange(tx, device=dev)[None, :, None] < t_x[:, None, None])
                & (torch.arange(ty, device=dev)[None, None, :] < t_y[:, None, None])).float()
        out.append((what, (torch.randn(mask.shape, generator=gen, device=dev), mask, t_x, t_y)))
    return out


def profile_mas_call(dev, seed):
    """One `maximum_path` call at B = 16, Tx = 64, Ty = 448 under torch.profiler:
    it must run exactly one CUDA kernel, the fused one."""
    from torch.profiler import ProfilerActivity, profile

    from matcha_tpu_torch.ops.mas import maximum_path

    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    value, mask, t_x, t_y = mas_inputs(16, 64, 448, dev, gen)
    maximum_path(value, mask, t_x, t_y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        maximum_path(value, mask, t_x, t_y)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(names) != 1 or "mas_path" not in names[0]:
        raise AssertionError(f"one maximum_path call ran CUDA kernels {names}, not the one "
                             f"fused kernel")
    log(f"maximum_path at B=16 Tx=64 Ty=448 under the profiler: 1 CUDA kernel, {names[0][:60]}")
    return {"cuda_kernels": names}


def chain_step_ns(dev, steps=(50_000, 100_000), reps=5):
    """L, the latency of one dependent step of the MAS recursion (a max and an
    add, on one thread: what a frame needs whatever the design), from
    `mas.chain_probe` at two step counts (CUDA events, the fastest of `reps`
    each): the slope, in ns."""
    from matcha_tpu_torch.ops.mas import chain_probe

    def best_ms(n):
        chain_probe(n, dev)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            chain_probe(n, dev)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return min(times)

    t1, t2 = best_ms(steps[0]), best_ms(steps[1])
    return (t2 - t1) / (steps[1] - steps[0]) * 1e6


def grad_err(got, want, what, tol):
    """(max |got - want| / max |want|, max |got - want|) over the pieces; raises
    when the first is over `tol`."""
    worst, worst_abs = 0.0, 0.0
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            continue
        g, w = g.float(), w.float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {name}: non-finite output")
        diff = float((g - w).abs().max())
        err = diff / max(float(w.abs().max()), 1e-30)
        if err > tol:
            raise AssertionError(f"{what} {name}: error {err:.3g} of max |grad| over {tol}")
        worst, worst_abs = max(worst, err), max(worst_abs, diff)
    return worst, worst_abs


def check_training_kernels(dev, seed):
    """The fused MAS kernel bit-equal to its plain version at B = 16, Tx in {1,
    45, 64, 256}, Ty in {45, 448, 1024} and at `mas_checks`; K4 in f32 and bf16
    against its plain version at the shapes of K1's check, ragged bias (dbias
    too) and none: both fed the plain forward's (o, lse), and K4 once more fed
    K1's own."""
    from matcha_tpu_torch.ops.attention import (attention_bwd_cuda, attention_bwd_plain,
                                                attention_cuda, attention_plain)

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    errs = {"mas": {}, "attention_bwd": {}}
    n = 0
    for tx in (1, 45, 64, 256):
        for ty in (45, 448, 1024):
            check_mas(*mas_inputs(16, tx, ty, dev, gen), f"B=16 Tx={tx} Ty={ty}")
            n += 1
    checks = mas_checks(dev, gen)
    for what, args in checks:
        check_mas(*args, what)
    torch.cuda.synchronize()
    errs["mas"]["bit_equal"] = {"max_abs_err": 0.0, "shapes": n + len(checks),
                                "checks": [what for what, _ in checks]}
    log(f"MAS (K3a + K3b fused): path and decisions bit-equal to the plain version at {n} "
        f"shapes (B=16, Tx in 1/45/64/256, Ty in 45/448/1024) and at "
        f"{[what for what, _ in checks]}")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = TOL_BWD[name]
        worst, worst_abs, worst_own = 0.0, 0.0, 0.0
        for b, t in ATTENTION_CHECKS:
            q, k, v, bias = attention_inputs(b, 4, t, 64, dtype, dev, gen)
            do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            for bb in (bias, None):
                what = f"K4 {name} B={b} T={t} bias={'ragged' if bb is not None else 'none'}"
                o, lse = attention_plain(q, k, v, bb, 0.125, with_lse=True)
                got = attention_bwd_cuda(q, k, v, bb, do, o, lse, 0.125, bb is not None)
                own = attention_bwd_cuda(q, k, v, bb, do,
                                         *attention_cuda(q, k, v, bb, 0.125, with_lse=True),
                                         0.125, bb is not None)
                torch.cuda.synchronize()
                want = attention_bwd_plain(q, k, v, bb, do, o, lse, 0.125)
                if bb is None:
                    want = want[:3] + (None,)
                rel, diff = grad_err(got, want, what, tol)
                worst, worst_abs = max(worst, rel), max(worst_abs, diff)
                worst_own = max(worst_own, grad_err(own, want, f"{what} (K1's o, lse)", tol)[0])
        errs["attention_bwd"][name] = {"max_err_of_max_grad": worst, "max_abs_err": worst_abs,
                                       "max_err_of_max_grad_k1_o_lse": worst_own, "tol": tol}
        log(f"K4 attention_bwd {name}: max error {worst:.3g} of max |grad|, {worst_own:.3g} fed "
            f"K1's o and lse (tolerance {tol})")
    return errs


# ---------------------------------------------------------------- phase 3
def attention_shapes(dcfg, budget):
    """[(launches, T)] of K1 in one estimator call at `budget` mel frames: each
    U-Net level runs its down and up transformer blocks at its length, the
    mid blocks run at the last level's."""
    levels = len(dcfg.channels)
    counts = [2 * dcfg.n_blocks] * levels
    counts[-1] += dcfg.num_mid_blocks * dcfg.n_blocks
    return [(n, budget // 2 ** i) for i, n in enumerate(counts)]


def mrf_shapes(hcfg, mel_frames):
    """[(C, T, k, d)] of K2's launches in one generator call on `mel_frames`."""
    shapes, t = [], mel_frames
    for i, up in enumerate(hcfg.upsample_rates):
        t *= up
        for k, dils in zip(hcfg.resblock_kernel_sizes, hcfg.resblock_dilation_sizes):
            shapes += [(hcfg.upsample_initial_channel // 2 ** (i + 1), t, k, d) for d in dils]
    return shapes


def reset_wrapper_counts():
    from matcha_tpu_torch.serve import COUNTED

    for w in COUNTED.values():
        w.launches = 0


def reset_serving_counts(engine):
    """Every serving count to 0: the engine's graph accounting and the wrappers'."""
    reset_wrapper_counts()
    engine.launches = {name: 0 for name in engine.launches}


def wrapper_counts():
    from matcha_tpu_torch.serve import COUNTED

    return {name: w.launches for name, w in COUNTED.items()}


def graph_pool_bytes(engine):
    """Bytes the allocator holds in the engine's shared graph pool, from its
    memory snapshot, or "not measured" where the snapshot names no pools."""
    segments = torch.cuda.memory._snapshot()["segments"]
    if not segments or "segment_pool_id" not in segments[0]:
        return "not measured (the memory snapshot names no pools)"
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) == tuple(engine._pool))


def warm_engine(engine, warm):
    """Capture the graphs of `warm` [(batch sizes, text)]: seconds, graphs
    captured and the memory they hold."""
    n = len(engine._stages)
    t0 = time.perf_counter()
    for sizes, text in warm:
        engine.warmup(sizes, text)
    torch.cuda.synchronize()
    return {"capture_s": time.perf_counter() - t0, "graphs": len(engine._stages) - n,
            "pool_bytes": graph_pool_bytes(engine)}


def serve_requests(engine, seeds):
    """The main path's two requests: 4 texts with per-request seeds, then one
    `synthesise_lowlatency` at the 1024-frame budget."""
    wavs, info = engine.synthesise(TEXTS, seeds=seeds)
    wav_ll, info_ll = engine.synthesise_lowlatency(LONG_TEXT, seed=7, budget=1024)
    return wavs, info, wav_ll, info_ll


def check_waveforms(wavs, info, wav_ll, info_ll, dtype, hop=256):
    for wav, ml in list(zip(wavs, info["mel_lengths"])) + [(wav_ll, info_ll["mel_lengths"][0])]:
        if wav.dtype != dtype or wav.shape != (ml * hop,) or ml < 8:
            raise AssertionError(f"waveform {wav.dtype} {wav.shape} for {ml} mel frames")
        if not np.isfinite(wav.astype(np.float32)).all() or np.abs(wav).max() == 0:
            raise AssertionError("silent or non-finite waveform")
    if info_ll["budget"] != 1024 or any(info["truncated"]) or info_ll["truncated"]:
        raise AssertionError(f"budgets {info['budget']}/{info_ll['budget']}, truncation "
                             f"{info['truncated']}/{info_ll['truncated']}")


def eager_vs_graphs(engine, seeds, wavs, info, wav_ll, info_ll, tol):
    """The same model calls made eagerly on the card (the engine's stage
    functions, no graph) with the same noise and phase, against what the
    graphs served: bit-equal is expected; a gap must stay within `tol`
    (waveform units). Returns the gaps."""
    dev = engine.device
    out = {}
    for name, served, run in (
            ("synthesise", wavs, lambda x, xl: engine._decode(
                info["budget"], *engine._encode(x, xl),
                *engine._draws(len(TEXTS), info["budget"], None, seeds))),
            ("lowlatency", [wav_ll], lambda x, xl: engine._synth(
                1024, x, xl, *engine._draws(1, 1024, None, [7])))):
        texts = TEXTS if name == "synthesise" else [LONG_TEXT]
        x, xl = (a.to(dev) for a in engine._tokenize(texts))
        want, _, _ = engine._finish(run(x, xl).cpu().numpy(), len(texts))
        gap = max(float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
                  for a, b in zip(served, want))
        equal = all(np.array_equal(a, b) for a, b in zip(served, want))
        if not equal and gap > tol:
            raise AssertionError(f"{name}: graphs and eager calls differ by {gap} (bar {tol})")
        out[name] = {"bit_equal": equal, "max_abs_gap": gap, "bar": tol}
    return out


def replay_profile(engine, call, what):
    """One replayed request under torch.profiler: wall, busy, idle, kernels;
    the K1 and K2 kernels the device ran must equal the launches the graph
    accounting added for the request."""
    before = dict(engine.launches)
    prof = profile_request(call)
    added = {name: engine.launches[name] - before[name] for name in before}
    seen = {"attention_fwd": prof.get("launches_by_group", {}).get("K1 attention_fwd", 0),
            "mrf_step": prof.get("launches_by_group", {}).get("K2 mrf_step", 0)}
    if "kernel_launches" not in prof or seen != added:
        raise AssertionError(f"{what}: the profiler saw {seen} kernels, the graph accounting "
                             f"added {added} ({prof.get('device_ms')})")
    prof["launches_per_replay"] = added
    log(f"{what} replayed under the profiler: wall {prof['wall_ms']:.2f} ms, busy "
        f"{prof['device_ms']:.2f} ms, idle {prof['idle_share']:.3f}, {prof['kernel_launches']} "
        f"kernels; K1, K2 by the profiler {seen} = by the graph accounting")
    return prof


def drive_engine(engine, label, want, wav_dtype, tol):
    """The main path's two requests through a warmed engine's graphs, with
    the counts set to 0 just before and read just after (replayed launches
    as `want`, none eager); against the same calls eager on the card (`tol`:
    the bar of a gap, in waveform units); 20 low-latency walls and one
    profiled replay of each request kind."""
    seeds = list(range(100, 100 + len(TEXTS)))
    warm = warm_engine(engine, [((len(TEXTS),), TEXTS[2]), ((1,), LONG_TEXT)])
    log(f"{label} engine warm-up: {warm['graphs']} graphs captured in "
        f"{warm['capture_s']:.1f} s, pool {warm['pool_bytes']} bytes")

    reset_serving_counts(engine)
    wavs, info, wav_ll, info_ll = serve_requests(engine, seeds)
    counts, eager = dict(engine.launches), wrapper_counts()
    log(f"{label} path launches by graph replay {counts} (expected {want}); eager "
        f"{eager} (expected none)")
    if counts != want or any(eager.values()):
        raise AssertionError(f"kernel launches {counts} replayed and {eager} eager, "
                             f"expected {want} replayed and none eager")
    check_waveforms(wavs, info, wav_ll, info_ll, wav_dtype)
    gaps = eager_vs_graphs(engine, seeds, wavs, info, wav_ll, info_ll, tol)
    log(f"{label} engine, graphs vs the same calls eager on the card: {gaps}")

    repeats = [serve_requests(engine, seeds) for _ in range(3)]  # steady state, uncounted
    ll_walls = [engine.synthesise_lowlatency(LONG_TEXT, seed=7, budget=1024)[1]["wall_s"]
                for _ in range(20)]
    profile = {"lowlatency": replay_profile(
                   engine, lambda: engine.synthesise_lowlatency(LONG_TEXT, seed=7, budget=1024),
                   f"low-latency request ({label})"),
               "synthesise": replay_profile(
                   engine, lambda: engine.synthesise(TEXTS, seeds=seeds),
                   f"synthesise, 4 texts ({label})")}
    log(f"{label} low-latency wall over 20 requests: median "
        f"{1e3 * float(np.median(ll_walls)):.2f} ms, max {1e3 * max(ll_walls):.2f} ms")
    return {
        "warmup": warm,
        "synthesise": {"requests": len(TEXTS), "budget": info["budget"],
                       "mel_lengths": info["mel_lengths"], "wall_s": info["wall_s"],
                       "rtf": info["rtf"], "wall_s_repeats": [r[1]["wall_s"] for r in repeats]},
        "lowlatency": {"budget": 1024, "mel_lengths": info_ll["mel_lengths"],
                       "wall_s": info_ll["wall_s"], "rtf": info_ll["rtf"],
                       "wall_s_repeats": [r[3]["wall_s"] for r in repeats],
                       "wall_s_20": ll_walls, "wall_ms_median": 1e3 * float(np.median(ll_walls)),
                       "wall_ms_max": 1e3 * max(ll_walls)},
        "launches": counts,
        "eager_vs_graphs": gaps,
        "profile": profile,
    }


def serve_main_path(dev, mcfg, hcfg, seed):
    """Serve 4 texts and one 1024-frame low-latency request through the CUDA
    graphs of a bf16 HiFi-GAN engine; returns the engine's numbers."""
    from matcha_tpu_torch.serve import ServeConfig, TTSEngine

    msd, gsd = model_weights(mcfg, hcfg, seed)
    scfg = ServeConfig(bf16=True, vocoder="hifigan", output_dtype="int16")
    engine = TTSEngine(msd, mcfg, scfg, gsd, hcfg, device=dev)
    decodes = 2  # one request group, one low-latency request
    want = {"attention_fwd": decodes * scfg.n_timesteps
            * sum(n for n, _ in attention_shapes(mcfg.decoder, 1024)),
            "mrf_step": decodes * len(mrf_shapes(hcfg, 1))}
    # int16 of a bf16 chain: any gap would be another kernel or algorithm
    # choice; bar: the float waveform's 1e-3 in 16-bit steps
    return drive_engine(engine, "HiFi-GAN, bf16", want, np.int16, TOL_WAV * 32767)


# The Griffin-Lim engine's mel statistics. A trained decoder's output is
# normalised (about unit spread), and the reference's LJSpeech statistics
# (mean -5.536622, std 2.116101) map it into speech's log-mel range, about
# [-11.5, 2]. Random weights put the output at about 4x that spread, and
# Griffin-Lim is homogeneous (a mel e^k louder gives a waveform and errors e^k
# larger), so the absolute 1e-3 waveform bars hold at speech's amplitude only:
# LJSpeech's mean with a quarter of its std puts these random mels there.
GL_MEL = {"mel_mean": -5.536622, "mel_std": 2.116101 / 4}
# 8 concurrent requests: the 4 texts and 4 shorter ones, so that the group
# splits over two budgets
SERVE_TEXTS = TEXTS + ["Open the door.", "The sun is out today.",
                       "Help the woman get back to her feet.", "Kick the ball straight."]


def griffin_lim_card_vs_cpu(engine, seed):
    """`mel_to_audio` at `MelConfig()` on the card and on the CPU, on the mel of
    the low-latency request (decoded eagerly on the card) and the same phase."""
    from matcha_tpu_torch.audio.griffin_lim import mel_to_audio

    x, xl = (a.to(engine.device) for a in engine._tokenize([LONG_TEXT]))
    z, phase = engine._draws(1, 1024, None, [seed])
    out = engine.model.synthesise_fixed(x, xl, 1024, engine.cfg.n_timesteps, z=z)
    mel = out["mel"].transpose(1, 2)
    card = mel_to_audio(engine.cfg.mel_cfg, mel, phase=phase).cpu()
    cpu = mel_to_audio(engine.cfg.mel_cfg, mel.cpu(), phase=phase.cpu())
    err = max_err_within(card, cpu, TOL_WAV, 0.0, "Griffin-Lim card vs CPU")
    res = {"max_abs_err": err, "tol": TOL_WAV, "mel_range": [float(mel.min()), float(mel.max())],
           "wav_max_abs": float(cpu.abs().max()), "frames": int(out["mel_lengths"][0])}
    log(f"Griffin-Lim card vs CPU (f32, MelConfig(), 1024 frames): {res}")
    return res


def serve_threads(engine, seed_base=500):
    """8 threads through `serve()` with distinct seeds: each result equals its
    solo `synthesise([text], seeds=[seed])` within the JAX tests' 1e-3 (other
    batch and text padding sum in other orders, and Griffin-Lim's iterations
    amplify that), and the group splits over at least two budgets."""
    import threading

    seeds = [seed_base + i for i in range(len(SERVE_TEXTS))]
    solo = [engine.synthesise([t], seeds=[s]) for t, s in zip(SERVE_TEXTS, seeds)]
    results = [None] * len(SERVE_TEXTS)
    engine.start_batching(max_wait_ms=50)
    try:
        barrier = threading.Barrier(len(SERVE_TEXTS))

        def run(i):
            barrier.wait()
            results[i] = engine.serve(SERVE_TEXTS[i], seeds[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(SERVE_TEXTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise AssertionError("serve() threads did not all return")
    finally:
        engine.stop_batching()
    gaps, budgets = [], []
    for (wav, info), (want, want_info), text in zip(results, solo, SERVE_TEXTS):
        if info["budget"] != want_info["budget"] or wav.shape != want[0].shape:
            raise AssertionError(f"{text!r}: served at {info['budget']} {wav.shape}, solo "
                                 f"{want_info['budget']} {want[0].shape}")
        gaps.append(max_err_within(torch.from_numpy(wav), torch.from_numpy(want[0]), TOL_WAV,
                                   0.0, f"serve() vs solo {text!r}"))
        budgets.append(info["budget"])
    if len(set(budgets)) < 2:
        raise AssertionError(f"the 8 requests took budgets {budgets}, not two")
    res = {"budgets": budgets, "group_sizes": [i["group_size"] for _, i in results],
           "max_abs_gap": gaps, "tol": TOL_WAV,
           "latency_s": [i["latency_s"] for _, i in results]}
    log(f"serve() from 8 threads: budgets {budgets}, groups {res['group_sizes']}, max gap to "
        f"solo {max(gaps):.3g} (bar {TOL_WAV})")
    return res


def serve_griffin_lim(dev, mcfg, seed):
    """A full-width Griffin-Lim engine in f32 at `MelConfig()`: the main path's
    two requests through its graphs (`drive_engine`), Griffin-Lim card vs
    CPU, 8 threads through `serve()`."""
    import dataclasses

    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.serve import ServeConfig, TTSEngine

    msd = module_weights(MatchaTTS(mcfg), seed, {DURATION_BIAS: 0.3})
    engine = TTSEngine(msd, dataclasses.replace(mcfg, **GL_MEL), ServeConfig(), device=dev)
    want = {"attention_fwd": 2 * engine.cfg.n_timesteps
            * sum(n for n, _ in attention_shapes(mcfg.decoder, 1024)), "mrf_step": 0}
    res = drive_engine(engine, "Griffin-Lim, f32", want, np.float32, TOL_WAV)
    res["card_vs_cpu"] = griffin_lim_card_vs_cpu(engine, 7)
    res["serve_threads"] = serve_threads(engine)
    res["graphs_after_serve"] = len(engine._stages)
    res["pool_bytes_after_serve"] = graph_pool_bytes(engine)
    return res


def profile_request(call):
    """Device time of one request by kernel group, and the card's idle share
    of the request's wall time, from torch.profiler's CUDA kernel events,
    grouped as `cli.trace_table` groups a trace. Busy (`device_ms`) is the union of the kernels' time spans, the time the
    card ran at least one kernel; `kernel_ms_sum` adds up their durations,
    which is more where kernels overlap."""
    from torch.profiler import ProfilerActivity, profile

    from matcha_tpu_torch.cli.trace_table import kernel_group

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured (no CUDA events traced)"}
    groups, counts, names = {}, {}, {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        group = kernel_group(e.name)
        groups[group] = groups.get(group, 0.0) + ms
        counts[group] = counts.get(group, 0) + 1
        names[e.name[:90]] = names.get(e.name[:90], 0.0) + ms
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy = busy_us / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "kernel_ms_sum": sum(groups.values()), "kernel_launches": len(kernels),
            "by_group_ms": groups, "launches_by_group": counts, "top_kernels_ms": dict(top)}


# ---------------------------------------------------------------- phase 4
def card_vs_cpu(dev, mcfg, hcfg, seed, budget=512):
    """One text through model + generator in float32 on the card and on the
    CPU, with the same weights and noise."""
    from matcha_tpu_torch.models.hifigan import Generator
    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.text import simple_text_to_sequence

    msd, gsd = model_weights(mcfg, hcfg, seed)
    ids = simple_text_to_sequence(TEXTS[0])
    x, xl = torch.tensor([ids]), torch.tensor([len(ids)])
    z = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, budget, mcfg.n_feats)).astype(np.float32))
    outs = {}
    for where in (torch.device("cpu"), dev):
        model = MatchaTTS(mcfg).eval().to(where)
        model.load_state_dict(msd)
        gen = Generator(hcfg).eval().to(where)
        gen.load_state_dict(gsd)
        t0 = time.perf_counter()
        out = model.synthesise_fixed(x.to(where), xl.to(where), budget, 10, z=z.to(where))
        out["wav"] = gen(out["mel"])
        outs[where.type] = {k: v.cpu() for k, v in out.items()}
        outs[where.type]["s"] = time.perf_counter() - t0
    cpu, card = outs["cpu"], outs[dev.type]
    if not (torch.equal(cpu["mel_lengths"], card["mel_lengths"])
            and torch.equal(cpu["attn"], card["attn"])):
        raise AssertionError("card and CPU predict other durations")
    res = {"budget": budget, "mel_length": int(cpu["mel_lengths"][0]),
           "mu_y_max_abs_err": max_err_within(card["encoder_outputs"], cpu["encoder_outputs"],
                                              TOL_MU, 0.0, "mu_y card vs CPU"),
           "mel_max_abs_err": max_err_within(card["mel"], cpu["mel"], TOL_MEL, 0.0,
                                             "mel card vs CPU"),
           "wav_max_abs_err": max_err_within(card["wav"], cpu["wav"], TOL_WAV, 0.0,
                                             "waveform card vs CPU"),
           "tolerance": {"mu_y": TOL_MU, "mel": TOL_MEL, "wav": TOL_WAV},
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "cpu_s": cpu["s"], "card_s": card["s"]}
    log(f"card vs CPU (float32, TF32 off): mu_y {res['mu_y_max_abs_err']:.3g} (tol {TOL_MU}), "
        f"mel {res['mel_max_abs_err']:.3g} (tol {TOL_MEL}), "
        f"wav {res['wav_max_abs_err']:.3g} (tol {TOL_WAV})")
    return res


def golden_on_card(dev):
    """The frozen reference outputs of tests/fixtures, on the card in float32."""
    from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
    from tests.golden_utils import synth_state_dict  # numpy only: the fixtures' weights

    res = {}
    for name in ("golden_e2e.npz", "golden_e2e_midpoint.npz"):
        fx = np.load(ROOT / "tests" / "fixtures" / name)
        spec = {k[len("spec/"):]: tuple(fx[k]) for k in fx.files if k.startswith("spec/")}
        model = MatchaTTS(MatchaConfig(solver=str(fx["solver"]))).eval().to(dev)
        weights = synth_state_dict(spec)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
        out = model.synthesise_fixed(
            torch.from_numpy(fx["x"]).to(dev), torch.from_numpy(fx["xl"]).to(dev),
            int(fx["y_max_length"]), int(fx["n_timesteps"]), float(fx["temperature"]),
            float(fx["length_scale"]), z=torch.from_numpy(fx["z"].transpose(0, 2, 1)).to(dev))
        out = {k: v.cpu() for k, v in out.items()}
        if not (np.array_equal(out["mel_lengths"].numpy(), fx["mel_lengths"])
                and np.array_equal(out["attn"].numpy(), fx["attn"])):
            raise AssertionError(f"{name}: mel lengths or alignment differ from the reference")
        t_pad = fx["mel_masked"].shape[-1]
        mask = torch.from_numpy((np.arange(t_pad)[None, :, None]
                                 < fx["mel_lengths"][:, None, None]).astype(np.float32))
        mu = max_err_within(out["encoder_outputs"] * mask,
                            torch.from_numpy(fx["mu_y_masked"].transpose(0, 2, 1)),
                            TOL_MU, 0.0, f"{name} mu_y")
        mel = max_err_within(out["mel"] * mask,
                             torch.from_numpy(fx["mel_masked"].transpose(0, 2, 1)),
                             TOL_MEL, 0.0, f"{name} mel")
        res[name] = {"mu_y_max_abs_err": mu, "mel_max_abs_err": mel}
        log(f"{name} on the card: mu_y {mu:.3g} (tol {TOL_MU}), mel {mel:.3g} (tol {TOL_MEL})")
    return res


# ---------------------------------------------------------------- training path
TRAIN_ITEMS, VAL_ITEMS = 64, 8  # 4 micro-steps (2 updates) and 1 validation batch an epoch
# (precision, epochs, steps_per_dispatch); the last run resumes the second
TRAIN_RUNS = (("fp32", 1, 1), ("bf16", 1, 1), ("bf16", 2, 2))


def training_data(mcfg):
    from matcha_tpu_torch.data.dataset import DataConfig, SyntheticDataset

    return (SyntheticDataset(n_items=TRAIN_ITEMS, n_mels=mcfg.n_feats, seed=0),
            SyntheticDataset(n_items=VAL_ITEMS, n_mels=mcfg.n_feats, seed=1), DataConfig())


def launch_counters():
    from matcha_tpu_torch.ops import mas
    from matcha_tpu_torch.ops.attention import attention, attention_backward
    from matcha_tpu_torch.ops.mrf import mrf_step

    return {"attention_fwd": attention, "mrf_step": mrf_step, "mas": mas.mas_cuda,
            "attention_bwd": attention_backward}


def read_metrics(ckpt_dir, keys=("train/loss", "val/loss")):
    """(train rows, validation rows) of a run's metrics.jsonl, told apart by `keys`."""
    rows = [json.loads(line) for line in
            (Path(ckpt_dir) / "logs" / "metrics.jsonl").read_text().splitlines()]
    return tuple([r for r in rows if key in r] for key in keys)


def per_micro_step(mcfg, remat=None):
    """Launches of one training micro-step: MAS 1 (K3a and K3b fused), K1 once
    per transformer block (twice under remat: the backward's recompute reruns
    the block's forward), K4 2 per block (dq, then dk/dv/dbias)."""
    n_attn = sum(n for n, _ in attention_shapes(mcfg.decoder, 1))
    return {"mas": 1, "attention_fwd": n_attn * (1 if remat is None else 2),
            "attention_bwd": 2 * n_attn}


def per_validation_batch(mcfg):
    """Launches of one validation batch: MAS 1, K1 once per transformer block
    (a forward without lse), no K4."""
    step = per_micro_step(mcfg)
    return {"mas": 1, "attention_fwd": step["attention_fwd"], "attention_bwd": 0}


def check_graph_launches(trainer, mcfg, remat=None):
    """Every graph of `trainer` recorded, at capture and in its warm-up run,
    K times the launches of a micro-step, and every validation graph those of
    a validation batch."""
    step = per_micro_step(mcfg, remat)
    graphs = [(key, g, {n: g.k * c for n, c in step.items()}) for key, g in trainer.graphs.items()]
    graphs += [(key, g, per_validation_batch(mcfg)) for key, g in trainer.eval_graphs.items()]
    for key, g, want in graphs:
        if g.launches != want or g.warmup_launches != want:
            raise AssertionError(f"graph {key}: captured {g.launches}, warm-up "
                                 f"{g.warmup_launches}, expected {want} each")


def graph_summary(trainer):
    def summary(graphs):
        return [{"key": list(key), "k": g.k, "capture_s": g.capture_s,
                 "launches_per_replay": g.launches} for key, g in graphs.items()]

    return {"graphs": summary(trainer.graphs),
            "replays": {str(k): n for k, n in trainer.replays.items()},
            "eval_graphs": summary(trainer.eval_graphs), "eval_replays": trainer.eval_replays,
            "pool_bytes": graph_pool_bytes(trainer)}


def train_main_path(dev, mcfg, seed, root):
    """`Trainer.fit` at full width on 64 synthetic items through the trainer's
    CUDA graphs: one epoch in fp32, one in bf16, then the bf16 run resumed for
    a second epoch at steps_per_dispatch 2. The counts are set to 0 just
    before and read just after. The replays must have run, per micro-step, MAS
    1 (K3a and K3b fused), K1 6 and K4 12 (6 backward calls of 2 launches),
    and per validation batch a validation graph's MAS 1 and K1 6; the wrappers
    may tick only in each graph's capture and warm-up run (and in validation
    images): no training step and no validation batch ran eagerly. The path's
    launches are the replays'."""
    from matcha_tpu_torch.data.dataset import num_batches
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    train_ds, val_ds, dcfg = training_data(mcfg)
    counters = {n: fn for n, fn in launch_counters().items() if n != "mrf_step"}
    # validation images (where TensorBoard and matplotlib import) decode with
    # K1 eagerly: their launches are counted apart
    rendered = {n: 0 for n in counters}
    render = Trainer._log_validation_images

    def counted_render(self, *a, **kw):
        before = {n: fn.launches for n, fn in counters.items()}
        render(self, *a, **kw)
        for n, fn in counters.items():
            rendered[n] += fn.launches - before[n]

    for fn in counters.values():
        fn.launches = 0
    replayed = {n: 0 for n in counters}
    captured = {n: 0 for n in counters}
    eval_replays = 0
    runs = []
    Trainer._log_validation_images = counted_render
    for precision, epochs, k in TRAIN_RUNS:
        ckpt = root / precision
        trainer = Trainer(mcfg, TrainConfig(ckpt_dir=str(ckpt), log_every=1, seed=seed,
                                            precision=precision, steps_per_dispatch=k),
                          dcfg, device=dev)
        t0 = time.perf_counter()
        step = trainer.fit(train_ds, val_ds, max_epochs=epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_graph_launches(trainer, mcfg)
        for n in counters:
            replayed[n] += trainer.launches[n]
            captured[n] += sum(g.launches[n] + g.warmup_launches[n] for g in
                               list(trainer.graphs.values()) + list(trainer.eval_graphs.values()))
        eval_replays += trainer.eval_replays
        train_rows, val_rows = read_metrics(ckpt)
        runs.append({"precision": precision, "epochs": epochs, "steps_per_dispatch": k,
                     "step": step, "updates": trainer.optimizer.count, "wall_s": wall,
                     "checkpoints": [e["step"] for e in trainer.checkpoints.entries],
                     **graph_summary(trainer),
                     "train": [{k: r[k] for k in r if k.startswith("train/")} for r in train_rows],
                     "val": [{k: r[k] for k in r if k.startswith("val/")} for r in val_rows]})
        del trainer
    Trainer._log_validation_images = render
    ticks = {n: fn.launches for n, fn in counters.items()}

    micro = num_batches(TRAIN_ITEMS, dcfg)
    val_batches = num_batches(VAL_ITEMS, dcfg, drop_last=False)
    epochs = len(TRAIN_RUNS)  # each run trains one epoch (the third resumes at epoch 1)
    step_launches, val_launches = per_micro_step(mcfg), per_validation_batch(mcfg)
    want = {n: epochs * (micro * c + val_batches * val_launches[n])
            for n, c in step_launches.items()}
    eager = {n: ticks[n] - captured[n] - rendered[n] for n in ticks}
    # a validation image is one 10-step decode: K1 only
    per_image = 10 * step_launches["attention_fwd"]
    log(f"training path launches by graph replay {replayed} (expected {want}: micro-steps and "
        f"{eval_replays} validation replays); eager {eager} (expected none); at capture and "
        f"warm-up {captured}; validation images {rendered}")
    if replayed != want or any(eager.values()) or eval_replays != epochs * val_batches \
            or rendered["attention_fwd"] % per_image or rendered["mas"] \
            or rendered["attention_bwd"]:
        raise AssertionError(f"training kernel launches: replayed {replayed}, eager {eager}, "
                             f"{eval_replays} validation replays; expected {want}, none eager "
                             f"and {epochs * val_batches} validation replays")
    counts = replayed
    for r in runs:
        log(f"fit {r['precision']} to epoch {r['epochs']} at K={r['steps_per_dispatch']}: step "
            f"{r['step']}, {r['updates']} updates, {r['wall_s']:.1f} s, checkpoints "
            f"{r['checkpoints']}, {len(r['graphs'])} training and {len(r['eval_graphs'])} "
            f"validation graphs captured in "
            f"{sum(g['capture_s'] for g in r['graphs'] + r['eval_graphs']):.2f} s, replays "
            f"{r['replays']} and {r['eval_replays']} validation, pool "
            f"{r['pool_bytes']} bytes, train loss {[round(t['train/loss'], 4) for t in r['train']]}"
            f", val loss {[round(v['val/loss'], 4) for v in r['val']]}")
        losses = [t[k] for t in r["train"] for k in t] + [v[k] for v in r["val"] for k in v]
        if not (r["train"] and r["val"] and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"fit {r['precision']}: missing or non-finite metrics")
    resumed = runs[2]
    if (runs[0]["step"], runs[1]["step"], resumed["step"]) != (micro, micro, 2 * micro) \
            or resumed["updates"] != 2 * micro // 2 or resumed["checkpoints"] != [micro, 2 * micro]:
        raise AssertionError(f"steps, updates or checkpoints of the runs: {runs}")
    return {"runs": runs, "launches": counts, "replayed": replayed, "eager": eager,
            "validation_images": rendered,
            "micro_steps_an_epoch": micro, "val_batches_an_epoch": val_batches}


# ---------------------------------------------------------------- training graphs
BUCKET_ITEMS = 128  # 300-400 frames: an epoch of 8 batches, most of them one shape
# per-step losses and grad_norm (rtol, atol): fp32 the bar of tests/test_train.py:283-291;
# bf16, whose U-Net rounds every activation to 8 bits, one bf16 rounding (2^-9)
TOL_STEP = {"fp32": (2e-5, 1e-6), "bf16": (2 ** -9, 1e-6)}
TOL_FIT = (1e-4, 1e-5)  # K = 1 against K = 4 logs: tests/test_train.py:345-386
# final parameters: within 3 learning rates, fewer than 2 % of elements past 1e-6
# (AdamW turns ulps of the gradient into sign flips where it is ~0)


def bucket_batches(mcfg):
    """The bucket set (batch 16, 128 items of 300-400 frames) and its epoch-0
    batches, largest shape group first."""
    from matcha_tpu_torch.data.dataset import DataConfig, SyntheticDataset, batch_iterator

    train_ds = SyntheticDataset(n_items=BUCKET_ITEMS, n_mels=mcfg.n_feats, seed=2,
                                min_frames=300, max_frames=400)
    val_ds = SyntheticDataset(n_items=VAL_ITEMS, n_mels=mcfg.n_feats, seed=1)
    dcfg = DataConfig()
    by_shape = {}
    for i, b in enumerate(batch_iterator(train_ds, dcfg, epoch=0)):
        b.pop("n_real")
        by_shape.setdefault(b["y"].shape[1], []).append((b, i))
    groups = sorted(by_shape.values(), key=len, reverse=True)
    return train_ds, val_ds, dcfg, groups


def param_gap(a, b, lr):
    gaps = torch.cat([(x.detach() - y.detach()).abs().flatten() for x, y in zip(a, b)])
    res = {"max_abs": float(gaps.max()), "share_over_1e-6": float((gaps > 1e-6).float().mean()),
           "bit_equal": bool(gaps.max() == 0)}
    if res["max_abs"] >= 3 * lr or res["share_over_1e-6"] >= 0.02:
        raise AssertionError(f"parameters apart by {res} (bars: < {3 * lr}, < 2 %)")
    return res


def metric_gap(got, want, what, precision="fp32"):
    """Per-step metrics (steps, 5) against (steps, 5) within TOL_STEP."""
    rtol, atol = TOL_STEP[precision]
    got, want = got.double().cpu(), want.double().cpu()
    over = (got - want).abs() > atol + rtol * want.abs()
    if bool(over.any()):
        raise AssertionError(f"{what}: metrics {got.tolist()} against {want.tolist()}")
    return {"max_abs": float((got - want).abs().max()), "bit_equal": bool(torch.equal(got, want))}


def replay_accounting(trainer, call, what):
    """One dispatch under the profiler: the K1, K4 and MAS kernels the device
    ran equal the launches the graph accounting added, and no wrapper ticked
    (nothing ran eagerly)."""
    counters = {n: fn for n, fn in launch_counters().items() if n != "mrf_step"}
    before, ticks = dict(trainer.launches), {n: fn.launches for n, fn in counters.items()}
    prof = profile_request(call)
    added = {n: trainer.launches[n] - before[n] for n in before}
    by = prof.get("launches_by_group", {})
    seen = {"attention_fwd": by.get("K1 attention_fwd", 0),
            "attention_bwd": by.get("K4 attention_bwd", 0), "mas": by.get("K3a+K3b mas", 0)}
    eager = {n: fn.launches - ticks[n] for n, fn in counters.items()}
    if "kernel_launches" not in prof or seen != added or any(eager.values()):
        raise AssertionError(f"{what}: the profiler saw {seen}, the graph accounting added "
                             f"{added}, eager {eager}")
    prof["launches_per_replay"] = added
    return prof


def graphs_vs_eager(dev, mcfg, seed, root, groups):
    """The same 4 micro-steps (one shape, accumulation 2) eagerly through
    `train_step` and as one K = 2 replay and two 1-step replays, from the same
    state and seeds, fp32 and bf16: per-step metrics within TOL_STEP, final
    parameters within the drift bars; bit equality reported, beside a second
    eager run of the same steps (the card's own run-to-run spread). One more
    K = 2 replay under the profiler checks its accounting."""
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    chunk = groups[0][:4]
    res = {}
    for precision in ("fp32", "bf16"):
        eager, again, graph = (
            Trainer(mcfg, TrainConfig(ckpt_dir=str(root / f"{name}_{precision}"), seed=seed,
                                      precision=precision), device=dev)
            for name in ("eager", "again", "graph"))
        for t in (eager, again, graph):
            t.init_optimizer(8)
        want, want2 = (torch.stack([torch.stack(list(t.train_step(b, 0, i).values()))
                                    for b, i in chunk]) for t in (eager, again))
        got = torch.cat([graph.dispatch(part, 0).clone()
                         for part in (chunk[:2], chunk[2:3], chunk[3:])])
        check_graph_launches(graph, mcfg)
        lr = graph.train_cfg.lr
        r = {"metrics": metric_gap(got, want, f"graphs vs eager {precision}", precision),
             "params": param_gap(graph.params, eager.params, lr),
             "eager_again": {"metrics": metric_gap(want2, want, f"eager vs eager {precision}",
                                                   precision),
                             "params": param_gap(again.params, eager.params, lr)},
             "replays": {str(k): n for k, n in graph.replays.items()}}
        if graph.replays != {2: 1, 1: 2} or len(graph.graphs) != 3:
            raise AssertionError(f"replays {graph.replays} of {len(graph.graphs)} graphs")
        r["profile_k2"] = replay_accounting(graph, lambda: graph.dispatch(chunk[:2], 0),
                                            f"K=2 replay {precision}")
        log(f"training graphs vs eager on the card, {precision}, 4 micro-steps at "
            f"{list(chunk[0][0]['y'].shape)}: metrics {r['metrics']}, parameters {r['params']} "
            f"(bars: rtol, atol {TOL_STEP[precision]}; < {3 * lr}, < 2 %); a second eager "
            f"run vs the first: {r['eager_again']}; K=2 replay: "
            f"{r['profile_k2']['launches_per_replay']} by the profiler = by the accounting")
        res[precision] = r
        del eager, again, graph
    return res


def trace_kernel_names(trace_dir):
    """Names of the device kernels in the one Chrome trace in `trace_dir`."""
    traces = list(Path(trace_dir).glob("trace_*.json"))
    if len(traces) != 1:
        raise AssertionError(f"{len(traces)} traces in {trace_dir}, expected 1")
    events = json.loads(traces[0].read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def k_independence(dev, mcfg, seed, root, train_ds, val_ds, dcfg):
    """A `fit` epoch on the bucket set at K = 1 and at K = 4 (fp32): equal
    per-step logs within TOL_FIT; the K = 4 run replayed K-step and 1-step
    graphs and traced dispatches 2-3 into `profile_dir`, whose trace holds
    the graphs' K1, K4 and MAS kernels."""
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    logs, res = [], {}
    for k in (1, 4):
        trace = root / f"trace_k{k}" if k == 4 else None
        cfg = TrainConfig(ckpt_dir=str(root / f"bucket_k{k}"), log_every=1, seed=seed,
                          steps_per_dispatch=k,
                          profile_dir=None if trace is None else str(trace))
        trainer = Trainer(mcfg, cfg, dcfg, device=dev)
        t0 = time.perf_counter()
        trainer.fit(train_ds, val_ds, max_epochs=1)
        res[f"k{k}"] = {"wall_s": time.perf_counter() - t0, **graph_summary(trainer)}
        logs.append({r["step"]: r for r in read_metrics(cfg.ckpt_dir)[0]})
        del trainer
    rtol, atol = TOL_FIT
    worst = 0.0
    for s, row in logs[0].items():
        for key, v in row.items():
            if key.startswith("train/"):
                w = logs[1][s][key]
                if abs(w - v) > atol + rtol * abs(v):
                    raise AssertionError(f"step {s} {key}: K=1 {v}, K=4 {w}")
                worst = max(worst, abs(w - v))
    replays = res["k4"]["replays"]
    if set(logs[0]) != set(logs[1]) or not (replays.get("4", 0) >= 1 and replays.get("1", 0) >= 1):
        raise AssertionError(f"steps {sorted(logs[0])} / {sorted(logs[1])}, K=4 replays {replays}")
    kernels = trace_kernel_names(root / "trace_k4")
    found = {key: sum(key in n for n in kernels) for key in ("attn_fwd", "attn_bwd", "mas_path")}
    if not all(found.values()):
        raise AssertionError(f"graph kernels in the trace: {found}")
    res.update({"steps": len(logs[0]), "max_abs_gap": worst, "bar": TOL_FIT,
                "trace_kernels": found, "trace_kernel_events": len(kernels)})
    log(f"fit K=1 vs K=4 on {BUCKET_ITEMS} items of 300-400 frames: {len(logs[0])} steps equal "
        f"within rtol {rtol}, atol {atol} (largest gap {worst:.3g}); K=4 replays {replays}; "
        f"trace of dispatches 2-3: {len(kernels)} kernels, graph kernels {found}")
    return res


def remat_replays(dev, mcfg, seed, root, groups):
    """One 1-step replay from the same state with remat None, "full" and
    "dots" (fp32, an update each step): metrics and parameters within the
    bars of no remat; launches per replay as derived, by the profiler."""
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    chunk = groups[0][:1]
    res, base = {}, None
    for remat in (None, "full", "dots"):
        cfg_m = dataclasses.replace(mcfg, decoder=dataclasses.replace(mcfg.decoder, remat=remat))
        trainer = Trainer(cfg_m, TrainConfig(ckpt_dir=str(root / f"remat_{remat}"), seed=seed,
                                             accumulate_steps=1), device=dev)
        trainer.init_optimizer(8)
        out = trainer.dispatch(chunk, 0).clone()
        check_graph_launches(trainer, mcfg, remat)
        if base is None:
            base = (out, [p.detach().clone() for p in trainer.params])
            name = "none"
        else:
            name = remat
            res[name] = {"metrics": metric_gap(out, base[0], f"remat {remat}"),
                         "params": param_gap(trainer.params, base[1], trainer.train_cfg.lr)}
        prof = replay_accounting(trainer, lambda: trainer.dispatch(chunk, 0),
                                 f"remat {remat} replay")
        res.setdefault(name, {})["launches_per_replay"] = prof["launches_per_replay"]
        res[name]["busy_ms"] = prof["device_ms"]
        del trainer
    log(f"remat, one 1-step replay each at {list(chunk[0][0]['y'].shape)} (fp32): {res}")
    return res


def host_calls(call):
    """{CUDA runtime call: count} the host made during `call`, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    names = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
             "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in names:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def synced_walls(call, reps):
    """Host wall ms of `reps` calls, each ended by a device synchronise."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def per_step_profile(call, steps=2):
    """`profile_request` of `steps` consecutive micro-steps (2: an accumulation,
    one that emits no update and one that does), with busy ms, profiled wall
    and kernels per micro-step."""
    prof = profile_request(lambda: [call() for _ in range(steps)])
    prof["steps"] = steps
    if isinstance(prof.get("device_ms"), float):
        prof.update(busy_ms_per_step=prof["device_ms"] / steps,
                    wall_ms_per_step=prof["wall_ms"] / steps,
                    kernels_per_step=prof["kernel_launches"] / steps)
    return prof


def time_micro_steps(dev, mcfg, seed, root, groups, graph_reps=20, eager_reps=10):
    """A training micro-step at batch 16, fp32 and bf16, at the bucket set's
    two largest shapes: the median wall of `graph_reps` 1-step replays and of
    `eager_reps` eager `train_step`s (each ended by a synchronise; steps
    alternate between accumulating and emitting an update, as in training),
    and of K = 4 replays over 4; two replays and two eager steps profiled
    (busy, idle, kernels a micro-step); the host's CUDA calls a dispatch;
    capture seconds and the pool's bytes."""
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    res = {}
    for precision in ("fp32", "bf16"):
        trainer = Trainer(mcfg, TrainConfig(ckpt_dir=str(root / f"timing_{precision}"), seed=seed,
                                            precision=precision), device=dev)
        trainer.init_optimizer(8)
        shapes = []
        for group in groups[:2]:
            one = group[:1]
            b, i = one[0]

            def graph_step():
                trainer.dispatch(one, 0)

            def eager_step():
                trainer.train_step(b, 0, i)

            for call in (graph_step, graph_step, eager_step):  # capture both emit patterns
                call()
            graph_ms = synced_walls(graph_step, graph_reps)
            eager_ms = synced_walls(eager_step, eager_reps)
            prof, prof_eager = per_step_profile(graph_step), per_step_profile(eager_step)
            row = {"tx_ty": [b["x"].shape[1], b["y"].shape[1]],
                   "graph_ms": graph_ms, "graph_ms_median": float(np.median(graph_ms)),
                   "eager_ms": eager_ms, "eager_ms_median": float(np.median(eager_ms)),
                   "profile_graph": prof, "profile_eager": prof_eager,
                   "host_calls_graph": host_calls(graph_step),
                   "host_calls_eager": host_calls(eager_step)}
            busy = prof.get("busy_ms_per_step", "not measured")
            if isinstance(busy, float):
                row["idle_share_unprofiled"] = 1.0 - busy / row["graph_ms_median"]
            if len(group) >= 4:
                four = group[:4]
                trainer.dispatch(four, 0)  # capture (4 steps: 2 accumulations)
                row["k4_ms_per_step"] = [t / 4 for t in synced_walls(
                    lambda: trainer.dispatch(four, 0), 5)]
                row["host_calls_k4"] = host_calls(lambda: trainer.dispatch(four, 0))
            shapes.append(row)
            log(f"micro-step {precision} at {row['tx_ty']}, batch 16: graph replay median "
                f"{row['graph_ms_median']:.2f} ms over {graph_reps} (eager train_step "
                f"{row['eager_ms_median']:.2f} over {eager_reps}); K=4 per step "
                f"{row.get('k4_ms_per_step')}; a replayed step busy "
                f"{busy if isinstance(busy, str) else round(busy, 3)} ms, profiled wall "
                f"{prof.get('wall_ms_per_step')}, idle unprofiled "
                f"{row.get('idle_share_unprofiled')}, {prof.get('kernels_per_step')} kernels; "
                f"an eager step busy {prof_eager.get('busy_ms_per_step')}, "
                f"{prof_eager.get('kernels_per_step')} kernels; host calls a replay "
                f"{row['host_calls_graph']}, K=4 {row.get('host_calls_k4')}, eager "
                f"{sum(row['host_calls_eager'].values())}")
        res[precision] = {"shapes": shapes, **graph_summary(trainer)}
        log(f"micro-step {precision}: graphs {res[precision]['graphs']}, pool "
            f"{res[precision]['pool_bytes']} bytes")
        del trainer
    return res


VALIDATION_ITEMS = 64  # a validation pass of 4 batches of 16, timed eager and replayed


def validation_graphs(dev, mcfg, seed, root, reps=5):
    """`Trainer.validate` on the validation graphs against the same batches
    eagerly on the same weights, in an fp32 and a bf16 trainer (validation
    runs the f32 U-Net in both) after one training replay has put its graph
    in the pool: val/loss and its parts within TOL_STEP fp32 (rtol 2e-5); the
    graphs' launches a validation batch (MAS 1, K1 6) at capture and warm-up,
    and a validation pass under the profiler, whose K1 and MAS kernels equal
    what the graph accounting added (no wrapper ticking); the median walls of
    `reps` passes eager and replayed, each ended by a synchronise."""
    from matcha_tpu_torch.data.dataset import SyntheticDataset, batch_iterator, num_batches
    from matcha_tpu_torch.train.trainer import METRICS, TrainConfig, Trainer

    train_ds, _, dcfg = training_data(mcfg)
    val_ds = SyntheticDataset(n_items=VALIDATION_ITEMS, n_mels=mcfg.n_feats, seed=1)
    batches = num_batches(VALIDATION_ITEMS, dcfg, drop_last=False)
    first = next(iter(batch_iterator(train_ds, dcfg, epoch=0)))
    first.pop("n_real")
    names = METRICS[:4]
    res = {}
    for precision in ("fp32", "bf16"):
        trainer = Trainer(mcfg, TrainConfig(ckpt_dir=str(root / f"val_{precision}"), seed=seed,
                                            precision=precision), dcfg, device=dev)
        trainer.init_optimizer(8)
        trainer.dispatch([(first, 0)], 0)
        eager = trainer.validate(val_ds, 1, eager=True)
        graph = trainer.validate(val_ds, 1)
        gap = metric_gap(torch.tensor([[graph[k] for k in names]], dtype=torch.float64),
                         torch.tensor([[eager[k] for k in names]], dtype=torch.float64),
                         f"validation graphs vs eager {precision}")
        check_graph_launches(trainer, mcfg)
        prof = replay_accounting(trainer, lambda: trainer.validate(val_ds, 1),
                                 f"validation pass {precision}")
        per_pass = {n: batches * c for n, c in per_validation_batch(mcfg).items()}
        if prof["launches_per_replay"] != per_pass or trainer.eval_replays != 2 * batches:
            raise AssertionError(f"validation pass {precision}: launches "
                                 f"{prof['launches_per_replay']}, expected {per_pass}; "
                                 f"{trainer.eval_replays} replays")
        walls = {"eager": synced_walls(lambda: trainer.validate(val_ds, 1, eager=True), reps),
                 "graph": synced_walls(lambda: trainer.validate(val_ds, 1), reps)}
        res[precision] = {
            "val": {"graph": graph, "eager": eager}, "gap": gap, "batches": batches,
            "eval_graphs": [{"key": list(k), "capture_s": g.capture_s}
                            for k, g in trainer.eval_graphs.items()],
            "launches_per_pass": prof["launches_per_replay"], "busy_ms": prof["device_ms"],
            "profiled_wall_ms": prof["wall_ms"],
            "wall_ms_median": {k: float(np.median(v)) for k, v in walls.items()},
            "wall_ms": walls}
        log(f"validation {precision} trainer, graphs vs eager on the same weights "
            f"({VALIDATION_ITEMS} items, {batches} batches, {len(trainer.eval_graphs)} graphs): "
            f"{gap} (bar rtol, atol {TOL_STEP['fp32']}); launches a pass "
            f"{prof['launches_per_replay']} by the profiler = by the accounting; a pass median "
            f"{res[precision]['wall_ms_median']} ms, busy {prof['device_ms']}")
        del trainer
    return res


def train_graph_checks(dev, mcfg, seed, root):
    """The training graphs at full width: against eager steps, K-independence,
    remat, the profile trace, and the micro-step times."""
    train_ds, val_ds, dcfg, groups = bucket_batches(mcfg)
    res = {"bucket_shapes": [[list(g[0][0]["y"].shape), len(g)] for g in groups]}
    log(f"bucket set batches by shape: {res['bucket_shapes']}")
    res["graphs_vs_eager"] = graphs_vs_eager(dev, mcfg, seed, root, groups)
    res["k_independence"] = k_independence(dev, mcfg, seed, root, train_ds, val_ds, dcfg)
    res["remat"] = remat_replays(dev, mcfg, seed, root, groups)
    res["validation"] = validation_graphs(dev, mcfg, seed, root)
    res["micro_steps"] = time_micro_steps(dev, mcfg, seed, root, groups)
    return res


def training_batches(mcfg):
    """(kind, precision, batch) of every batch the training path ran, in order."""
    from matcha_tpu_torch.data.dataset import batch_iterator

    train_ds, val_ds, dcfg = training_data(mcfg)
    out = []
    for (precision, _, _), epoch in zip(TRAIN_RUNS, (0, 0, 1)):
        out += [("train", precision, b) for b in batch_iterator(train_ds, dcfg, epoch=epoch)]
        out += [("val", "fp32", b) for b in batch_iterator(val_ds, dcfg, epoch=0, shuffle=False,
                                                           drop_last=False)]
    return out


def mask_rows(y_lengths, frames, dev):
    return torch.arange(frames, device=dev)[None, :] < y_lengths.to(dev)[:, None]


def mas_keys(batches):
    """{(Tx, Ty, t_x, t_y): calls} of the MAS calls of `training_batches`, one a
    batch (lengths as tuples)."""
    keys = {}
    for _, _, b in batches:
        key = (b["x"].shape[1], b["y"].shape[1], tuple(b["x_lengths"].tolist()),
               tuple(b["y_lengths"].tolist()))
        keys[key] = keys.get(key, 0) + 1
    return keys


def mas_batch_inputs(key, dev, gen):
    """value (log-prior sized scores), mask and int32 lengths of one MAS call
    of the training path, from its `mas_keys` key."""
    tx, ty, t_x, t_y = key
    t_x = torch.tensor(t_x, device=dev, dtype=torch.int32)
    t_y = torch.tensor(t_y, device=dev, dtype=torch.int32)
    value = -1000.0 + 30.0 * torch.randn((len(t_x), tx, ty), generator=gen, device=dev)
    mask = ((torch.arange(tx, device=dev)[None, :, None] < t_x[:, None, None])
            & mask_rows(t_y, ty, dev)[:, None, :]).float()
    return value, mask, t_x, t_y


def mas_row(value, mask, t_x, t_y, step_ns, reps):
    """The fused MAS kernel at one shape: held against its plain version, timed
    beside it; the work: the function's own bytes (value and mask inside the
    lengths read, the whole output written, the lengths read; not the
    decisions, which are the design's) and its chain, max(t_y) dependent
    steps of `step_ns` each."""
    from matcha_tpu_torch.ops import mas

    b, tx, ty = value.shape
    check_mas(value, mask, t_x, t_y, f"{value.dtype} {[b, tx, ty]}")
    lx, ly = t_x.clamp(0, tx).long(), t_y.clamp(0, ty).long()
    read = int((lx * ly).sum()) * (value.element_size() + mask.element_size())
    return {"max_abs_err": 0.0, "flops": 0,
            "bytes": read + b * tx * ty * value.element_size() + 2 * b * 4,
            "chain_frames": int(ly.max()), "chain_ms": int(ly.max()) * step_ns * 1e-6,
            "ms": cuda_ms(lambda: mas.mas_cuda(value, mask, t_x, t_y), reps),
            "plain_ms": events_ms(lambda: mas.maximum_path_plain(value, mask, t_x, t_y), 3),
            "library_ms": None}


def time_training_kernels(dev, mcfg, seed, batches, step_ns, reps=20, path="train"):
    """At every shape the training path gave K1, MAS and K4: the kernel against
    its plain version, then kernel, plain and library times and the bound.
    Inputs are random at the path's shapes and lengths (a MAS's time does not
    depend on its scores)."""

    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    dcfg = mcfg.decoder
    h, d = dcfg.num_heads, dcfg.attention_head_dim
    scale = d ** -0.5
    # (kernel, key) -> count of calls
    groups = {("mas", key): count for key, count in mas_keys(batches).items()}
    for kind, precision, b in batches:
        ty = b["y"].shape[1]
        y_lengths = tuple(b["y_lengths"].tolist())
        dtype = "bfloat16" if (kind == "train" and precision == "bf16") else "float32"
        for n, t in attention_shapes(dcfg, ty):
            # a training forward writes lse for its backward; validation's does not
            key = (dtype, t, ty, y_lengths, kind == "train")
            groups[("fwd", key)] = groups.get(("fwd", key), 0) + n
            if kind == "train":
                groups[("bwd", key)] = groups.get(("bwd", key), 0) + n
    rows = {"attention_fwd": [], "mas": [], "attention_bwd": []}
    for (kind, key), count in groups.items():
        if kind == "mas":
            value, mask, t_x, t_y = mas_batch_inputs(key, dev, gen)
            rows["mas"].append(dict(
                {"path": path, "dtype": "float32", "peak_flops": PEAK_F32_FLOPS,
                 "shape": list(value.shape), "count": count, "launches": count},
                **mas_row(value, mask, t_x, t_y, step_ns, reps)))
            continue
        dtype_name, t, frames, y_lengths, with_lse = key
        dtype = getattr(torch, dtype_name)
        bsz = len(y_lengths)
        q, k, v, bias = attention_inputs(bsz, h, t, d, dtype, dev, gen, list(y_lengths), frames)
        common = {"path": path, "dtype": dtype_name, "peak_flops": PEAK_FLOPS[dtype],
                  "shape": [bsz, h, t, d], "count": count}
        if kind == "fwd":
            rows["attention_fwd"].append(dict(
                common, **attention_fwd_row(q, k, v, bias, scale, with_lse, reps),
                launches=count, lse=with_lse))
        else:
            rows["attention_bwd"].append(dict(
                common, **attention_bwd_row(q, k, v, bias, scale, gen, reps), launches=2 * count))
    log_rows(rows)
    return rows


def attention_fwd_row(q, k, v, bias, scale, with_lse, reps):
    """K1 at one shape: held against its plain version (o and lse), then timed
    beside its plain version and SDPA, with lse when the path writes it; the
    work. The bytes are the function's own: q, k, v and the bias in, o out.
    The lse a training forward writes is the backward's design, not the
    attention's, and is left out of the bound."""
    from matcha_tpu_torch.ops.attention import attention_cuda, attention_plain

    b, h, t, d = q.shape
    elt = q.element_size()
    name = str(q.dtype).split(".")[1]
    atol, rtol = TOL[name]
    got = attention_cuda(q, k, v, bias, scale, with_lse=True)
    want = attention_plain(q, k, v, bias, scale, with_lse=True)
    err = max(max_err_within(g, w, atol, rtol, f"K1 {name} {[b, h, t, d]} {what}")
              for g, w, what in zip(got, want, ("o", "lse")))
    mask = None if bias is None else bias[:, None, None, :]
    return {"max_abs_err": err, "flops": 4 * b * h * t * t * d,
            "bytes": (4 * b * h * t * d + b * t) * elt,
            "ms": cuda_ms(lambda: attention_cuda(q, k, v, bias, scale, with_lse), reps),
            "plain_ms": cuda_ms(lambda: attention_plain(q, k, v, bias, scale, with_lse), reps),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale), reps)}


def attention_bwd_row(q, k, v, bias, scale, gen, reps):
    """K4 at one shape, without dbias (the decoder's mask takes no gradient):
    held against its plain version on the plain forward's (o, lse), then
    timed beside its plain version and SDPA's backward; the work the gradient
    needs: 5 products, q, k, v, do and the bias in, dq, dk, dv out. The o and
    lse the kernel reads (and the D it writes and reads back) are its design's
    traffic, not the gradient's, and are left out of the bound."""
    from matcha_tpu_torch.ops.attention import (attention_bwd_cuda, attention_bwd_plain,
                                                attention_plain)

    b, h, t, d = q.shape
    elt = q.element_size()
    name = str(q.dtype).split(".")[1]
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    o, lse = attention_plain(q, k, v, bias, scale, with_lse=True)
    rel, diff = grad_err(attention_bwd_cuda(q, k, v, bias, do, o, lse, scale, False),
                         attention_bwd_plain(q, k, v, bias, do, o, lse, scale)[:3] + (None,),
                         f"K4 {name} {[b, h, t, d]}", TOL_BWD[name])
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    out = F.scaled_dot_product_attention(
        *leaves, attn_mask=None if bias is None else bias[:, None, None, :], scale=scale)
    return {"max_abs_err": diff, "max_err_of_max_grad": rel, "flops": 10 * b * h * t * t * d,
            "bytes": (7 * b * h * t * d + b * t) * elt,
            "ms": cuda_ms(lambda: attention_bwd_cuda(q, k, v, bias, do, o, lse, scale, False),
                          reps),
            "plain_ms": cuda_ms(lambda: attention_bwd_plain(q, k, v, bias, do, o, lse, scale),
                                reps),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                                  reps)}


# (B, T) of the per-call table: the serving path's batch-1 and batch-4 shapes
# and a training micro-step's longest
PER_CALL_SHAPES = ((1, 1024), (1, 512), (4, 512), (4, 256), (16, 448))


def time_attention_per_call(dev, seed, reps=20, shapes=PER_CALL_SHAPES):
    """K1 (without lse, as serving calls it) and K4 a call, in both dtypes, at
    `shapes` (B, T) with H = 4, D = 64 and ragged lengths: beside SDPA and the
    bound. Not on the main path: these launches count toward no path."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, t in shapes:
            q, k, v, bias = attention_inputs(b, 4, t, 64, dtype, dev, gen,
                                             [t - 37 * (i % 2) for i in range(b)])
            for name, row in (
                    ("attention_fwd", attention_fwd_row(q, k, v, bias, 0.125, False, reps)),
                    ("attention_bwd", attention_bwd_row(q, k, v, bias, 0.125, gen, reps))):
                row.update(kernel=name, dtype=str(dtype).split(".")[1], shape=[b, 4, t, 64],
                           bound_ms=max(row["flops"] / PEAK_FLOPS[dtype],
                                        row["bytes"] / PEAK_BYTES) * 1e3)
                out.append(row)
                log(f"{name} a call {row['dtype']} {row['shape']}: {row['ms']:.4f} ms, SDPA "
                    f"{row['library_ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
                    f"{row['bound_ms']:.5f}")
    return out


def mrf_step_unfused(x, w1, b1, w2, b2, dilation):
    """The dilation step as separate PyTorch calls in x's dtype (lrelu, cuDNN
    conv1d, lrelu, conv1d, add): K2's yardstick, since no one call computes it."""
    k = w1.shape[-1]
    h = F.conv1d(F.leaky_relu(x, 0.1), w1, b1, padding=dilation * (k - 1) // 2,
                 dilation=dilation)
    return x + F.conv1d(F.leaky_relu(h, 0.1), w2, b2, padding=(k - 1) // 2)


def mrf_work(b, c, t, k, elt):
    """(flops, bytes) of one dilation step: two convs of C*C*k taps a frame; x
    in, out out, both weights and biases in."""
    return 4 * b * c * c * k * t, (2 * b * c * t + 2 * c * c * k + 2 * c) * elt


# (request, batch, budget) of the per-stage table: a low-latency request at
# 1024 mel frames and a batch of 4 at 512
MRF_STAGE_REQUESTS = (("lowlatency", 1, 1024), ("synthesise", 4, 512))


def time_mrf_per_stage(dev, hcfg, seed, reps=5):
    """K2 at every (C, T, k, d) of the two serving requests, in bf16 and f32:
    held against its plain version, then timed beside the plain version and
    the unfused PyTorch sequence in the same dtype (`unfused_ms`), with the
    bound. Sums by stage (C) per request and dtype. Not on the main path:
    these launches count toward no path."""
    from matcha_tpu_torch.ops.mrf import mrf_step_cuda, mrf_step_plain, pack_weights

    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    rows, stages = [], {}
    for req, b, budget in MRF_STAGE_REQUESTS:
        for c, t, k, dil in mrf_shapes(hcfg, budget):
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).split(".")[1]
                atol, rtol = TOL_MRF_F32 if dtype == torch.float32 else TOL[name]
                args = mrf_inputs(b, c, t, k, dtype, dev, gen)
                packed = pack_weights(args[1], args[3])
                err = max_err_within(mrf_step_cuda(*args, dil, packed),
                                     mrf_step_plain(*args, dil), atol, rtol,
                                     f"K2 {name} {req} {[b, c, t]} k={k} d={dil}")
                flops, nbytes = mrf_work(b, c, t, k, args[0].element_size())
                row = {"request": req, "dtype": name, "shape": [b, c, t], "k": k, "d": dil,
                       "max_abs_err": err,
                       "ms": cuda_ms(lambda: mrf_step_cuda(*args, dil, packed), reps),
                       "plain_ms": cuda_ms(lambda: mrf_step_plain(*args, dil), reps),
                       "unfused_ms": cuda_ms(lambda: mrf_step_unfused(*args, dil), reps),
                       "bound_ms": max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) * 1e3,
                       "bound_by": ("operations" if flops / PEAK_FLOPS[dtype]
                                    >= nbytes / PEAK_BYTES else "bytes")}
                del args, packed
                rows.append(row)
                s = stages.setdefault(f"{req} {name} C={c}", {
                    "request": req, "dtype": name, "C": c, "T": t, "batch": b, "launches": 0,
                    "ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0, "bound_ms": 0.0})
                s["launches"] += 1
                for key in ("ms", "plain_ms", "unfused_ms", "bound_ms"):
                    s[key] += row[key]
                log(f"K2 stage {req} {name} {[b, c, t]} k={k} d={dil}: {row['ms']:.4f} ms, "
                    f"unfused {row['unfused_ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
                    f"{row['bound_ms']:.5f} ({row['bound_by']}), max abs err {err:.3g}")
    for s in stages.values():
        log(f"K2 by stage {s['request']} {s['dtype']} C={s['C']} (B={s['batch']}, T={s['T']}, "
            f"{s['launches']} launches): {s['ms']:.4f} ms, unfused {s['unfused_ms']:.4f}, "
            f"plain {s['plain_ms']:.4f}, bound {s['bound_ms']:.4f}")
    return {"rows": rows, "stages": list(stages.values())}


def train_card_vs_cpu(dev, mcfg, seed):
    """One full-width `compute_losses` plus backward at b = 2 (Tx = 10, Ty = 24)
    in float32 on the card and on the CPU: same weights, injected (t, z),
    dropout off. Paths must be equal, losses and gradients within their bars."""
    from matcha_tpu_torch.models.matcha import MatchaTTS

    sd = module_weights(MatchaTTS(mcfg), seed, {DURATION_BIAS: 0.3})
    rng = np.random.default_rng(seed + 11)
    b, tx, ty, f = 2, 10, 24, mcfg.n_feats
    inputs = {"x": torch.from_numpy(rng.integers(3, 140, (b, tx))),
              "x_lengths": torch.tensor([10, 7]),
              "y": torch.from_numpy(rng.standard_normal((b, ty, f)).astype(np.float32)),
              "y_lengths": torch.tensor([24, 18]),
              "t": torch.tensor([0.35, 0.8]),
              "z": torch.from_numpy(rng.standard_normal((b, ty, f)).astype(np.float32))}
    outs = {}
    for where in (torch.device("cpu"), dev):
        model = MatchaTTS(mcfg).eval().to(where)
        model.load_state_dict(sd)
        a = {k: v.to(where) for k, v in inputs.items()}
        out = model.compute_losses(a["x"], a["x_lengths"], a["y"], a["y_lengths"],
                                   t=a["t"], z=a["z"])
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(out["dur_loss"] + out["prior_loss"] + out["diff_loss"],
                                    list(model.parameters()), allow_unused=True)
        outs[where.type] = {"losses": {k: float(out[k].detach()) for k in TOL_LOSS},
                            "attn": out["attn"].cpu(),
                            "grads": {n: None if g is None else g.cpu()
                                      for n, g in zip(names, grads)}}
    cpu, card = outs["cpu"], outs[dev.type]
    if not torch.equal(cpu["attn"], card["attn"]):
        raise AssertionError("card and CPU MAS paths differ (a near-tie of the log-prior "
                             "flipped: the kernels themselves are checked on equal scores)")
    res = {"losses": {}, "tolerance": {"losses_rtol": TOL_LOSS, "grad": TOL_GRAD}}
    for k, tol in TOL_LOSS.items():
        rel = abs(card["losses"][k] - cpu["losses"][k]) / abs(cpu["losses"][k])
        if rel > tol:
            raise AssertionError(f"{k}: card {card['losses'][k]} CPU {cpu['losses'][k]} "
                                 f"(relative {rel:.3g} over {tol})")
        res["losses"][k] = {"card": card["losses"][k], "cpu": cpu["losses"][k], "rel_err": rel}
    worst, worst_name = 0.0, None
    for n, g in cpu["grads"].items():
        if g is None:
            continue
        err = float((card["grads"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        if err > worst:
            worst, worst_name = err, n
    if worst > TOL_GRAD:
        raise AssertionError(f"gradient {worst_name}: error {worst:.3g} of max |grad| "
                             f"over {TOL_GRAD}")
    res["grad_max_err_of_max"] = worst
    res["grad_worst_tensor"] = worst_name
    log(f"training card vs CPU (float32, TF32 off): losses rel err "
        f"{ {k: round(v['rel_err'], 9) for k, v in res['losses'].items()} } "
        f"(bars {TOL_LOSS}), gradients {worst:.3g} of max |grad| (bar {TOL_GRAD}, "
        f"worst {worst_name})")
    return res


# ---------------------------------------------------------------- vocoder training path
VOC_ITEMS, VOC_VAL_ITEMS = 64, 8  # batch 16: 4 GAN steps and 1 validation batch an epoch
VOC_BUDGET = 512  # the trained generator serves one low-latency request of this budget
VOC_KEYS = ("train/g_loss", "val/mel_l1")  # the metric rows of a vocoder run


def vocoder_trainer(dev, ckpt_dir, k, seed, hcfg, disc_kw, dcfg):
    """A VocoderTrainer at `hcfg`, the discriminators of `disc_kw` (v1's when
    empty) and `dcfg`, initialised from `seed`, logging every step."""
    from matcha_tpu_torch.train.vocoder import Discriminators, VocoderTrainConfig, VocoderTrainer

    return VocoderTrainer(hcfg, VocoderTrainConfig(ckpt_dir=str(ckpt_dir), log_every=1,
                                                   seed=seed, steps_per_dispatch=k), dcfg,
                          disc=Discriminators(**disc_kw) if disc_kw else None, device=dev)


def vocoder_log_rows(rows):
    """(steps, 5) metrics of logged train rows, in `METRICS` order."""
    from matcha_tpu_torch.train.vocoder import METRICS

    return torch.tensor([[r[f"train/{m}"] for m in METRICS] for r in rows], dtype=torch.float64)


def vocoder_fit(trainer, train_ds, val_ds, epochs):
    """`fit` to `epochs` with the K2 counter watched (the training form runs no
    K2) and the GAN steps counted by how they ran: every step a graph replay,
    none eager (a capture's warm-up run is not a step)."""
    from matcha_tpu_torch.ops.mrf import mrf_step

    latest = trainer.checkpoints.latest()
    start = latest["step"] if latest else 0
    before_k2, t0 = mrf_step.launches, time.perf_counter()
    step = trainer.fit(train_ds, val_ds, max_epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replayed = sum(k * n for k, n in trainer.replays.items())
    launches = [g.launches for g in list(trainer.graphs.values())
                + list(trainer.eval_graphs.values())]
    # one validation batch an epoch, each a replay of the one validation graph
    epochs_run = (step - start) // (len(train_ds) // trainer.data_cfg.batch_size)
    if trainer.eager_steps or replayed != step - start or mrf_step.launches != before_k2 \
            or any(any(c.values()) for c in launches) or trainer.eval_replays != epochs_run \
            or len(trainer.eval_graphs) != 1:
        raise AssertionError(f"fit from step {start} to {step}: {replayed} steps replayed, "
                             f"{trainer.eager_steps} eager, {trainer.eval_replays} validation "
                             f"replays of {len(trainer.eval_graphs)} graphs for {epochs_run} "
                             f"epochs, K2 {mrf_step.launches - before_k2}, kernel launches in "
                             f"the graphs {launches}")
    train_rows, val_rows = read_metrics(trainer.train_cfg.ckpt_dir, VOC_KEYS)
    values = [r[k] for r in train_rows + val_rows for k in r if k.startswith(("train/", "val/"))]
    if not train_rows or not val_rows or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"fit to step {step}: missing or non-finite metrics")
    return {"step": step, "wall_s": wall, "eager_steps": trainer.eager_steps,
            "epochs_run": epochs_run, **graph_summary(trainer),
            "checkpoints": [e["step"] for e in trainer.checkpoints.entries],
            "train": train_rows, "val": val_rows}


def vocoder_fit_runs(dev, seed, root, hcfg, disc_kw, dcfg, train_ds, val_ds):
    """Two epochs of `fit` at K = 4 with validation, resumed for a third at
    K = 1; apart, one epoch at K = 1 from the same start, whose logs must
    follow the K = 4 run's first epoch (TOL_FIT). Returns the runs and the
    K = 1 run's parameters after its epoch."""
    a = vocoder_trainer(dev, root / "voc", 4, seed, hcfg, disc_kw, dcfg)
    runs = {"k4": vocoder_fit(a, train_ds, val_ds, 2)}
    del a
    b = vocoder_trainer(dev, root / "voc", 1, seed, hcfg, disc_kw, dcfg)
    runs["resumed_k1"] = vocoder_fit(b, train_ds, val_ds, 3)
    del b
    c = vocoder_trainer(dev, root / "voc_k1", 1, seed, hcfg, disc_kw, dcfg)
    runs["k1"] = vocoder_fit(c, train_ds, val_ds, 1)
    params = [p.detach().clone() for p in c.opt_g.params + c.opt_d.params]
    del c
    steps = len(runs["k1"]["train"])
    if (runs["k4"]["step"], runs["resumed_k1"]["step"], runs["k4"]["replays"],
            runs["resumed_k1"]["replays"]) != (2 * steps, 3 * steps, {"4": steps // 2},
                                              {"1": steps}) or steps != 4:
        raise AssertionError(f"steps or replays of the runs: {runs}")
    k4 = vocoder_log_rows(runs["k4"]["train"][:steps])
    k1 = vocoder_log_rows(runs["k1"]["train"])
    rtol, atol = TOL_FIT
    gap = (k4 - k1).abs()
    if bool((gap > atol + rtol * k1.abs()).any()):
        raise AssertionError(f"fit K=4 vs K=1 logs: {k4.tolist()} against {k1.tolist()}")
    runs["k4_vs_k1"] = {"steps": steps, "max_abs_gap": float(gap.max()), "bar": TOL_FIT}
    for name, r in runs.items():
        if "train" in r:
            log(f"vocoder fit {name}: step {r['step']} in {r['wall_s']:.1f} s, replays "
                f"{r['replays']}, eager steps {r['eager_steps']}, validation replays "
                f"{r['eval_replays']} in {r['epochs_run']} epochs, graphs "
                f"{[(g['key'], round(g['capture_s'], 2)) for g in r['graphs']]}, pool "
                f"{r['pool_bytes']} bytes, checkpoints {r['checkpoints']}, g_loss "
                f"{[round(t['train/g_loss'], 3) for t in r['train']]}, val mel_l1 "
                f"{[round(v['val/mel_l1'], 4) for v in r['val']]}")
    log(f"vocoder fit K=4 vs K=1, epoch 0: {steps} steps within rtol {rtol}, atol {atol} "
        f"(largest gap {runs['k4_vs_k1']['max_abs_gap']:.3g})")
    return runs, params


def vocoder_graphs_vs_eager(dev, seed, root, hcfg, disc_kw, dcfg, train_ds, runs, params):
    """The first epoch's 4 GAN steps eagerly on the card, twice, from the fit's
    start: against the K = 1 and K = 4 replays' logged metrics (TOL_STEP fp32)
    and the K = 1 run's parameters after them (`param_gap`); the second eager
    run against the first is the card's own spread."""
    from matcha_tpu_torch.data.audio_dataset import wav_batch_iterator

    batches = list(wav_batch_iterator(train_ds, dcfg, epoch=0))
    eager = []
    for name in ("eager", "again"):
        t = vocoder_trainer(dev, root / f"voc_{name}", 1, seed, hcfg, disc_kw, dcfg)
        t.init_optimizers(len(batches))
        out = torch.cat([t.dispatch([y], eager=True).clone() for y in batches])
        eager.append((out, [p.detach().clone() for p in t.opt_g.params + t.opt_d.params],
                      t.train_cfg.lr))
        del t
    (want, want_p, lr), (again, again_p, _) = eager
    res = {"k1_replays": metric_gap(vocoder_log_rows(runs["k1"]["train"]), want,
                                    "vocoder K=1 replays vs eager"),
           "k4_replay": metric_gap(vocoder_log_rows(runs["k4"]["train"][:len(batches)]), want,
                                   "vocoder K=4 replay vs eager"),
           "params": param_gap(params, want_p, lr),
           "eager_again": {"metrics": metric_gap(again, want, "vocoder eager vs eager"),
                           "params": param_gap(again_p, want_p, lr)}}
    log(f"vocoder GAN steps, graphs vs eager on the card ({len(batches)} steps from the same "
        f"start): K=1 replays {res['k1_replays']}, K=4 replay {res['k4_replay']}, parameters "
        f"{res['params']} (bars: rtol, atol {TOL_STEP['fp32']}; < {3 * lr}, < 2 %); a second "
        f"eager run vs the first: {res['eager_again']}")
    return res


def vocoder_validation(dev, seed, root, hcfg, disc_kw, dcfg, val_ds, reps=5):
    """`VocoderTrainer.validate` on its graph against the same batches eagerly
    on the same weights (TOL_STEP fp32, the bar of its GAN-step replays
    against eager); the median walls of `reps` passes of each, each ended by
    a synchronise."""
    t = vocoder_trainer(dev, root / "voc_val", 1, seed, hcfg, disc_kw, dcfg)
    t.init_optimizers(4)
    eager = t.validate(val_ds, eager=True)
    graph = t.validate(val_ds)
    gap = metric_gap(torch.tensor([[graph]], dtype=torch.float64),
                     torch.tensor([[eager]], dtype=torch.float64),
                     "vocoder validation graph vs eager")
    walls = {"eager": synced_walls(lambda: t.validate(val_ds, eager=True), reps),
             "graph": synced_walls(lambda: t.validate(val_ds), reps)}
    res = {"mel_l1": {"graph": graph, "eager": eager, **gap},
           "eval_graphs": len(t.eval_graphs), "eval_replays": t.eval_replays,
           "wall_ms_median": {k: float(np.median(v)) for k, v in walls.items()},
           "wall_ms": walls}
    if res["eval_graphs"] != 1 or res["eval_replays"] != 1 + reps:
        raise AssertionError(f"vocoder validation: {res}")
    log(f"vocoder validation, graph vs eager ({len(val_ds)} items): mel L1 {graph} vs {eager} "
        f"({gap}; bar rtol, atol {TOL_STEP['fp32']}); a pass median {res['wall_ms_median']} ms")
    del t
    return res


def vocoder_step_times(dev, seed, root, hcfg, disc_kw, dcfg, train_ds, reps=10):
    """A GAN step at batch 16: median walls of `reps` 1-step replays and of
    `reps // 2` eager steps (each ended by a synchronise), K = 4 replays a
    step; two replays profiled (busy, idle, kernels); the host's CUDA calls a
    replay; capture seconds and the pool's bytes."""
    from matcha_tpu_torch.data.audio_dataset import wav_batch_iterator

    y = next(wav_batch_iterator(train_ds, dcfg, epoch=0))
    trainer = vocoder_trainer(dev, root / "voc_timing", 1, seed, hcfg, disc_kw, dcfg)
    trainer.init_optimizers(4)

    def replay():
        trainer.dispatch([y])

    def eager():
        trainer.dispatch([y], eager=True)

    def replay_k4():
        trainer.dispatch([y] * 4)

    for call in (replay, replay_k4, eager):  # capture both graphs
        call()
    graph_ms, eager_ms = synced_walls(replay, reps), synced_walls(eager, reps // 2)
    k4_ms = [t / 4 for t in synced_walls(replay_k4, 3)]
    prof, prof_eager = per_step_profile(replay), per_step_profile(eager)
    res = {"graph_ms": graph_ms, "graph_ms_median": float(np.median(graph_ms)),
           "eager_ms": eager_ms, "eager_ms_median": float(np.median(eager_ms)),
           "k4_ms_per_step": k4_ms, "profile": prof, "profile_eager": prof_eager,
           "host_calls": host_calls(replay), "host_calls_eager": host_calls(eager),
           "host_calls_k4": host_calls(replay_k4), **graph_summary(trainer)}
    busy = prof.get("busy_ms_per_step", "not measured")
    if isinstance(busy, float):
        res["idle_share_unprofiled"] = 1.0 - busy / res["graph_ms_median"]
    log(f"vocoder GAN step at batch 16 x {dcfg.segment_size}: graph replay median "
        f"{res['graph_ms_median']:.2f} ms over {reps} (eager {res['eager_ms_median']:.2f} over "
        f"{reps // 2}); K=4 per step {[round(t, 2) for t in k4_ms]}; a replayed step busy "
        f"{busy if isinstance(busy, str) else round(busy, 3)} ms (kernel durations summed "
        f"{prof.get('kernel_ms_sum')} over 2), profiled wall {prof.get('wall_ms_per_step')}, "
        f"idle unprofiled {res.get('idle_share_unprofiled')}, {prof.get('kernels_per_step')} "
        f"kernels, by group {prof.get('by_group_ms')}; an eager step busy "
        f"{prof_eager.get('busy_ms_per_step')} (summed {prof_eager.get('kernel_ms_sum')} over "
        f"2), profiled wall {prof_eager.get('wall_ms_per_step')}, "
        f"{prof_eager.get('kernels_per_step')} kernels; host calls a replay "
        f"{res['host_calls']}, K=4 {res['host_calls_k4']}, eager "
        f"{sum(res['host_calls_eager'].values())}; graphs {res['graphs']}, pool "
        f"{res['pool_bytes']} bytes")
    del trainer
    return res


def vocoder_card_vs_cpu(dev, seed, root, hcfg, disc_kw, segment):
    """One GAN step at batch 2 from the same start on the card (a graph
    replay) and on the CPU: metrics within TOL_STEP fp32, parameters within
    the drift bars (`param_gap`)."""
    from matcha_tpu_torch.data.audio_dataset import AudioDataConfig, SyntheticWavDataset

    dcfg = AudioDataConfig(batch_size=2, segment_size=segment)
    ds = SyntheticWavDataset(n_items=2, segment_size=segment, seed=seed)
    y = np.stack([ds.get_segment(i, np.random.default_rng(0)) for i in range(2)])
    outs = {}
    for where in (torch.device("cpu"), dev):
        t = vocoder_trainer(where, root / f"voc_{where.type}", 1, seed, hcfg, disc_kw, dcfg)
        t.init_optimizers(1)
        t0 = time.perf_counter()
        out = t.dispatch([y]).cpu()
        outs[where.type] = (out, [p.detach().cpu() for p in t.opt_g.params + t.opt_d.params],
                            time.perf_counter() - t0, t.train_cfg.lr)
        del t
    (cpu, cpu_p, cpu_s, lr), (card, card_p, card_s, _) = outs["cpu"], outs[dev.type]
    res = {"metrics": metric_gap(card, cpu, "vocoder GAN step card vs CPU"),
           "params": param_gap(card_p, cpu_p, lr), "cpu_s": cpu_s, "card_s": card_s,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32}}
    log(f"vocoder GAN step card vs CPU (batch 2, float32, TF32 off): metrics {res['metrics']}, "
        f"parameters {res['params']} (bars: rtol, atol {TOL_STEP['fp32']}; < {3 * lr}, < 2 %)")
    return res


def vocoder_serve_loop(dev, mcfg, hcfg, seed, ckpt_dir):
    """The trained generator served: `load_generator_for_inference` -> the
    serving `Generator` inside a `TTSEngine(vocoder="hifigan")` in f32 and in
    bf16, one low-latency request each through its CUDA graph (captured
    first, then the counts set to 0 and read after both requests: K2 36 and
    K1 60 a replay by the graph accounting, none eager; each graph recorded
    K2 36 by the wrappers at capture; one replay of each profiled, the
    profiler's K2 and K1 equal to the accounting). Each served waveform is
    held against the training-form generator (plain convs, f32) on the
    engine's own mel: K2's f32 bar, and its bf16 bar for the bf16 engine."""
    from matcha_tpu_torch.models.hifigan import Generator
    from matcha_tpu_torch.serve import ServeConfig, TTSEngine
    from matcha_tpu_torch.train.checkpoints import CheckpointStore
    from matcha_tpu_torch.train.vocoder import load_generator_for_inference

    folded = load_generator_for_inference(ckpt_dir)
    train_form = Generator(hcfg, weight_norm=True)
    train_form.load_state_dict(CheckpointStore(ckpt_dir).restore_params("best", "cpu")["gen"])
    train_form.to(dev)
    msd, _ = model_weights(mcfg, hcfg, seed)
    text, per_call = TEXTS[0], len(mrf_shapes(hcfg, 1))
    engines = {}
    for dtype, bf16 in (("float32", False), ("bfloat16", True)):
        scfg = ServeConfig(bf16=bf16, vocoder="hifigan")
        engine = TTSEngine(msd, mcfg, scfg, folded, hcfg, device=dev)
        engine.synthesise_lowlatency(text, seed=7, budget=VOC_BUDGET)  # capture
        (stage,) = engine._stages.values()
        if stage.launches["mrf_step"] != per_call:
            raise AssertionError(f"{dtype}: the graph recorded {stage.launches} at capture")
        engines[dtype] = engine
    for engine in engines.values():
        reset_serving_counts(engine)
    served = {d: e.synthesise_lowlatency(text, seed=7, budget=VOC_BUDGET)
              for d, e in engines.items()}
    counts = {d: dict(e.launches) for d, e in engines.items()}
    eager = wrapper_counts()
    want = {"attention_fwd": scfg.n_timesteps
            * sum(n for n, _ in attention_shapes(mcfg.decoder, 1)),
            "mrf_step": per_call}
    if any(c != want for c in counts.values()) or any(eager.values()):
        raise AssertionError(f"served launches {counts} replayed and {eager} eager, expected "
                             f"{want} a request and none eager")
    res = {"launches": {n: sum(c[n] for c in counts.values()) for n in want},
           "launches_per_request": want, "requests": {}}
    for dtype, engine in engines.items():
        wav, info = served[dtype]
        x, xl = (a.to(dev) for a in engine._tokenize([text]))
        (z,) = engine._draws(1, VOC_BUDGET, None, [7])
        with torch.no_grad():
            mel = engine.model.decode_fixed(*engine._encode(x, xl), VOC_BUDGET,
                                            engine.cfg.n_timesteps, engine.cfg.temperature,
                                            z=z)["mel"]
            ref = train_form(mel.float())[0, : len(wav)].clamp(-1.0, 1.0)
        atol, rtol = TOL_MRF_F32 if dtype == "float32" else TOL["bfloat16"]
        err = max_err_within(torch.from_numpy(wav).to(dev), ref, atol, rtol,
                             f"served {dtype} waveform vs the training form")
        prof = replay_profile(
            engine, lambda e=engine: e.synthesise_lowlatency(text, seed=7, budget=VOC_BUDGET),
            f"trained vocoder, low-latency request ({dtype})")
        res["requests"][dtype] = {"budget": info["budget"], "mel_lengths": info["mel_lengths"],
                                  "wall_s": info["wall_s"], "max_abs_err": err,
                                  "bar": {"atol": atol, "rtol": rtol}, "profile": prof}
        log(f"trained vocoder served ({dtype} engine, {info['mel_lengths']} frames at budget "
            f"{VOC_BUDGET}): waveform vs the training form {err:.3g} (atol {atol}, rtol {rtol})")
    log(f"trained vocoder serving launches {counts} by graph replay (expected {want} a request), "
        f"eager {eager}")
    return res


def vocoder_train_path(dev, mcfg, seed, root, hcfg, disc_kw=None, segment=8192):
    """HiFi-GAN training at full width (`HiFiGANConfig()`, v1's discriminators,
    `VocoderTrainConfig()`, batch 16 of 8192 samples, 64 synthetic items: 4
    GAN steps an epoch), every step a CUDA graph replay, and the trained
    generator served through K2."""
    from matcha_tpu_torch.data.audio_dataset import AudioDataConfig, SyntheticWavDataset

    disc_kw = disc_kw or {}
    dcfg = AudioDataConfig(batch_size=16, segment_size=segment)
    train_ds = SyntheticWavDataset(n_items=VOC_ITEMS, segment_size=segment)
    val_ds = SyntheticWavDataset(n_items=VOC_VAL_ITEMS, segment_size=segment, seed=1)
    args = (hcfg, disc_kw, dcfg)
    t0 = time.perf_counter()
    runs, params = vocoder_fit_runs(dev, seed, root, *args, train_ds, val_ds)
    res = {"runs": runs,
           "graphs_vs_eager": vocoder_graphs_vs_eager(dev, seed, root, *args, train_ds, runs,
                                                      params)}
    del params
    res["validation"] = vocoder_validation(dev, seed, root, *args, val_ds)
    res["step_times"] = vocoder_step_times(dev, seed, root, *args, train_ds)
    res["card_vs_cpu"] = vocoder_card_vs_cpu(dev, seed, root, hcfg, disc_kw, segment)
    res["serve"] = vocoder_serve_loop(dev, mcfg, hcfg, seed, root / "voc")
    res["launches"] = res["serve"]["launches"]
    res["requests"] = {d: [("lowlatency", 1, VOC_BUDGET, r["mel_lengths"])]
                       for d, r in res["serve"]["requests"].items()}
    res["phase_s"] = time.perf_counter() - t0
    log(f"vocoder training path: {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------- entry points
ENTRY_STEPS = 10
# the serve CLI's texts: 51-55 characters, one 512-frame budget at ~6-7 frames
# a character, so that the concurrent requests can form one group and one decode
SERVE_CLI_TEXTS = ["The birch canoe slid on the smooth planks by the river.",
                   "Glue the sheet to the dark blue background with care.",
                   "It is easy to tell the depth of a well in the dark.",
                   "Four hours of steady work faced us on the old farm."]


def reference_checkpoints(mcfg, hcfg, seed, root):
    """`model_weights` written as the reference's files: a Lightning `.ckpt`
    and a `generator_v1` whose conv weights are split into weight_g (torch's
    norm over every axis but 0) and weight_v."""
    msd, gsd = model_weights(mcfg, hcfg, seed)
    wn = {}
    for key, val in gsd.items():
        if key.endswith(".weight") and val.ndim == 3:
            stem = key[: -len(".weight")]
            wn[f"{stem}.weight_g"] = torch.linalg.vector_norm(val, dim=(1, 2), keepdim=True)
            wn[f"{stem}.weight_v"] = val
        else:
            wn[key] = val
    paths = (root / "matcha_final.ckpt", root / "generator_v1")
    torch.save({"state_dict": msd, "epoch": 0}, paths[0])
    torch.save({"generator": wn}, paths[1])
    return paths


def generate_run(dev, mcfg, hcfg, ckpt, gen_path, vocoder, seed, out_dir):
    """`cli.generate` on the card (no --device), 10 steps, with the wrappers'
    counts set to 0 just before and read just after; its mel (recorded from
    `decode_fixed`) and its wav against the same calls made here on the same
    files and seed: K1's f32 bar for the mel; for the waveform K2's f32 bar
    (Griffin-Lim: K1's, its input being that mel) plus one PCM16 step."""
    from matcha_tpu_torch.audio.griffin_lim import mel_to_audio
    from matcha_tpu_torch.audio.mel import MelConfig, load_wav
    from matcha_tpu_torch.cli import generate
    from matcha_tpu_torch.compat.torch_import import (
        load_hifigan_torch_checkpoint,
        load_matcha_torch_checkpoint,
    )
    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.ops.masks import fix_len_compatibility
    from matcha_tpu_torch.text import simple_text_to_sequence

    argv = ["--text", TEXTS[2], "--torch-ckpt", str(ckpt), "--steps", str(ENTRY_STEPS),
            "--seed", str(seed), "--vocoder", vocoder, "--out-dir", str(out_dir)]
    if vocoder == "hifigan":
        argv += ["--hifigan-ckpt", str(gen_path)]
    decode, mels = MatchaTTS.decode_fixed, []

    def recorded(self, *a, **kw):
        out = decode(self, *a, **kw)
        mels.append(out["mel"].clone())
        return out

    MatchaTTS.decode_fixed = recorded
    try:
        reset_wrapper_counts()
        t0 = time.perf_counter()
        generate.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = wrapper_counts()
    finally:
        MatchaTTS.decode_fixed = decode

    model = MatchaTTS(mcfg).eval()
    load_matcha_torch_checkpoint(ckpt, model)
    model.to(dev)
    seq = simple_text_to_sequence(TEXTS[2])
    gen = torch.Generator(device=dev).manual_seed(seed)
    enc = model.encode_durations(torch.tensor([seq], device=dev),
                                 torch.tensor([len(seq)], device=dev))
    budget = fix_len_compatibility(int(enc[3].max()))
    ref = model.decode_fixed(*enc, budget, ENTRY_STEPS, 1.0, generator=gen)
    n = int(ref["mel_lengths"][0])
    (mel,) = mels
    atol, rtol = TOL["float32"]
    mel_err = max_err_within(mel[:, :n], ref["mel"][:, :n], atol, rtol, f"generate {vocoder} mel")
    if vocoder == "hifigan":
        want = load_hifigan_torch_checkpoint(gen_path).to(dev)(ref["mel"][:, :n])
        atol, rtol = TOL_MRF_F32
    else:
        want = mel_to_audio(MelConfig(), ref["mel"][:, :n].transpose(1, 2), generator=gen)
    want = want[0].float().cpu().clamp(-1.0, 1.0)
    wav, sr = load_wav(out_dir / f"matcha_{vocoder}.wav")
    if wav.shape != (n * 256,) or sr != 22050 or not np.isfinite(wav).all() \
            or np.abs(wav).max() > 1.0 or np.abs(wav).max() == 0:
        raise AssertionError(f"generate {vocoder}: wav {wav.shape} at {sr} Hz for {n} frames")
    # the file holds int16(clip(x) * 32767); load_wav divides by 32768
    wav_err = max_err_within(torch.from_numpy(wav * (32768 / 32767)), want, atol + 1 / 32767,
                             rtol, f"generate {vocoder} waveform")
    want_counts = {"attention_fwd": ENTRY_STEPS * sum(
                       c for c, _ in attention_shapes(mcfg.decoder, budget)),
                   "mrf_step": len(mrf_shapes(hcfg, 1)) if vocoder == "hifigan" else 0}
    if counts != want_counts:
        raise AssertionError(f"generate {vocoder}: launches {counts}, expected {want_counts}")
    log(f"generate ({vocoder}, {ENTRY_STEPS} steps, {n} frames at budget {budget}): wall "
        f"{wall:.2f} s, launches {counts}; mel vs the same calls {mel_err:.3g} (bar "
        f"{TOL['float32']}), waveform {wav_err:.3g} (bar {atol} + one PCM16 step, rtol {rtol})")
    return {"frames": n, "budget": budget, "wall_s": wall, "launches": counts,
            "mel_max_abs_err": mel_err, "wav_max_abs_err": wav_err}


def serve_cli_run(dev, ckpt, gen_path, mode, seed, out_dir):
    """`cli.serve --bf16 --int16 --hifigan-ckpt` on the card on SERVE_CLI_TEXTS
    (plain, --concurrent or --low-latency), the wrappers' counts set to 0 just
    before. The CLI's engine (recorded as it is built) is then read: every
    decode graph recorded K1 60 and K2 36 at capture, the replays added whole
    multiples of that, and the wrappers ticked only in the captures (a warm-up
    run and the capture each). Each wav is bit-equal to the engine's direct
    call with the same seed: `synthesise(texts, seed)`, `synthesise_lowlatency(
    text, seed + i)`, and for --concurrent `synthesise(texts, seeds)` when the
    worker made one group of one budget (one decode); when it split the group
    (arrival timing), each against its solo synthesis within TOL_WAV."""
    from scipy.io import wavfile

    from matcha_tpu_torch import serve as serve_mod
    from matcha_tpu_torch.cli import serve

    engines = []
    base = serve_mod.TTSEngine

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    flags = {"plain": [], "concurrent": ["--concurrent"], "low_latency": ["--low-latency"]}
    argv = ["--texts", *SERVE_CLI_TEXTS, "--torch-ckpt", str(ckpt), "--vocoder", "hifigan",
            "--hifigan-ckpt", str(gen_path), "--bf16", "--int16", "--seed", str(seed),
            "--out-dir", str(out_dir), *flags[mode]]
    serve_mod.TTSEngine = Recorded
    try:
        reset_wrapper_counts()
        t0 = time.perf_counter()
        serve.main(argv)
        wall = time.perf_counter() - t0
        eager = wrapper_counts()
    finally:
        serve_mod.TTSEngine = base
    (engine,) = engines
    replayed = dict(engine.launches)
    # a decode (or low-latency) graph: the U-Net's K1 at every step and the generator's K2
    per_decode = {"attention_fwd": engine.cfg.n_timesteps
                  * sum(c for c, _ in attention_shapes(engine.model.cfg.decoder, 1)),
                  "mrf_step": len(mrf_shapes(engine.vocoder.cfg, 1))}
    captured = {n: 0 for n in replayed}
    for key, stage in engine._stages.items():
        want = {n: 0 for n in replayed} if key[0] == "encode" else per_decode
        if stage.launches != want:
            raise AssertionError(f"serve CLI {mode}: stage {key} recorded {stage.launches}, "
                                 f"expected {want}")
        for n in captured:  # the warm-up run and the capture
            captured[n] += 2 * stage.launches[n]
    decodes = replayed["mrf_step"] // per_decode["mrf_step"]
    if eager != captured or replayed != {n: decodes * v for n, v in per_decode.items()} \
            or decodes < 1:
        raise AssertionError(f"serve CLI {mode}: replayed {replayed}, eager {eager}; expected "
                             f"whole decodes of {per_decode} and eager only at capture "
                             f"{captured}")
    got = [wavfile.read(out_dir / f"utt_{i:03d}.wav")[1] for i in range(len(SERVE_CLI_TEXTS))]
    texts, seeds = SERVE_CLI_TEXTS, [seed + i for i in range(len(SERVE_CLI_TEXTS))]
    if mode == "plain":
        want, info = engine.synthesise(texts, seed=seed)
        budgets = [info["budget"]]
    elif mode == "low_latency":
        res = [engine.synthesise_lowlatency(t, seed=s) for t, s in zip(texts, seeds)]
        want, budgets = [w for w, _ in res], [i["budget"] for _, i in res]
    elif decodes == 1:
        want, info = engine.synthesise(texts, seeds=seeds)
        budgets = [info["budget"]]
    else:
        want = None
        solo = [engine.synthesise([t], seeds=[s]) for t, s in zip(texts, seeds)]
        gaps = [max_err_within(torch.from_numpy(g.astype(np.float32)),
                               torch.from_numpy(w[0].astype(np.float32)), TOL_WAV * 32767, 0.0,
                               f"serve CLI concurrent text {i} vs solo")
                for i, (g, (w, _)) in enumerate(zip(got, solo))]
        budgets = [i["budget"] for _, i in solo]
    if want is not None:
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"serve CLI {mode}: text {i} differs from the engine's "
                                     f"direct call ({g.shape} vs {w.shape})")
        gaps = [0.0] * len(got)
    log(f"serve CLI ({mode}, bf16, int16, HiFi-GAN): {wall:.2f} s with {len(engine._stages)} "
        f"graphs captured, {decodes} decode replay(s), budgets {budgets}, launches replayed "
        f"{replayed}, eager {eager} (captures only); wavs "
        f"{'bit-equal to the direct calls' if want is not None else f'within {TOL_WAV} of solo'}")
    return {"wall_s": wall, "graphs": len(engine._stages), "decodes": decodes,
            "budgets": budgets, "launches_replayed": replayed, "launches_at_capture": eager,
            "bit_equal": want is not None, "max_abs_gap_pcm16": max(gaps)}


def bench_mas_run(dev):
    """`cli.bench_mas` on the card: it holds the fused kernel bit-equal to the
    plain version and the C++ MAS at the reference's three shapes (Tx 50, 100
    and 150: Tx 100 and 150 take the 4-cells-a-lane path), then times all
    three. The MAS count set to 0 just before and read just after."""
    import contextlib
    import io

    from matcha_tpu_torch.cli import bench_mas
    from matcha_tpu_torch.ops import mas

    mas.mas_cuda.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        bench_mas.main([])
    wall = time.perf_counter() - t0
    launches = mas.mas_cuda.launches
    if launches != len(bench_mas.SHAPES) * (bench_mas.RUNS + 2):
        raise AssertionError(f"bench_mas made {launches} MAS launches")
    table = {}
    for line in buf.getvalue().splitlines():
        log(f"  bench_mas: {line}")
        m = re.match(r"\s*\((\d+), (\d+), (\d+)\)\s+(\S+)\s+(\S+)\s+(\S+)", line)
        if m:
            table[m.group(1, 2, 3)] = {"kernel_ms": float(m.group(4)),
                                       "plain_ms": float(m.group(5)),
                                       "cpp_ms": float(m.group(6))}
    if len(table) != len(bench_mas.SHAPES):
        raise AssertionError(f"bench_mas printed {len(table)} rows")
    log(f"bench_mas: kernel, plain and cpp bit-equal at {bench_mas.SHAPES}; {wall:.1f} s")
    return {"wall_s": wall, "launches": launches, "runs": bench_mas.RUNS,
            "table": {str(tuple(int(v) for v in k)): r for k, r in table.items()}}


def vocoder_report_run(dev, hcfg, ckpt_dir, out):
    """`cli.vocoder_report --synthetic --n 4` on the card on the vocoder phase's
    trained store, the wrappers' counts set to 0 just before and read just
    after: K2 36 a generator call, no K1. Each item's HiFi-GAN waveform
    (recorded from `Generator.forward` with its mel) is held against the
    training-form generator (plain convolutions, f32) on the same mel at
    K2's f32 bar; the report holds a finite mel L1 per item and path."""
    from matcha_tpu_torch.cli import vocoder_report
    from matcha_tpu_torch.models.hifigan import Generator
    from matcha_tpu_torch.train.checkpoints import CheckpointStore

    n, forward, calls = 4, Generator.forward, []

    def recorded(self, mel):
        wav = forward(self, mel)
        calls.append((mel.detach().clone(), wav.detach().clone()))
        return wav

    Generator.forward = recorded
    try:
        reset_wrapper_counts()
        t0 = time.perf_counter()
        vocoder_report.main(["--synthetic", "--n", str(n), "--vocoder-ckpt-dir", str(ckpt_dir),
                             "--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = wrapper_counts()
    finally:
        Generator.forward = forward
    want = {"attention_fwd": 0, "mrf_step": n * len(mrf_shapes(hcfg, 1))}
    if counts != want or len(calls) != n:
        raise AssertionError(f"vocoder_report launches {counts} in {len(calls)} generator "
                             f"calls, expected {want} in {n}")
    report = json.loads(out.read_text())
    per_item = {p: r["mel_l1_per_item"] for p, r in report["paths"].items()}
    if set(per_item) != {"griffin_lim", "hifigan_trained"} \
            or any(len(v) != n or not np.isfinite(v).all() for v in per_item.values()):
        raise AssertionError(f"vocoder_report wrote {per_item}")
    train_form = Generator(hcfg, weight_norm=True)
    train_form.load_state_dict(CheckpointStore(ckpt_dir).restore_params("best", "cpu")["gen"])
    train_form.to(dev)
    atol, rtol = TOL_MRF_F32
    with torch.no_grad():
        errs = [max_err_within(wav, train_form(mel), atol, rtol,
                               f"vocoder_report item {i}: waveform vs the training form")
                for i, (mel, wav) in enumerate(calls)]
    frames = [mel.shape[1] for mel, _ in calls]
    means = {p: r["mel_l1_mean"] for p, r in report["paths"].items()}
    log(f"vocoder_report on the trained store ({n} synthetic items of {frames} frames): mel L1 "
        f"{means}, launches {counts}, waveforms vs the training form {max(errs):.3g} (atol "
        f"{atol}, rtol {rtol}), {wall:.1f} s")
    return {"wall_s": wall, "launches": counts, "frames": frames, "max_abs_err": max(errs),
            "bar": {"atol": atol, "rtol": rtol}, "mel_l1_mean": means, "report": report}


def time_bench_mas(dev, step_ns, reps=20):
    """The fused MAS kernel at bench_mas's shapes and inputs: held against its
    plain version, timed beside it, with its bound (`mas_row`)."""
    from matcha_tpu_torch.cli import bench_mas
    from matcha_tpu_torch.ops import mas

    rows = []
    for b, tx, ty in bench_mas.SHAPES:
        value, mask = (torch.from_numpy(a).to(dev) for a in bench_mas.make_problem(b, tx, ty))
        t_x, t_y = mas.lengths_from_mask(mask)
        calls = bench_mas.RUNS + 2  # its check, its warm-up and its timed calls
        rows.append(dict({"path": "bench_mas", "dtype": "float32", "peak_flops": PEAK_F32_FLOPS,
                          "shape": [b, tx, ty], "count": calls, "launches": calls},
                         **mas_row(value, mask, t_x, t_y, step_ns, reps)))
    log_rows({"mas": rows})
    return rows


def entry_points(dev, mcfg, hcfg, seed, root):
    """The port's entry points on the card as a user calls them (no --device):
    `generate` with HiFi-GAN and with Griffin-Lim, `serve` in its three modes,
    `bench_mas` and `vocoder_report` (on the vocoder phase's store, root/voc),
    from the reference's checkpoint formats written from `model_weights`."""
    t0 = time.perf_counter()
    ckpt, gen_path = reference_checkpoints(mcfg, hcfg, seed, root)
    res = {"generate": {v: generate_run(dev, mcfg, hcfg, ckpt, gen_path, v, seed,
                                        root / f"generate_{v}")
                        for v in ("hifigan", "griffin_lim")},
           "serve": {m: serve_cli_run(dev, ckpt, gen_path, m, seed, root / f"serve_{m}")
                     for m in ("plain", "concurrent", "low_latency")},
           "bench_mas": bench_mas_run(dev),
           "vocoder_report": vocoder_report_run(dev, hcfg, root / "voc",
                                                root / "vocoder_roundtrip.json")}
    res["phase_s"] = time.perf_counter() - t0
    log(f"entry points: {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------- batch-16 serving
# a loaded `serve()` forms batches of the engine's default max_batch, 16; at the
# 512-frame budget (the only one configured, so the batch always decodes there)
BATCH16_BUDGET = 512
BATCH16_TEXTS = TEXTS + SERVE_CLI_TEXTS + [
    "A pot of tea helps to pass the evening.",
    "The box was thrown beside the parked truck.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The hogs were fed chopped corn and garbage.",
    "Smoky fires lack flame and heat.",
    "The soft cushion broke the man's fall.",
    "The salt breeze came across from the sea.",
]


def serve_batch16(dev, mcfg, hcfg, seed, reps=5):
    """One full-width batch of 16 texts through `TTSEngine.synthesise` at
    budget 512 on the graphs of a bf16 HiFi-GAN engine (int16 output), the
    counts set to 0 just before and read just after: one decode replay, K1 60
    and K2 36, none eager; waveforms finite, non-silent, of their lengths;
    the median wall of `reps` more batches and one profiled replay (the
    profiler's K1 and K2 equal the graph accounting)."""
    from matcha_tpu_torch.serve import ServeConfig, TTSEngine

    msd, gsd = model_weights(mcfg, hcfg, seed)
    scfg = ServeConfig(bf16=True, vocoder="hifigan", output_dtype="int16",
                       mel_budgets=(BATCH16_BUDGET,))
    engine = TTSEngine(msd, mcfg, scfg, gsd, hcfg, device=dev)
    texts, seeds = BATCH16_TEXTS, list(range(300, 300 + len(BATCH16_TEXTS)))
    if len(texts) != scfg.max_batch:
        raise AssertionError(f"{len(texts)} texts for a max_batch of {scfg.max_batch}")
    warm = warm_engine(engine, [((len(texts),), max(texts, key=len))])
    reset_serving_counts(engine)
    wavs, info = engine.synthesise(texts, seeds=seeds)
    counts, eager = dict(engine.launches), wrapper_counts()
    want = {"attention_fwd": scfg.n_timesteps * sum(n for n, _ in
                                                    attention_shapes(mcfg.decoder, 1)),
            "mrf_step": len(mrf_shapes(hcfg, 1))}
    log(f"batch-16 serving launches by graph replay {counts} (expected {want}); eager "
        f"{eager} (expected none)")
    if counts != want or any(eager.values()) or info["budget"] != BATCH16_BUDGET:
        raise AssertionError(f"batch of 16: launches {counts} replayed, {eager} eager, budget "
                             f"{info['budget']}; expected {want}, none, {BATCH16_BUDGET}")
    for wav, ml in zip(wavs, info["mel_lengths"]):
        if wav.dtype != np.int16 or wav.shape != (ml * 256,) or ml < 8 \
                or np.abs(wav).max() == 0:
            raise AssertionError(f"batch of 16: waveform {wav.dtype} {wav.shape} for {ml} frames")
    walls = [engine.synthesise(texts, seeds=seeds)[1]["wall_s"] * 1e3 for _ in range(reps)]
    prof = replay_profile(engine, lambda: engine.synthesise(texts, seeds=seeds),
                          "synthesise, 16 texts (HiFi-GAN, bf16)")
    res = {"budget": info["budget"], "mel_lengths": info["mel_lengths"],
           "truncated": info["truncated"], "launches": counts, "warmup": warm,
           "wall_ms_median": float(np.median(walls)), "wall_ms": walls, "rtf": info["rtf"],
           "profile": prof}
    log(f"batch of 16 at budget {res['budget']}: {sum(info['truncated'])} truncated, wall median "
        f"{res['wall_ms_median']:.2f} ms over {reps}, busy {prof['device_ms']:.2f} ms")
    return res


# ---------------------------------------------------------------- FFN variants
FFN_SHAPE = (2, 448)  # (B, T) of the variant blocks' input: a training batch's longest T


def ffn_variants_on_card(dev, mcfg, seed):
    """Each feed-forward variant's decoder block at full width (the decoder's
    channels, heads and head width) on the card against the same block on the
    CPU, float32 with TF32 off, on a ragged 0/1 key mask: one K1 launch a
    block, within K1's float32 bar (TOL float32)."""
    from matcha_tpu_torch.nn.transformer import ACTIVATIONS, BasicTransformerBlock
    from matcha_tpu_torch.ops.attention import attention

    dcfg = mcfg.decoder
    dim = dcfg.channels[0]
    b, t = FFN_SHAPE
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, dim), generator=gen)
    mask = (torch.arange(t)[None, :] < torch.tensor([t, t - 97])[:, None]).float()
    atol, rtol = TOL["float32"]
    res = {}
    for act in ACTIVATIONS:
        blk = BasicTransformerBlock(dim, dcfg.num_heads, dcfg.attention_head_dim,
                                    activation_fn=act).eval()
        blk.load_state_dict(module_weights(blk, seed))
        with torch.no_grad():
            want = blk(x, mask)
            blk.to(dev)
            before = attention.launches
            got = blk(x.to(dev), mask.to(dev))
            launches = attention.launches - before
        err = max_err_within(got.cpu(), want, atol, rtol, f"FFN {act} block, card vs CPU")
        if launches != 1:
            raise AssertionError(f"FFN {act} block: {launches} K1 launches, expected 1")
        res[act] = {"max_abs_err": err, "k1_launches": launches}
    log(f"decoder block by feed-forward variant at {[b, t, dim]}, card vs CPU (f32, TF32 off): "
        f"{ {a: r['max_abs_err'] for a, r in res.items()} } (bar atol {atol}, rtol {rtol}); "
        f"K1 once each")
    return res


# ---------------------------------------------------------------- examples
def load_example(name):
    """The module of `examples/<name>.py`."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def demo_run(dev, seed, out_dir):
    """`examples/demo_torch.py` at full width on the card (no --device), the
    counts set to 0 just before and read just after, against the same calls
    made here with its models, text and seed (also counted): equal launches
    (K1 60 for 10 Euler steps, K2 36 for HiFi-GAN, none for Griffin-Lim), the
    mel within K1's f32 bar, the waveforms within K2's f32 bar (HiFi-GAN)
    and K1's (Griffin-Lim, on that mel); its wavs written."""
    from matcha_tpu_torch.audio.griffin_lim import mel_to_audio
    from matcha_tpu_torch.audio.mel import MelConfig
    from matcha_tpu_torch.ops.masks import fix_len_compatibility
    from matcha_tpu_torch.text import simple_text_to_sequence

    demo = load_example("demo_torch")
    reset_wrapper_counts()
    t0 = time.perf_counter()
    res = demo.main(["--out", str(out_dir), "--seed", str(seed)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = wrapper_counts()

    model, vocoder = res["model"], res["vocoder"]
    seq = simple_text_to_sequence(demo.DEFAULT_TEXT)
    reset_wrapper_counts()
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(seed)
        enc = model.encode_durations(torch.tensor([seq], device=dev),
                                     torch.tensor([len(seq)], device=dev))
        budget = fix_len_compatibility(max(int(enc[3].max()), 4))
        ref = model.decode_fixed(*enc, budget, 10, 0.667, generator=gen)
        mel = ref["mel"][:, :int(ref["mel_lengths"][0])]
        wavs = {"griffin_lim": mel_to_audio(MelConfig(n_mels=model.cfg.n_feats),
                                            mel.transpose(1, 2), generator=gen),
                "hifigan": torch.clamp(vocoder(mel), -1.0, 1.0)}
    direct = wrapper_counts()
    want = {"attention_fwd": 10 * sum(c for c, _ in attention_shapes(model.cfg.decoder, budget)),
            "mrf_step": len(mrf_shapes(vocoder.cfg, 1))}
    if counts != direct or counts != want or res["budget"] != budget:
        raise AssertionError(f"demo_torch: launches {counts}, the direct calls' {direct}, "
                             f"expected {want}; budget {res['budget']} vs {budget}")
    errs = {"mel": max_err_within(res["mel"], mel, *TOL["float32"], "demo_torch mel"),
            "hifigan": max_err_within(res["wavs"]["hifigan"], wavs["hifigan"], *TOL_MRF_F32,
                                      "demo_torch HiFi-GAN waveform"),
            "griffin_lim": max_err_within(res["wavs"]["griffin_lim"], wavs["griffin_lim"],
                                          *TOL["float32"], "demo_torch Griffin-Lim waveform")}
    written = sorted(p.name for p in Path(out_dir).iterdir())
    if not {"demo_griffin_lim.wav", "demo_hifigan.wav"} <= set(written):
        raise AssertionError(f"demo_torch wrote {written}")
    log(f"demo_torch at full width on the card: {res['frames']} frames at budget {budget}, "
        f"wall {wall:.2f} s, RTF {res['rtf']}, launches {counts} = the direct calls'; against "
        f"them: {errs}; wrote {written}")
    return {"frames": res["frames"], "budget": budget, "wall_s": wall, "rtf": res["rtf"],
            "launches": counts, "max_abs_err": errs, "written": written}


def demo_serving_run(dev, seed, out_dir):
    """`examples/demo_serving_torch.py --bf16` at full width on the card (no
    --device; HiFi-GAN), the counts set to 0 just before and read just after,
    its engine recorded; then a fresh engine on the same weights and config
    driven directly through the same calls (warm-up, the batch, the
    low-latency request, the 4 concurrent `serve()` requests), counted the
    same way: equal launches replayed and at capture (none eager besides the
    captures), one serve() group of 4 in both, every wav bit-equal."""
    from matcha_tpu_torch import serve as serve_mod

    demo = load_example("demo_serving_torch")
    engines, base = [], serve_mod.TTSEngine

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    serve_mod.TTSEngine = Recorded
    try:
        reset_wrapper_counts()
        t0 = time.perf_counter()
        res = demo.main(["--out", str(out_dir), "--seed", str(seed), "--bf16"])
        wall = time.perf_counter() - t0
        demo_eager = wrapper_counts()
    finally:
        serve_mod.TTSEngine = base
    (engine,) = engines
    demo_replayed = dict(engine.launches)

    direct = base(res["params"], engine.model.cfg, engine.cfg, res["vocoder_params"],
                  engine.vocoder.cfg, device=dev, seed=seed)
    reset_wrapper_counts()
    direct.warmup(batch_sizes=(1, len(demo.TEXTS)),
                  text=max(demo.TEXTS + [demo.LOWLATENCY_TEXT], key=len))
    wavs, _ = direct.synthesise(demo.TEXTS, seeds=res["seeds"])
    wav_ll, _ = direct.synthesise_lowlatency(demo.LOWLATENCY_TEXT, seed=seed)
    served = demo.serve_concurrently(direct, demo.TEXTS, res["seeds"])
    direct_eager, direct_replayed = wrapper_counts(), dict(direct.launches)
    captured = {n: sum(2 * st.launches[n] for st in engine._stages.values()) for n in demo_eager}
    groups = [[i["group_size"] for _, i in r] for r in (res["served"], served)]
    pairs = (list(zip(res["batch"][0], wavs)) + [(res["lowlatency"][0], wav_ll)]
             + [(a[0], b[0]) for a, b in zip(res["served"], served)])
    equal = all(a.shape == b.shape and np.array_equal(a, b) for a, b in pairs)
    if demo_replayed != direct_replayed or demo_eager != direct_eager \
            or demo_eager != captured or groups != [[4] * 4] * 2 or not equal:
        raise AssertionError(f"demo_serving_torch: replayed {demo_replayed} vs direct "
                             f"{direct_replayed}, eager {demo_eager} vs direct {direct_eager} "
                             f"(captures {captured}), serve() groups {groups}, wavs equal {equal}")
    log(f"demo_serving_torch at full width on the card (bf16, HiFi-GAN): wall {wall:.2f} s, "
        f"{len(engine._stages)} graphs; launches replayed {demo_replayed}, at capture "
        f"{demo_eager}, equal to the direct engine calls'; serve() one group of 4; "
        f"{len(pairs)} wavs bit-equal to the direct calls")
    return {"wall_s": wall, "graphs": len(engine._stages), "launches_replayed": demo_replayed,
            "launches_at_capture": demo_eager, "batch": res["batch"][1],
            "lowlatency": res["lowlatency"][1], "serve_budgets": [i["budget"] for _, i in served]}


def demos(dev, seed, root):
    """Both examples at full width on the card."""
    return {"demo_torch": demo_run(dev, seed, root / "demo"),
            "demo_serving_torch": demo_serving_run(dev, seed, root / "demo_serving")}


# ---------------------------------------------------------------- phase 5
# ---------------------------------------------------------------- parallel
# the decoder's attention at the 512-frame budget of the 4-text request: (B, T)
# of its two U-Net levels
PAR_RING = ((4, 512), (4, 256))
PAR_BLOCKS = 4  # the ring's per-rank computation over T cut into this many blocks
PAR_DECODE_BUDGET = 512
# seq-parallel decode at one rank against decode_fixed, f32 mel: the halo
# convolutions and the summed GroupNorm statistics are other float32 sums than
# cuDNN's and GroupNorm's, carried through 10 Euler steps of the U-Net
TOL_SEQ_MEL = 1e-4


def join_one_rank(dev):
    """This process as the one rank of a group, as `torchrun --nproc_per_node
    1` would start it: the launcher's variables set, `init_distributed` on
    NCCL, bound to `dev`."""
    import os
    import socket

    import torch.distributed as dist

    from matcha_tpu_torch.parallel import init_distributed

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK=str(dev.index or 0))
    joined = init_distributed(dev)
    if not joined or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"init_distributed joined {joined}, backend "
                             f"{dist.get_backend()}, world {dist.get_world_size()}")
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "again": init_distributed(dev)}


def counting(run):
    """run() with every wrapper's count set to 0 just before and read just
    after: (its result, {kernel: launches})."""
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    out = run()
    return out, {n: c.launches for n, c in counters.items()}


def add_counts(total, counts):
    for n, c in counts.items():
        total[n] = total.get(n, 0) + c


def par_fit(dev, mcfg, seed, root, name, mesh):
    """One epoch of `fit` at full width at K = 2 (fp32) on the bucket set (runs
    of same-shape batches, so that K = 2 graphs replay), with `mesh` or none."""
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    train_ds, val_ds, dcfg, _ = bucket_batches(mcfg)
    trainer = Trainer(mcfg, TrainConfig(ckpt_dir=str(root / name), log_every=1, seed=seed,
                                        steps_per_dispatch=2), dcfg, device=dev, mesh=mesh)
    trainer.fit(train_ds, val_ds, max_epochs=1)
    torch.cuda.synchronize()
    return trainer


def metric_rows(ckpt_dir, prefix):
    from matcha_tpu_torch.train.trainer import METRICS

    rows = read_metrics(ckpt_dir)[0 if prefix == "train/" else 1]
    keys = METRICS if prefix == "train/" else ("dur_loss", "prior_loss", "diff_loss", "loss")
    return torch.tensor([[r[prefix + k] for k in keys] for r in rows], dtype=torch.float64)


def step_walls(trainer, batch, reps=20):
    """Median wall ms of `reps` 1-step replays of `batch` (the graph captured
    first) and a profile of two of them (busy ms, NCCL's share)."""
    trainer.dispatch([(batch, 0)], 0)
    torch.cuda.synchronize()
    walls = synced_walls(lambda: trainer.dispatch([(batch, 0)], 0), reps)
    prof = per_step_profile(lambda: trainer.dispatch([(batch, 0)], 0))
    return {"wall_ms_median": float(np.median(walls)), "wall_ms": walls,
            "busy_ms_per_step": prof.get("busy_ms_per_step", "not measured"),
            "nccl_ms_per_step": prof.get("by_group_ms", {}).get("nccl", 0.0) / 2,
            "nccl_kernels_per_step": prof.get("launches_by_group", {}).get("nccl", 0) / 2}


def parallel_training(dev, mcfg, seed, root):
    """`fit` (one epoch at K = 2, fp32) on a data group and with the
    tensor-parallel path at model = 1, each against a trainer without a group
    from the same seed: every micro-step and validation batch a replay with
    its all-reduces captured, launches per micro-step and validation as
    without a group,
    logged metrics and final parameters within the training graphs' bars.
    Then a micro-step's median replayed wall with and without the group."""
    from matcha_tpu_torch.data.dataset import batch_iterator, num_batches
    from matcha_tpu_torch.parallel import make_mesh

    train_ds, val_ds, dcfg, _ = bucket_batches(mcfg)
    ref = par_fit(dev, mcfg, seed, root, "par_none", None)
    ref_params = [p.detach().clone() for p in ref.params]
    want_rows = {p: metric_rows(root / "par_none", p) for p in ("train/", "val/")}
    batch = next(iter(batch_iterator(train_ds, dcfg, epoch=0)))
    batch.pop("n_real")
    walls = {"none": step_walls(ref, batch)}
    micro = num_batches(BUCKET_ITEMS, dcfg)
    val_batches = num_batches(VAL_ITEMS, dcfg, drop_last=False)
    step_launches, val_launches = per_micro_step(mcfg), per_validation_batch(mcfg)
    want = {n: micro * c + val_batches * val_launches[n] for n, c in step_launches.items()}
    total, runs = {}, {}
    for name, model in (("dp", None), ("tp", 1)):
        mesh = make_mesh(model=model)
        trainer, ticks = counting(lambda: par_fit(dev, mcfg, seed, root, f"par_{name}", mesh))
        check_graph_launches(trainer, mcfg)
        captured = {n: sum(g.launches[n] + g.warmup_launches[n] for g in
                           list(trainer.graphs.values()) + list(trainer.eval_graphs.values()))
                    for n in trainer.launches}
        eager = {n: ticks[n] - captured[n] for n in trainer.launches}
        if dict(trainer.launches) != want or any(eager.values()) or ticks["mrf_step"] \
                or 2 not in trainer.replays or trainer.eval_replays != val_batches:
            raise AssertionError(f"{name}: replayed {trainer.launches}, eager {eager}, "
                                 f"{trainer.eval_replays} validation replays; expected {want}, "
                                 f"none eager and {val_batches} validation replays")
        add_counts(total, dict(trainer.launches))
        gaps = {p: metric_gap(metric_rows(root / f"par_{name}", p), want_rows[p],
                              f"{name} {p} logs") for p in ("train/", "val/")}
        runs[name] = {"mesh": mesh.shape, "tensor_parallel": trainer._tp is not None,
                      "params": param_gap(trainer.params, ref_params, ref.train_cfg.lr),
                      "metrics": gaps, "replays": {str(k): n for k, n in trainer.replays.items()},
                      "launches_replayed": dict(trainer.launches), "launches_eager": eager}
        walls[name] = step_walls(trainer, batch)
        log(f"parallel {name} (mesh {mesh.shape}): fit replays {runs[name]['replays']}, "
            f"parameters vs no group {runs[name]['params']}, logs {gaps}")
        del trainer
    log(f"training micro-step, fp32, batch 16, replayed: median wall ms no group "
        f"{walls['none']['wall_ms_median']:.3f}, data group {walls['dp']['wall_ms_median']:.3f}, "
        f"tensor-parallel path {walls['tp']['wall_ms_median']:.3f}; busy ms a step "
        f"{walls['none']['busy_ms_per_step']} / {walls['dp']['busy_ms_per_step']} / "
        f"{walls['tp']['busy_ms_per_step']}; NCCL kernels a step "
        f"{walls['dp']['nccl_kernels_per_step']} / {walls['tp']['nccl_kernels_per_step']}, "
        f"NCCL ms {walls['dp']['nccl_ms_per_step']:.4f} / {walls['tp']['nccl_ms_per_step']:.4f}")
    return {"runs": runs, "walls": walls, "launches": total,
            "batches": 2 * ([("train", "fp32", b) for b in batch_iterator(train_ds, dcfg, epoch=0)]
                            + [("val", "fp32", b) for b in batch_iterator(
                                val_ds, dcfg, epoch=0, shuffle=False, drop_last=False)])}


def parallel_vocoder(dev, seed, root, hcfg):
    """One K = 4 graph of GAN steps at full width on a data group against a
    trainer without one, from the same seed and batches (metrics within the
    training bars, parameters within the drift bars); then a GAN step's
    median replayed wall with and without the group."""
    from matcha_tpu_torch.data.audio_dataset import AudioDataConfig, SyntheticWavDataset
    from matcha_tpu_torch.parallel import make_mesh
    from matcha_tpu_torch.train.vocoder import VocoderTrainConfig, VocoderTrainer

    dcfg = AudioDataConfig(batch_size=16)
    ds = SyntheticWavDataset(n_items=VOC_ITEMS, segment_size=dcfg.segment_size)
    out = {}
    for name, mesh in (("none", None), ("dp", make_mesh(model=None))):
        tr = VocoderTrainer(hcfg, VocoderTrainConfig(ckpt_dir=str(root / f"par_voc_{name}"),
                                                     seed=seed, steps_per_dispatch=4),
                            dcfg, device=dev, mesh=mesh)
        tr.init_optimizers(VOC_ITEMS // dcfg.batch_size)
        batches = list(tr._batches(ds, epoch=0))
        metrics = tr.dispatch(batches).clone()
        torch.cuda.synchronize()
        if tr.eager_steps or tr.replays != {4: 1}:
            raise AssertionError(f"vocoder {name}: {tr.eager_steps} eager steps, replays "
                                 f"{tr.replays}")
        params = [p.detach().clone() for p in tr.opt_g.params + tr.opt_d.params]
        walls = synced_walls(lambda: tr.dispatch(batches[:1]), 11)[1:]  # the first captures
        prof = profile_request(lambda: tr.dispatch(batches[:1]))
        out[name] = {"metrics": metrics, "params": params,
                     "wall_ms_median": float(np.median(walls)), "wall_ms": walls,
                     "busy_ms": prof.get("device_ms", "not measured"),
                     "nccl_ms": prof.get("by_group_ms", {}).get("nccl", 0.0)}
        del tr
    res = {"metrics": metric_gap(out["dp"]["metrics"], out["none"]["metrics"], "vocoder dp"),
           "params": param_gap(out["dp"]["params"], out["none"]["params"],
                               VocoderTrainConfig().lr),
           "walls": {n: {k: v for k, v in o.items() if k not in ("metrics", "params")}
                     for n, o in out.items()}}
    log(f"parallel vocoder K = 4 graph on a data group vs none: metrics {res['metrics']}, "
        f"parameters {res['params']}; GAN step median wall ms none "
        f"{out['none']['wall_ms_median']:.2f}, data group {out['dp']['wall_ms_median']:.2f}; busy "
        f"ms {out['none']['busy_ms']} / {out['dp']['busy_ms']}, NCCL ms {out['dp']['nccl_ms']}")
    return res


def parallel_serving(dev, mcfg, hcfg, seed):
    """`TTSEngine(mesh=)` over the one card against the engine without a mesh:
    the main path's requests (graphs warmed the same way), waveforms bit-equal
    and the same launches, counted between a reset and a read."""
    from matcha_tpu_torch.parallel import make_mesh
    from matcha_tpu_torch.serve import ServeConfig, TTSEngine

    msd, gsd = model_weights(mcfg, hcfg, seed)
    scfg = ServeConfig(bf16=True, vocoder="hifigan", output_dtype="int16")
    seeds = list(range(100, 100 + len(TEXTS)))
    runs = {}
    for name, kw in (("none", {"device": dev}), ("mesh", {"mesh": make_mesh(devices=[dev])})):
        engine = TTSEngine(msd, mcfg, scfg, gsd, hcfg, **kw)
        warm_engine(engine, [((len(TEXTS),), TEXTS[2]), ((1,), LONG_TEXT)])
        reset_serving_counts(engine)
        outs = serve_requests(engine, seeds)
        runs[name] = {"outs": outs, "launches": dict(engine.launches), "eager": wrapper_counts()}
        del engine
    (wa, ia, la, _), (wb, ib, lb, _) = runs["none"]["outs"], runs["mesh"]["outs"]
    equal = all(np.array_equal(a, b) for a, b in zip(wa + [la], wb + [lb]))
    if not equal or runs["none"]["launches"] != runs["mesh"]["launches"] \
            or any(runs["mesh"]["eager"].values()) or ia["budget"] != ib["budget"]:
        raise AssertionError(f"engine over a mesh of one card: waveforms equal {equal}, "
                             f"launches {runs['mesh']['launches']} (eager "
                             f"{runs['mesh']['eager']}) vs {runs['none']['launches']}")
    log(f"parallel serving: TTSEngine(mesh=) over one card, waveforms bit-equal to the engine "
        f"without a mesh, launches {runs['mesh']['launches']} (same)")
    return {"launches": runs["mesh"]["launches"], "bit_equal": equal,
            "requests": [("synthesise", len(TEXTS), ib["budget"], ib["mel_lengths"]),
                         ("lowlatency", 1, 1024, runs["mesh"]["outs"][3]["mel_lengths"])]}


def ring_inputs(b, t, dtype, dev, gen):
    q, k, v, bias = attention_inputs(b, 4, t, 64, dtype, dev, gen, [t - 37 * (i % 2)
                                                                     for i in range(b)])
    return q, k, v, bias


def parallel_ring(dev, seed):
    """`ring_attention` on NCCL at one rank, and the ring's per-rank computation
    (K1 block steps with lse, merged in f32) over T cut into 4 blocks for each
    of 4 ranks in this process, at the decoder's attention shapes of the
    512-frame budget, f32 and bf16, against K1 over the whole T (f32 1e-5, bf16
    2e-2). Returns the checks and the counted runs' launches by dtype and
    shape."""
    import torch.distributed as dist

    from matcha_tpu_torch.ops.attention import attention_cuda
    from matcha_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_local

    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    checks, shapes, total = {}, [], {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        atol, rtol = TOL[name]
        for b, t in PAR_RING:
            q, k, v, bias = ring_inputs(b, t, dtype, dev, gen)
            whole = attention_cuda(q, k, v, bias, 0.125)  # the reference, uncounted
            ring, counts = counting(lambda: ring_attention(q, k, v, bias, dist.group.WORLD, 0.125))
            add_counts(total, counts)
            shapes.append({"dtype": name, "shape": [b, 4, t, 64],
                           "launches": counts["attention_fwd"]})
            tl = t // PAR_BLOCKS
            cut = [tuple(a.narrow(-1 if a.dim() == 2 else 2, j * tl, tl).contiguous()
                         for a in (k, v, bias)) for j in range(PAR_BLOCKS)]

            def per_rank():
                return torch.cat([ring_attention_local(
                    q[:, :, r * tl:(r + 1) * tl].contiguous(),
                    [cut[(r - i) % PAR_BLOCKS] for i in range(PAR_BLOCKS)], 0.125)
                    for r in range(PAR_BLOCKS)], dim=2)

            blocks, counts = counting(per_rank)
            add_counts(total, counts)
            shapes.append({"dtype": name, "shape": [b, 4, tl, 64],
                           "launches": counts["attention_fwd"]})
            checks[f"{name} {[b, 4, t, 64]}"] = {
                "one_rank": max_err_within(ring, whole, atol, rtol, f"ring {name} {t}"),
                f"{PAR_BLOCKS}_blocks": max_err_within(blocks, whole, atol, rtol,
                                                       f"ring blocks {name} {t}")}
    log(f"parallel ring attention against K1 over the whole T: {checks}")
    return {"checks": checks, "shapes": shapes, "launches": total}


def parallel_decode(dev, mcfg, hcfg, seed):
    """`decode_fixed` with `seq_axis` over a one-rank NCCL mesh against
    `decode_fixed` at the 512-frame budget, the 4 texts, f32, 10 steps,
    the same z (TOL_SEQ_MEL). Returns the check and the counted launches."""
    from torch.distributed.device_mesh import init_device_mesh

    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.parallel import Mesh
    from matcha_tpu_torch.text import simple_text_to_sequence

    msd, _ = model_weights(mcfg, hcfg, seed)
    model = MatchaTTS(mcfg)
    model.load_state_dict(msd)
    model.eval().to(dev)
    seqs = [simple_text_to_sequence(t) for t in TEXTS]
    x = torch.zeros((len(seqs), max(map(len, seqs))), dtype=torch.int64)
    for i, s_ in enumerate(seqs):
        x[i, :len(s_)] = torch.tensor(s_)
    x, xl = x.to(dev), torch.tensor([len(s_) for s_ in seqs], device=dev)
    enc = model.encode_durations(x, xl)
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    z = torch.randn((len(seqs), PAR_DECODE_BUDGET, mcfg.n_feats), generator=gen, device=dev)
    want = model.decode_fixed(*enc, PAR_DECODE_BUDGET, ENTRY_STEPS, z=z)["mel"]
    mesh = Mesh(init_device_mesh("cuda", (1,), mesh_dim_names=("seq",)))
    with mesh:
        got, counts = counting(lambda: model.decode_fixed(*enc, PAR_DECODE_BUDGET, ENTRY_STEPS,
                                                          z=z, seq_axis="seq")["mel"])
    err = max_err_within(got, want, TOL_SEQ_MEL, TOL_SEQ_MEL, "seq-parallel decode mel")
    expect = ENTRY_STEPS * sum(n for n, _ in attention_shapes(mcfg.decoder, 1))
    if counts["attention_fwd"] != expect or counts["mrf_step"]:
        raise AssertionError(f"seq-parallel decode launches {counts}, expected K1 {expect}")
    log(f"parallel seq decode (one rank, NCCL) vs decode_fixed: mel max abs err {err:.3g}; "
        f"launches {counts}")
    return {"max_abs_err": err, "launches": counts, "batch": len(seqs)}


def parallel_bench_scaling(root):
    """`cli.bench_scaling --devices 1` as a user runs it (its ranks are its own
    processes, so their launches count toward no path here)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "matcha_tpu_torch.cli.bench_scaling",
                          "--devices", "1", "--out", str(root / "scaling.json")],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"bench_scaling failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    table = json.loads((root / "scaling.json").read_text())
    if [r["devices"] for r in table["results"]] != [1] or not table["results"][0][
            "utterances_per_s"] > 0:
        raise AssertionError(f"bench_scaling table {table}")
    log(f"bench_scaling --devices 1: {table['results']} ({time.perf_counter() - t0:.1f} s)")
    return table


def parallel_path(dev, mcfg, hcfg, seed, root):
    """The `parallel` phase: one rank on NCCL, at full width; every check
    raises. Its launches are those of the runs with a group, a mesh or a ring
    (the references' are not counted)."""
    res = {"join": join_one_rank(dev)}
    t0 = time.perf_counter()
    res["training"] = parallel_training(dev, mcfg, seed, root)
    res["vocoder"] = parallel_vocoder(dev, seed, root, hcfg)
    res["serving"] = parallel_serving(dev, mcfg, hcfg, seed)
    res["ring"] = parallel_ring(dev, seed)
    res["decode"] = parallel_decode(dev, mcfg, hcfg, seed)
    res["bench_scaling"] = parallel_bench_scaling(root)
    launches = {}
    for part in ("training", "serving", "ring", "decode"):
        add_counts(launches, res[part]["launches"])
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    log(f"parallel path launches {launches} in {res['seconds']:.1f} s")
    import torch.distributed as dist

    dist.destroy_process_group()  # the phase's group; no later phase needs one
    return res


def time_parallel_kernels(dev, mcfg, hcfg, seed, par, step_ns, reps=20):
    """Every shape the parallel path gave a kernel: the training runs' (K1,
    K4, MAS), the mesh engine's (K1, K2), and K1 with lse in the ring and the
    seq-parallel decode; each kernel against its plain version and timed."""
    rows = time_training_kernels(dev, mcfg, seed, par["training"]["batches"], step_ns, reps,
                                 path="parallel")
    for name, rs in time_kernels(dev, mcfg, hcfg, seed, par["serving"]["requests"],
                                 "parallel").items():
        rows.setdefault(name, []).extend(rs)
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    lse_shapes = {}
    for r in par["ring"]["shapes"]:
        key = (r["dtype"], tuple(r["shape"]))
        lse_shapes[key] = lse_shapes.get(key, 0) + r["launches"]
    dec = par["decode"]
    for n, t in attention_shapes(mcfg.decoder, PAR_DECODE_BUDGET):
        key = ("float32", (dec["batch"], mcfg.decoder.num_heads, t,
                           mcfg.decoder.attention_head_dim))
        lse_shapes[key] = lse_shapes.get(key, 0) + n * ENTRY_STEPS
    lse_rows = []
    for (name, (b, h, t, d)), count in lse_shapes.items():
        dtype = getattr(torch, name)
        q, k, v, bias = attention_inputs(b, h, t, d, dtype, dev, gen,
                                         [t - 37 * (i % 2) for i in range(b)])
        lse_rows.append({"path": "parallel", "dtype": name, "peak_flops": PEAK_FLOPS[dtype],
                         "shape": [b, h, t, d], "count": count, "launches": count, "lse": True,
                         **attention_fwd_row(q, k, v, bias, d ** -0.5, True, reps)})
    log_rows({"attention_fwd": lse_rows})
    rows["attention_fwd"].extend(lse_rows)
    return rows


# ---------------------------------------------------------------- phase 6
# ---------------------------------------------------------------- bench
BENCH_REPS = 10  # timed calls of a kernel row at the bench path's shapes
BENCH_SEED = 11  # the generator seed of the replay-against-eager checks
BENCH_KERNELS = ("attention_fwd", "attention_bwd", "mas", "mrf_step")


def bench_main_path(dev, mcfg, hcfg):
    """The bench's rows (`matcha_tpu_torch.bench`) on the card at the JAX
    bench's shapes, every count set to 0 just before and read just after:
    the headline (bf16 synthesis, batch 128) and the fp32 row (batch 64),
    MAS at both reference shapes, MAS inside the loss graph at batch 128,
    training at batch 128 bf16 (K = 1 and K = 8), the bf16 single-sentence
    HiFi-GAN latency at 50 steps, and the throughput serving row (256
    requests from 32 closed-loop clients, groups of up to 16). A row that
    raises fails the phase; so does a null value, an MFU that is not there, or
    a MAS path that differs from the C++ MAS. Returns (rows, the bench's
    record of its graphs and calls, the wrappers' ticks, seconds)."""
    from matcha_tpu_torch import bench

    shapes, record, peak = bench.SHAPES, [], bench.PEAK_FLOPS.get(torch.cuda.get_device_name(0))
    kw = {"device": dev, "mcfg": mcfg, "record": record}
    for w in bench.COUNTED.values():
        w.launches = 0
    t0 = time.perf_counter()
    rows = {}
    for name, batch, bf16 in (("headline", shapes["headline_batch"], True),
                              ("fp32", shapes["parity_batch"], False)):
        xrt, wall, audio, flops = bench.bench_synthesis(batch=batch, bf16=bf16, with_cost=True,
                                                        **kw)
        rows[name] = {"batch": batch, "bf16": bf16, "x_realtime": xrt, "wall_s": wall,
                      "audio_s": audio, "flops": flops,
                      "mfu": None if peak is None else flops / wall / peak}
    for b, tx, ty in shapes["mas"]:
        speedup, kernel_ms, cpp_ms, equal = bench.bench_mas(b, tx, ty, device=dev, record=record)
        rows[f"mas_{b}x{tx}x{ty}"] = {"kernel_ms": kernel_ms, "cpp_ms": cpp_ms,
                                      "speedup": speedup, "paths_equal": equal}
    rows["mas_fused_paths_equal"] = bench.mas_fused_check(shapes["fused_batch"], **kw)
    t1, tk, k, flops = bench.bench_train(batch=shapes["tuned_batch"], precision="bf16", iters=3,
                                         **kw)
    rows["train"] = {"batch": shapes["tuned_batch"], "precision": "bf16", "k": k,
                     "step_ms_k1": t1, "step_ms": tk, "flops": flops,
                     "mfu": None if peak is None else flops / (tk / 1e3) / peak,
                     "samples_per_s": shapes["tuned_batch"] / (tk / 1e3)}
    xrt, wall, audio = bench.bench_single_sentence_fused("hifigan", iters=3, hcfg=hcfg, **kw)
    rows["single_sentence_hifigan_fused_bf16"] = {"x_realtime": xrt, "wall_s": wall,
                                                  "audio_s": audio}
    eng = bench._full_size_engine(steps=10, mel_budgets=(256,), max_batch=16, device=dev,
                                  mcfg=mcfg, hcfg=hcfg)
    rows["serve_throughput"] = bench.bench_serve_latency(
        n_requests=256, threads=32, closed_loop=True, eng=eng, record=record)
    del eng
    seconds = time.perf_counter() - t0
    ticks = {name: w.launches for name, w in bench.COUNTED.items()}
    nulls = [f"{row}.{key}" for row, r in rows.items()
             for key, v in (r.items() if isinstance(r, dict) else [("", r)]) if v is None]
    unequal = [row for row, r in rows.items() if row.startswith("mas_")
               and (r is not True and not (isinstance(r, dict) and r["paths_equal"] is True))]
    if nulls or unequal:
        raise AssertionError(f"bench rows: null {nulls}, MAS paths unequal {unequal}")
    for row, r in rows.items():
        log(f"bench {row}: {json.dumps(r)}")
    return rows, record, ticks, seconds


def bench_accounting(record, dcfg, hcfg):
    """The bench path's launches, by kernel, from its record (the graph
    accounting: a graph's launches times its replays, the trainer's and the
    engines' sums, the eager MAS calls), and the same launches split by
    shape from each row's structure; the two must agree. Returns (launches,
    {shape key: launches})."""
    per_call = sum(n for n, _ in attention_shapes(dcfg, 1))  # K1 an estimator call
    counted = dict.fromkeys(BENCH_KERNELS, 0)
    shapes = {}

    def add(key, n):
        if n:
            shapes[key] = shapes.get(key, 0) + n

    def add_attention(dtype, b, frames, lengths, lse, calls, bwd=False):
        for n, t in attention_shapes(dcfg, frames):
            add(("attention_fwd", dtype, b, t, frames, tuple(lengths), lse), n * calls)
            if bwd:
                add(("attention_bwd", dtype, b, t, frames, tuple(lengths)), 2 * n * calls)

    for e in record:
        if "stages" in e:  # an engine: each stage's launches times its replays
            dtype = "bfloat16" if e["bf16"] else "float32"
            for st in e["stages"]:
                for name, n in st["launches"].items():
                    counted[name] += n * st["replays"]
                key = st["key"]
                if key[0] == "encode" or not st["replays"]:
                    continue
                b, budget = (key[1], key[3]) if key[0] == "decode" else (1, key[2])
                steps = st["launches"]["attention_fwd"] // per_call
                add_attention(dtype, b, budget, [budget] * b, False, steps * st["replays"])
                if e["vocoder"] == "hifigan":
                    for c, t, k, d in mrf_shapes(hcfg, budget):
                        add(("mrf_step", dtype, b, c, t, k, d), st["replays"])
            continue
        for name, n in e["launches"].items():
            counted[name] += n * e.get("replays", 1)
        if e["row"] == "synthesis":
            add_attention("bfloat16" if e["bf16"] else "float32", e["batch"], e["ty"],
                      e["mel_lengths"], False, e["n_timesteps"] * e["replays"])
        elif e["row"] == "mas_fused":
            b, tx, ty = e["shape"]
            add(("mas", tx, ty, tuple(e["x_lengths"]), tuple(e["y_lengths"])), e["replays"])
            add_attention("float32", b, ty, e["y_lengths"], False, e["replays"])
        elif e["row"] == "mas":
            add(("mas_problem",) + tuple(e["shape"]), e["launches"]["mas"])
        elif e["row"] == "train":
            b, tx, ty, steps = e["batch"], e["tx"], e["ty"], e["micro_steps"]
            add(("mas", tx, ty, (tx,) * b, (ty,) * b), steps)
            add_attention("bfloat16" if e["precision"] == "bf16" else "float32", b, ty, [ty] * b,
                      True, steps, bwd=True)
        else:
            raise AssertionError(f"bench record: no accounting for a {e['row']!r} row")
    by_kernel = {name: sum(n for key, n in shapes.items()
                           if key[0] == name or (name == "mas" and key[0] == "mas_problem"))
                 for name in BENCH_KERNELS}
    if by_kernel != counted or not all(counted.values()):
        raise AssertionError(f"bench path: graph accounting {counted}, by shape {by_kernel}; "
                             f"every kernel must launch")
    return counted, shapes


def time_bench_kernels(dev, mcfg, hcfg, seed, shapes, step_ns, reps=BENCH_REPS, path="bench"):
    """Every kernel at every shape a path gave it (`shapes`, keyed as
    `bench_accounting` keys them): held against its plain version and timed
    beside it, the library call and the bound, as `path`."""
    from matcha_tpu_torch.cli import bench_mas
    from matcha_tpu_torch.ops import mas

    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    h, d = mcfg.decoder.num_heads, mcfg.decoder.attention_head_dim
    rows = {name: [] for name in BENCH_KERNELS}
    for key, n in shapes.items():
        kind = key[0]
        if kind in ("mas", "mas_problem"):
            if kind == "mas":
                value, mask, t_x, t_y = mas_batch_inputs(key[1:], dev, gen)
            else:
                value, mask = (torch.from_numpy(a).to(dev)
                               for a in bench_mas.make_problem(*key[1:]))
                t_x, t_y = mas.lengths_from_mask(mask)
            rows["mas"].append(dict({"path": path, "dtype": "float32",
                                     "peak_flops": PEAK_F32_FLOPS, "shape": list(value.shape),
                                     "count": n, "launches": n},
                                    **mas_row(value, mask, t_x, t_y, step_ns, reps)))
            continue
        dtype_name = key[1]
        dtype = getattr(torch, dtype_name)
        common = {"path": path, "dtype": dtype_name, "peak_flops": PEAK_FLOPS[dtype]}
        if kind == "mrf_step":
            b, c, t, k, dil = key[2:]
            rows["mrf_step"].append(dict(common, shape=[b, c, t], k=k, d=dil, count=n,
                                         launches=n, **mrf_row(b, c, t, k, dil, dtype, dev, gen,
                                                               reps, path)))
            continue
        b, t, frames, lengths = key[2:6]
        q, k_, v, bias = attention_inputs(b, h, t, d, dtype, dev, gen, list(lengths), frames)
        if kind == "attention_fwd":
            rows[kind].append(dict(common, shape=[b, h, t, d], count=n, launches=n, lse=key[6],
                                   **attention_fwd_row(q, k_, v, bias, d ** -0.5, key[6], reps)))
        else:
            rows[kind].append(dict(common, shape=[b, h, t, d], count=n // 2, launches=n,
                                   **attention_bwd_row(q, k_, v, bias, d ** -0.5, gen, reps)))
    log_rows(rows)
    return rows


def bench_synthesis_checks(dev, mcfg):
    """The headline's graph against the same calls made eagerly: a replay of
    the batch-128 bf16 `synthesise_fixed` graph against an eager call drawing
    the same noise (bit-equal, or within 1e-6 of the largest |mel|); one
    replay under the profiler, whose K1 kernels equal the graph's accounting
    (60 a 10-step synthesis) with no wrapper ticking; and in float32, row 0
    of a batch-128 replay against a batch-1 call on the same text and noise
    (the card-vs-CPU mel bar): a row does not depend on its batch mates."""
    from matcha_tpu_torch import bench

    shapes, res = bench.SHAPES, {}
    b, tx, ty, steps = shapes["headline_batch"], shapes["tx"], shapes["ty"], 10
    want_k1 = steps * sum(n for n, _ in attention_shapes(mcfg.decoder, 1))
    for bf16 in (True, False):
        model, x, xl, gen, stage = bench.make_synthesis(b, tx, ty, steps, bf16, dev, mcfg)
        name = "bf16" if bf16 else "fp32"
        want = {"attention_fwd": want_k1, "attention_bwd": 0, "mas": 0, "mrf_step": 0}
        if stage.launches != want:
            raise AssertionError(f"{name} synthesis graph: {stage.launches} a replay, "
                                 f"expected {want}")
        gen.manual_seed(BENCH_SEED)
        got = stage.run(x, xl)[0].clone()
        if bf16:
            gen.manual_seed(BENCH_SEED)
            with torch.no_grad():
                eager = model.synthesise_fixed(x, xl, ty, steps, generator=gen)["mel"]
            gap = float((got.float() - eager.float()).abs().max())
            rel = gap / float(eager.float().abs().max())
            equal = bool(torch.equal(got, eager))
            if not equal and rel > 1e-6:
                raise AssertionError(f"bf16 synthesis replay vs eager: {rel:.3g} of max |mel|")
            ticks = wrapper_counts_all()
            prof = profile_request(lambda: stage.run(x, xl))
            seen = prof.get("launches_by_group", {}).get("K1 attention_fwd", 0)
            if seen != want_k1 or wrapper_counts_all() != ticks:
                raise AssertionError(f"a synthesis replay ran {seen} K1 kernels by the profiler, "
                                     f"{want_k1} by the graph accounting; wrappers "
                                     f"{ticks} -> {wrapper_counts_all()}")
            res["bf16_replay_vs_eager"] = {"bit_equal": equal, "max_abs_gap": gap,
                                           "rel_gap": rel, "bar_rel": 1e-6}
            res["profile"] = prof
            log(f"bench bf16 synthesis at batch {b}: replay vs eager bit-equal {equal}, gap "
                f"{rel:.3g} of max |mel| (bar 1e-6); one replay: K1 {seen} by the profiler = "
                f"{want_k1} by the graph accounting, busy {prof['device_ms']:.2f} of "
                f"{prof['wall_ms']:.2f} ms, {prof['kernel_launches']} kernels")
        else:
            gen.manual_seed(BENCH_SEED)
            z = torch.randn((b, mcfg.n_feats, ty), generator=gen, device=dev)  # sample_cfm's draw
            with torch.no_grad():
                one = model.synthesise_fixed(x[:1], xl[:1], ty, steps,
                                             z=z[:1].transpose(1, 2))["mel"]
            err = max_err_within(got[:1], one, TOL_MEL, 0.0,
                                 f"f32 synthesis row 0 at batch {b} vs batch 1")
            res["fp32_row0_vs_batch1"] = {"max_abs_err": err, "bar": TOL_MEL}
            log(f"bench f32 synthesis: row 0 of batch {b} vs a batch-1 call, same text and z: "
                f"{err:.3g} (bar {TOL_MEL})")
        del model, stage
    return res


def wrapper_counts_all():
    from matcha_tpu_torch import bench

    return {name: w.launches for name, w in bench.COUNTED.items()}


def bench_path(dev, mcfg, hcfg, seed, step_ns):
    """The bench phase: its rows (`bench_main_path`), their launches by the
    graph accounting split by shape (`bench_accounting`), the checks of the
    headline's graph (`bench_synthesis_checks`), K1 and K4 a call at
    (128, 4, 512, 64) in both dtypes, and every kernel at every shape the
    rows gave it (path "bench")."""
    rows, record, ticks, seconds = bench_main_path(dev, mcfg, hcfg)
    launches, shapes = bench_accounting(record, mcfg.decoder, hcfg)
    log(f"bench path: {seconds:.1f} s of rows; launches {launches} (graph replays and eager "
        f"MAS calls), wrappers ticked {ticks} (captures, warm-ups, eager calls)")
    checks = bench_synthesis_checks(dev, mcfg)
    per_call = time_attention_per_call(dev, seed, BENCH_REPS, shapes=((128, 512),))
    kernel_rows = time_bench_kernels(dev, mcfg, hcfg, seed, shapes, step_ns)
    return {"rows": rows, "record": record, "launches": launches, "wrapper_ticks": ticks,
            "rows_s": seconds, "checks": checks, "per_call": per_call,
            "kernel_rows": kernel_rows}


# ---------------------------------------------------------------- tools
# the sweep's children run here, each against `base`, the bench phase's own
# `bench_train` at batch 128 bf16 (the call `base` makes): its first losses, relative bars
TOOLS_SWEEP_BARS = {"remat_dots": 1e-6, "cudnn_benchmark": 1e-3}
TOOLS_VOC = (8, 256)  # profile_vocoder's batch and mel frames
TOOLS_REPS = 5  # timed calls of a kernel row at the tools' shapes


@contextlib.contextmanager
def printed():
    """A buffer holding what the block prints, which is printed after it."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield buf
    finally:
        print(buf.getvalue(), end="", flush=True)


@contextlib.contextmanager
def plain_mrf():
    """The generator's MRF steps through K2's plain version, on any device."""
    from matcha_tpu_torch.models import hifigan
    from matcha_tpu_torch.ops.mrf import mrf_step_plain

    kernel = hifigan.mrf_step
    hifigan.mrf_step = lambda x, w1, b1, w2, b2, d, packed=None: mrf_step_plain(x, w1, b1, w2,
                                                                                 b2, d)
    try:
        yield
    finally:
        hifigan.mrf_step = kernel


def trace_train_step_run(dev, mcfg, root):
    """`cli.trace_train_step` at batch 128, K 8, bf16, with attribution: the
    traced device ms a dispatch within 0.8-1.05 of the synchronised wall of
    the same dispatches; launches by the graph accounting (4 dispatches of 8
    replayed, two eager micro-steps) and, for the traced replays, by the
    profiler's kernel names; every FFT-group kernel of the eager step on an
    op with shapes; what it printed agrees."""
    from matcha_tpu_torch.cli import trace_train_step

    with printed() as out:
        res = trace_train_step.main([str(root / "trace_train_step"), "--eager-attribution"])
    text, k = out.getvalue(), res["k"]
    per_dispatch, wall = res["ms_per_dispatch"], res["wall_ms_per_dispatch"]
    if f"device {per_dispatch:.1f} ms/dispatch" not in text or "by layer" not in text:
        raise AssertionError("trace_train_step did not print its device ms and its attribution")
    ratio = per_dispatch / wall
    if not 0.8 <= ratio <= 1.05:
        raise AssertionError(f"trace_train_step: device {per_dispatch:.2f} ms a dispatch over a "
                             f"synchronised wall of {wall:.2f} ms: {ratio:.3f}, outside 0.8-1.05")
    step = per_micro_step(mcfg)
    want = {n: (4 * k + 2) * c for n, c in step.items()}
    traced = {n: res["kernels_per_dispatch_by_group"].get(g, 0) for n, g in
              (("attention_fwd", "K1 attention_fwd"), ("attention_bwd", "K4 attention_bwd"),
               ("mas", "K3a+K3b mas"))}
    if res["launches"] != want or traced != {n: k * c for n, c in step.items()} \
            or res["eager_launches"] != {n: 2 * c for n, c in step.items()}:
        raise AssertionError(f"trace_train_step launches {res['launches']} (eager "
                             f"{res['eager_launches']}), expected {want}; the profiler saw "
                             f"{traced} a replayed dispatch")
    att = res["attribution"]
    if att["fft_without_shapes"]:
        raise AssertionError(f"{att['fft_without_shapes']} FFT-group kernels of the eager step "
                             f"are on no op with shapes")
    fft_rows = [r for r in att["rows"] if r["fft_kernels"]]
    for title, rows in (("heaviest", att["rows"]), ("heaviest with FFT kernels", fft_rows)):
        for r in rows[:3]:
            log(f"trace_train_step {title}: {r['ms']:.3f} ms ({r['fft_ms']:.3f} FFT) "
                f"{r['pass']} {r['module']} | {r['op']} | {r['shapes']}")
    log(f"trace_train_step: device {per_dispatch:.2f} ms a dispatch of {k} over a synchronised "
        f"wall of {wall:.2f} ms ({ratio:.3f}); eager step {att['total_ms']:.2f} ms, FFT "
        f"{att['fft_ms']:.2f} ms in {len(fft_rows)} rows; kernels only eager "
        f"{len(res['only_eager'])}, only replayed {len(res['only_replay'])}")
    return {k_: v for k_, v in res.items() if k_ != "top_kernels"} | {
        "ratio": ratio, "attribution_top": att["rows"][:40], "fft_rows": fft_rows,
        "attribution": {k_: v for k_, v in att.items() if k_ != "rows"}}


def profile_vocoder_run(dev, hcfg, root):
    """`cli.profile_vocoder` at 8 x 256 in bf16 and f32: K2 36 a replay by the
    graph's accounting and by the profiler's kernel names over the 4 traced
    replays; the graph's output against the generator through K2's plain
    version on the same mel, at K2's bars for the dtype."""
    from matcha_tpu_torch.cli import profile_vocoder

    batch, frames = TOOLS_VOC
    per = len(mrf_shapes(hcfg, 1))
    res = {}
    for name, flag in (("bfloat16", ["--bf16"]), ("float32", [])):
        with printed() as out:
            r = profile_vocoder.main(["--batch", str(batch), "--frames", str(frames),
                                      "--trace-dir", str(root / f"voc_{name}")] + flag)
        traced = r["kernels_by_group"].get("K2 mrf_step", 0)
        if "up=conv_transpose res=K2" not in out.getvalue() \
                or r["launches"].get("mrf_step") != per or traced != per * profile_vocoder.TRACED:
            raise AssertionError(f"profile_vocoder {name}: K2 {r['launches']} a replay by the "
                                 f"graph, {traced} kernels in {profile_vocoder.TRACED} traced "
                                 f"replays; expected {per} a replay")
        with plain_mrf(), torch.no_grad():
            ref = r["generator"](r["mel"])
        atol, rtol = TOL_MRF_F32 if name == "float32" else TOL["bfloat16"]
        err = max_err_within(r["out"], ref, atol, rtol,
                             f"profile_vocoder {name} graph vs the plain MRF path")
        res[name] = {"wall_ms": r["wall_ms"], "total_ms": r["total_ms"], "replays": r["replays"],
                     "launches_per_replay": r["launches"], "by_group_ms": r["by_group"],
                     "kernels_by_group": r["kernels_by_group"],
                     "top_kernels_ms": dict(sorted(r["by_kernel"].items(),
                                                   key=lambda kv: -kv[1])[:25]),
                     "max_abs_err": err, "bar": {"atol": atol, "rtol": rtol}}
        log(f"profile_vocoder {name} at {batch} x {frames}: {r['wall_ms']:.2f} ms wall, "
            f"{r['total_ms']:.2f} device ms over {profile_vocoder.TRACED} replays; K2 {per} a "
            f"replay by the graph and {traced} traced; vs the plain path {err:.3g} (atol {atol}, "
            f"rtol {rtol})")
        del r, ref
    return res


def sweep_run(mcfg, root, base):
    """`cli.train_mfu_sweep`'s `remat_dots` and `cudnn_benchmark` children at
    --iters 2: every row without an error or a null, its graphs' launches
    those of its micro-steps, and its first dispatch's losses against
    `base`'s (the first metrics of the bench phase's `bench_train` at batch
    128 bf16, the `base` variant's call) within `TOOLS_SWEEP_BARS`, the gap
    reported."""
    from matcha_tpu_torch.cli import train_mfu_sweep

    gc.collect()
    torch.cuda.empty_cache()  # the children share the card with this process
    with printed() as out:
        sweep = train_mfu_sweep.main(["--only", ",".join(TOOLS_SWEEP_BARS), "--iters", "2",
                                      "--out", str(root / "train_mfu_sweep.json")])
    rows = {r["variant"]: r for r in sweep["rows"]}
    errors = {n: r["error"] for n, r in rows.items() if "error" in r}
    nulls = [f"{n}.{key}" for n, r in rows.items() for key in
             ("train_step_ms_k1", "train_step_ms_k8", "step_flops", "mfu_k8", "samples_per_s_k8",
              "first_metrics") if r.get(key) is None]
    if errors or nulls or f'"n_rows": {len(TOOLS_SWEEP_BARS)}' not in out.getvalue():
        raise AssertionError(f"train_mfu_sweep: errors {errors}, nulls {nulls}")
    for n, r in rows.items():
        want = {k: r["micro_steps"] * c
                for k, c in per_micro_step(mcfg, train_mfu_sweep.VARIANTS[n].get("remat")).items()}
        if r["launches"] != want:
            raise AssertionError(f"sweep {n}: launches {r['launches']}, expected {want} for "
                                 f"{r['micro_steps']} replayed micro-steps")
    gaps = {}
    for n, bar in TOOLS_SWEEP_BARS.items():
        got = rows[n]["first_metrics"]
        gaps[n] = max(abs(got[k] - base[k]) / abs(base[k]) for k in ("dur_loss", "prior_loss",
                                                                      "diff_loss", "loss"))
        if gaps[n] > bar:
            raise AssertionError(f"sweep {n}: first losses {got} vs base {base}: {gaps[n]:.3g} "
                                 f"relative, over {bar}")
    for n, r in rows.items():
        log(f"sweep {n}: K1 {r['train_step_ms_k1']:.2f} ms, K8 {r['train_step_ms_k8']:.2f} ms a "
            f"micro-step, MFU {r['mfu_k8']:.4f}, {r['samples_per_s_k8']:.1f} samples/s; first "
            f"losses vs base {gaps[n]:.3g} relative; clocks {r['clocks_before']} -> "
            f"{r['clocks_after']}; {r['wall_s']:.1f} s ({r['child_s']:.1f} s in the child)")
    return {"rows": sweep["rows"], "base_first_metrics": base, "gaps": gaps,
            "bars": TOOLS_SWEEP_BARS}


def tools_accounting(mcfg, hcfg, trace_res, voc):
    """The tools path's launches by kernel (trace_train_step's replays and
    eager steps, profile_vocoder's replays) and the same split by shape, keyed
    as `bench_accounting` keys them."""
    dcfg, shapes = mcfg.decoder, {}
    b, tx, ty = trace_res["batch"], trace_res["tx"], trace_res["ty"]
    steps = trace_res["launches"]["mas"]  # one MAS a micro-step
    shapes[("mas", tx, ty, (tx,) * b, (ty,) * b)] = steps
    for n, t in attention_shapes(dcfg, ty):
        shapes[("attention_fwd", "bfloat16", b, t, ty, (ty,) * b, True)] = n * steps
        shapes[("attention_bwd", "bfloat16", b, t, ty, (ty,) * b)] = 2 * n * steps
    vb, frames = TOOLS_VOC
    for dtype, r in voc.items():
        for c, t, k, d in mrf_shapes(hcfg, frames):
            key = ("mrf_step", dtype, vb, c, t, k, d)
            shapes[key] = shapes.get(key, 0) + r["replays"]
    launches = dict(trace_res["launches"],
                    mrf_step=sum(r["launches_per_replay"]["mrf_step"] * r["replays"]
                                 for r in voc.values()))
    by_kernel = {name: sum(n for key, n in shapes.items() if key[0] == name)
                 for name in BENCH_KERNELS}
    if by_kernel != launches:
        raise AssertionError(f"tools path: launches {launches}, by shape {by_kernel}")
    return launches, shapes


def tools_path(dev, mcfg, hcfg, seed, root, step_ns, base):
    """The tools phase: `cli.trace_train_step`, `cli.profile_vocoder` and
    `cli.train_mfu_sweep` as a user runs them (the counts set to 0 just
    before and read just after; the sweep's children against `base`, the
    first metrics of the `base` variant's call), then every kernel at every
    shape the in-process tools gave it, as path "tools"."""
    from matcha_tpu_torch import bench

    for w in bench.COUNTED.values():
        w.launches = 0
    t0 = time.perf_counter()
    trace_res = trace_train_step_run(dev, mcfg, root)
    voc = profile_vocoder_run(dev, hcfg, root)
    sweep = sweep_run(mcfg, root, base)
    ticks = wrapper_counts_all()
    seconds = time.perf_counter() - t0
    launches, shapes = tools_accounting(mcfg, hcfg, trace_res, voc)
    kernel_rows = time_bench_kernels(dev, mcfg, hcfg, seed, shapes, step_ns, TOOLS_REPS, "tools")
    log(f"tools path: {seconds:.1f} s of tools, {time.perf_counter() - t0:.1f} s with the kernel "
        f"rows; launches {launches} (graph replays and the eager micro-step), wrappers ticked "
        f"{ticks}")
    return {"trace_train_step": trace_res, "profile_vocoder": voc, "sweep": sweep,
            "launches": launches, "wrapper_ticks": ticks, "tools_s": seconds,
            "kernel_rows": kernel_rows}


def main_path_requests(engine):
    """(name, batch, budget, mel lengths) of the two decodes the main path ran."""
    syn, ll = engine["synthesise"], engine["lowlatency"]
    return [("synthesise", len(syn["mel_lengths"]), syn["budget"], syn["mel_lengths"]),
            ("lowlatency", 1, ll["budget"], ll["mel_lengths"])]


def time_kernels(dev, mcfg, hcfg, seed, requests, path="serve", dtype=torch.bfloat16,
                 n_timesteps=10, reps=20, vocoder_calls=1):
    """At every shape a serving path gave K1 and K2 (K1 only with a Matcha
    `mcfg`, K2 only with a HiFi-GAN `hcfg`, run `vocoder_calls` times at each
    request's shapes): the kernel against its plain version, then per-launch
    kernel, plain and library times and each launch's bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    name = str(dtype).split(".")[1]
    common = {"path": path, "dtype": name, "peak_flops": PEAK_FLOPS[dtype]}
    rows = {"attention_fwd": [], "mrf_step": []}
    # a request: (name, batch, frame budget, mel lengths[, frames the vocoder ran on,
    # when that is not the budget])
    for req, b, budget, mel_lengths, *voc in requests:
        for count, t in attention_shapes(mcfg.decoder, budget) if mcfg is not None else []:
            h, d = mcfg.decoder.num_heads, mcfg.decoder.attention_head_dim
            q, k, v, bias = attention_inputs(b, h, t, d, dtype, dev, gen, mel_lengths, budget)
            rows["attention_fwd"].append({
                **common, "request": req, "shape": [b, h, t, d], "count": count * n_timesteps,
                "launches": count * n_timesteps, "lse": False,
                **attention_fwd_row(q, k, v, bias, d ** -0.5, False, reps)})
        for c, t, k, dil in (mrf_shapes(hcfg, voc[0] if voc else budget)
                             if hcfg is not None else []):
            rows["mrf_step"].append({
                **common, "request": req, "shape": [b, c, t], "k": k, "d": dil,
                "count": vocoder_calls, "launches": vocoder_calls,
                **mrf_row(b, c, t, k, dil, dtype, dev, gen, reps, req)})
    log_rows(rows)
    for kernel, rs in rows.items():
        if rs:
            log(f"{kernel} {name} at the {path} path's shapes: max abs err "
                f"{max(r['max_abs_err'] for r in rs):.3g}")
    return rows


def mrf_row(b, c, t, k, dil, dtype, dev, gen, reps, what):
    """K2 at one (B, C, T, k, d) on random inputs: held against its plain
    version, then timed beside it and the unfused PyTorch sequence; the
    work, and the launch's tile plan (its shared memory is dynamic, so ptxas
    does not show it)."""
    from matcha_tpu_torch.ops.mrf import mrf_plan, mrf_step_cuda, mrf_step_plain, pack_weights

    name = str(dtype).split(".")[1]
    elt = torch.tensor([], dtype=dtype).element_size()
    atol, rtol = TOL_MRF_F32 if dtype == torch.float32 else TOL[name]
    args = mrf_inputs(b, c, t, k, dtype, dev, gen)
    packed = pack_weights(args[1], args[3])  # once, as ResBlock1 packs its weights
    err = max_err_within(mrf_step_cuda(*args, dil, packed), mrf_step_plain(*args, dil),
                         atol, rtol, f"K2 {name} {what} {[b, c, t]} k={k} d={dil}")
    flops, nbytes = mrf_work(b, c, t, k, elt)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"max_abs_err": err, "flops": flops, "bytes": nbytes,
            "ms": cuda_ms(lambda: mrf_step_cuda(*args, dil, packed), reps),
            "plain_ms": cuda_ms(lambda: mrf_step_plain(*args, dil), reps),
            "unfused_ms": cuda_ms(lambda: mrf_step_unfused(*args, dil), reps),
            "library_ms": None, "plan": mrf_plan(b, c, t, k, dil, elt, sms).__dict__}


def log_rows(rows):
    """Set each row's bound and log it: time a call, plain, library, bound
    (the larger of operations, bytes and, for MAS, the chain of frames)."""
    for name, rs in rows.items():
        for r in rs:
            parts = {"operations": r["flops"] / r["peak_flops"] * 1e3,
                     "bytes": r["bytes"] / PEAK_BYTES * 1e3, "chain": r.get("chain_ms", 0.0)}
            r["bound_by"] = max(parts, key=parts.get)
            r["bound_ms"] = parts[r["bound_by"]]
            lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f}"
            if "unfused_ms" in r:
                lib += f", unfused {r['unfused_ms']:.4f}"
            kd = f" k={r['k']} d={r['d']}" if "k" in r else ""
            plan = f", plan {r['plan']}" if "plan" in r else ""
            log(f"{name} {r['path']} {r.get('request', '')} {r['dtype']} {r['shape']}{kd} "
                f"x{r['count']}: {r['ms']:.4f} ms a call, plain {r['plain_ms']:.4f}{lib}, "
                f"bound {r['bound_ms']:.5f} ({r['bound_by']}), max abs err "
                f"{r['max_abs_err']:.3g}{plan}")


SOURCES = {
    "attention_fwd": ("matcha_tpu_torch/csrc/attention_fwd.cu",
                      "matcha_tpu/ops/attention_pallas.py:39"),
    "mrf_step": ("matcha_tpu_torch/csrc/mrf_step.cu", "matcha_tpu/ops/mrf_pallas.py:44"),
    "mas": ("matcha_tpu_torch/csrc/mas.cu",
            "matcha_tpu/ops/mas_pallas.py:37 and matcha_tpu/ops/mas_pallas.py:78"),
    "attention_bwd": ("matcha_tpu_torch/csrc/attention_bwd.cu",
                      "matcha_tpu/ops/attention_pallas.py:87"),
}


def kernel_line(rows, errs, launches, work):
    """The `kernels` JSON object: each kernel's times and bound summed over the
    launches its paths made, which are the ones its `launches` counts.

    rows: kernel -> timed rows, each with its path, `count` calls and the
    `launches` they make; launches: path -> kernel -> count read after that path;
    work: path -> what the path ran. The bound is the largest of its parts
    (`bound_parts_ms`): operations, bytes, and for MAS the chain of frames.
    """
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        rs = rows[name]

        def total(key):
            return sum(r["count"] * r[key] for r in rs)

        by_path = {}
        for path, counts in launches.items():
            timed = sum(r["launches"] for r in rs if r["path"] == path)
            if timed != counts.get(name, 0):
                raise AssertionError(f"{name}: timed {timed} launches on the {path} path, "
                                     f"which made {counts.get(name, 0)}")
            if timed:
                by_path[path] = timed
        parts = {"operations": sum(r["count"] * r["flops"] / r["peak_flops"] for r in rs) * 1e3,
                 "bytes": total("bytes") / PEAK_BYTES * 1e3,
                 "chain": sum(r["count"] * r.get("chain_ms", 0.0) for r in rs)}
        bound_by = max(parts, key=parts.get)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()),
            "max_abs_err": max([e["max_abs_err"] for e in errs.get(name, {}).values()]
                               + [r["max_abs_err"] for r in rs]),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": parts[bound_by], "bound_by": bound_by, "bound_parts_ms": parts,
            "library_ms": None if any(r["library_ms"] is None for r in rs) else total("library_ms"),
            **({"unfused_ms": total("unfused_ms")}
               if rs and all("unfused_ms" in r for r in rs) else {}),
            "launches_by_path": by_path,
            "work": "; ".join(f"{path}: {work[path]}" for path in by_path)})
    return {"kernels": kernels}


def kernel_name(mangled):
    """A kernel's name from its mangled entry, with its template arguments
    (element type and integers): the length-prefixed identifier ending in
    `_kernel`."""
    for m in re.finditer(r"_kernel", mangled):
        end = m.end()
        for start in range(end - 1, 0, -1):  # the digits before the identifier give its length
            digits = re.search(r"\d+$", mangled[:start])
            if digits and digits.group().endswith(str(end - start)):
                ident, rest = mangled[start:end], mangled[end:]
                if not rest.startswith("I"):
                    return ident
                dtype = re.match(r"I(f|13__nv_bfloat16)?", rest).group(1)
                targs = ([{"f": "float", "13__nv_bfloat16": "bf16"}[dtype]] if dtype else []) \
                    + re.findall(r"Li(\d+)E", rest.split("EE", 1)[0] + "E")
                return f"{ident}<{', '.join(targs)}>"
    return mangled


def kernel_resources(build_log):
    """[(kernel, ptxas's registers and shared memory line)] from an `nvcc
    -Xptxas -v` log, with ptxas's spill lines."""
    out, kernel = [], "?"
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = kernel_name(entry.group(1))
        elif "Used" in line or "spill" in line:
            out.append((kernel, line.split(":", 1)[-1].strip()))
    return out


def setup_card():
    """A run's set-up on the card: float32 plain versions in full float32
    (cuDNN would take TF32 by default), the card's name and power limit and
    the versions printed, every kernel built and ptxas's resources printed.
    Returns (device, the nvidia-smi line, build seconds, kernel names)."""
    from matcha_tpu_torch import apply_tf32_policy
    from matcha_tpu_torch.ops import _build

    apply_tf32_policy()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {built} in {build_s:.1f} s")
    for name in built:
        for kernel, used in kernel_resources(_build.build_log(name)):
            log(f"  {name} {kernel}: {used}")
    return dev, smi, build_s, built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port on one card.")
    ap.add_argument("--seed", type=int, default=0, help="seed of weights, inputs and noise")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "chip_smoke.json",
                    help="where the detailed results go (JSON)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "matcha_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no matcha_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from matcha_tpu_torch.models.hifigan import HiFiGANConfig
    from matcha_tpu_torch.models.matcha import MatchaConfig
    from matcha_tpu_torch.train.trainer import METRICS

    dev, smi, build_s, _ = setup_card()
    mcfg, hcfg = MatchaConfig(), HiFiGANConfig()  # full width: Matcha-TTS and HiFi-GAN v1
    errs = check_kernels(dev, args.seed)
    errs.update(check_training_kernels(dev, args.seed))
    mas_profile = profile_mas_call(dev, args.seed)
    step_ns = chain_step_ns(dev)
    log(f"MAS chain step L = {step_ns:.3f} ns (one thread: max, add; "
        f"slope of the probe at 50,000 and 100,000 steps) on {smi}")
    engine = serve_main_path(dev, mcfg, hcfg, args.seed)
    log({"engine": engine})
    engine_gl = serve_griffin_lim(dev, mcfg, args.seed)
    log({"engine_griffin_lim": engine_gl})
    serve16 = serve_batch16(dev, mcfg, hcfg, args.seed)
    ffn = ffn_variants_on_card(dev, mcfg, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        training = train_main_path(dev, mcfg, args.seed, Path(tmp))
        train_graphs = train_graph_checks(dev, mcfg, args.seed, Path(tmp))
        vocoder = vocoder_train_path(dev, mcfg, args.seed, Path(tmp), hcfg)
        entry = entry_points(dev, mcfg, hcfg, args.seed, Path(tmp))
        examples = demos(dev, args.seed, Path(tmp))
        par = parallel_path(dev, mcfg, hcfg, args.seed, Path(tmp))
        e2e = {"card_vs_cpu": card_vs_cpu(dev, mcfg, hcfg, args.seed),
               "golden": golden_on_card(dev),
               "train_card_vs_cpu": train_card_vs_cpu(dev, mcfg, args.seed)}
        requests = main_path_requests(engine)
        rows = time_kernels(dev, mcfg, hcfg, args.seed, requests)
        requests16 = [("synthesise", len(serve16["mel_lengths"]), serve16["budget"],
                       serve16["mel_lengths"])]
        for name, rs in time_kernels(dev, mcfg, hcfg, args.seed, requests16, "serve16").items():
            rows[name].extend(rs)
        requests_gl = main_path_requests(engine_gl)
        for name, rs in time_kernels(dev, mcfg, None, args.seed, requests_gl, "serve_gl",
                                     torch.float32).items():
            rows[name].extend(rs)
        for name, rs in time_training_kernels(dev, mcfg, args.seed, training_batches(mcfg),
                                              step_ns).items():
            rows.setdefault(name, []).extend(rs)
        for dtype, requests_voc in vocoder["requests"].items():
            for name, rs in time_kernels(dev, mcfg, hcfg, args.seed, requests_voc, "vocoder",
                                         getattr(torch, dtype)).items():
                rows[name].extend(rs)
        generated = entry["generate"]
        for path, hc, run in (("generate", hcfg, generated["hifigan"]),
                              ("generate_gl", None, generated["griffin_lim"])):
            request = ("generate", 1, run["budget"], [run["frames"]], run["frames"])
            for name, rs in time_kernels(dev, mcfg, hc, args.seed, [request], path,
                                         torch.float32).items():
                rows[name].extend(rs)
        report = entry["vocoder_report"]
        for frames in sorted(set(report["frames"])):
            request = ("vocoder_report", 1, frames, [frames], frames)
            for name, rs in time_kernels(dev, None, hcfg, args.seed, [request], "vocoder_report",
                                         torch.float32,
                                         vocoder_calls=report["frames"].count(frames)).items():
                rows[name].extend(rs)
        rows["mas"].extend(time_bench_mas(dev, step_ns))
        for name, rs in time_parallel_kernels(dev, mcfg, hcfg, args.seed, par, step_ns).items():
            rows[name].extend(rs)
        per_call = time_attention_per_call(dev, args.seed)
        mrf_stages = time_mrf_per_stage(dev, hcfg, args.seed)
        bench_res = bench_path(dev, mcfg, hcfg, args.seed, step_ns)
        for name, rs in bench_res["kernel_rows"].items():
            rows[name].extend(rs)
        (train_row,) = [e for e in bench_res["record"] if e["row"] == "train"]
        base = dict(zip(METRICS, train_row["first_metrics"]))
        tools = tools_path(dev, mcfg, hcfg, args.seed, Path(tmp), step_ns, base)
        for name, rs in tools["kernel_rows"].items():
            rows[name].extend(rs)
    serve_work = " and ".join(f"{req} (batch {b}, budget {budget})"
                              for req, b, budget, _ in requests) + ", bf16, HiFi-GAN, CUDA graphs"
    serve_gl_work = " and ".join(f"{req} (batch {b}, budget {budget})"
                                 for req, b, budget, _ in requests_gl) + \
        ", f32, Griffin-Lim, CUDA graphs"
    serve16_work = (f"synthesise, {len(serve16['mel_lengths'])} texts (the engine's max_batch) "
                    f"at budget {serve16['budget']}, bf16, HiFi-GAN, CUDA graphs")
    train_work = (f"Trainer.fit at batch 16 on {TRAIN_ITEMS} synthetic items, "
                  f"{training['micro_steps_an_epoch']} micro-steps and "
                  f"{training['val_batches_an_epoch']} validation batch an epoch: fp32 1 epoch, "
                  f"bf16 1 epoch, bf16 resumed for a second at steps_per_dispatch 2 (validation "
                  f"in fp32); micro-steps and validation batches as CUDA graph replays")
    vocoder_work = (f"VocoderTrainer.fit at full width (batch 16 x 8192 samples, {VOC_ITEMS} "
                    f"synthetic items: 4 GAN steps an epoch) on CUDA graphs, no K2 in training; "
                    f"the trained generator folded and served, one low-latency request at "
                    f"budget {VOC_BUDGET} through an f32 and a bf16 HiFi-GAN engine's graphs")
    generate_work = (f"cli.generate at full width, f32, {ENTRY_STEPS} steps, batch 1: "
                     f"{generated['hifigan']['frames']} frames at budget "
                     f"{generated['hifigan']['budget']}, HiFi-GAN from a generator_v1 file")
    generate_gl_work = "the same generate run with Griffin-Lim"
    report_work = (f"cli.vocoder_report --synthetic on the trained store: "
                   f"{len(report['frames'])} generator calls at {report['frames']} frames, "
                   f"batch 1, f32, eager")
    bench_work = (f"cli.bench_mas at {', '.join(entry['bench_mas']['table'])}: a check, a "
                  f"warm-up and {entry['bench_mas']['runs']} timed calls each")
    par_work = (f"one rank on NCCL: Trainer.fit at K = 2 (fp32, batch 16, the {BUCKET_ITEMS}-item "
                f"bucket set, one epoch) on a data group and with the tensor-parallel path at model 1; "
                f"TTSEngine(mesh=) over the card (the serve path's requests); ring attention "
                f"at {list(PAR_RING)} (B, T), f32 and bf16, at one rank and in {PAR_BLOCKS} "
                f"blocks a rank for {PAR_BLOCKS} ranks in one process; seq-parallel "
                f"decode_fixed at one rank, 4 texts at budget {PAR_DECODE_BUDGET}, f32, "
                f"{ENTRY_STEPS} steps")
    bench_path_work = ("matcha_tpu_torch.bench's rows: bf16 synthesis at batch 128 and f32 at "
                       "64 (Tx 64, budget 512, 10 steps, CUDA graph replays), MAS at (16, 100, "
                       "500) and (32, 150, 800) and inside the loss graph at batch 128, training "
                       "at batch 128 bf16 (K 1 and 8, Ty 512), the bf16 HiFi-GAN single sentence "
                       "at 50 steps, 256 serve() requests from 32 clients (groups up to 16, "
                       "budget 256)")
    tools_work = (f"cli.trace_train_step at batch 128 bf16 (Tx 64, Ty 512): 4 dispatches of "
                  f"K 8 (one captured, a warm-up, two traced) and two eager micro-steps (one "
                  f"traced with attribution); cli.profile_vocoder at {TOOLS_VOC[0]} x "
                  f"{TOOLS_VOC[1]} frames in bf16 and f32, 14 CUDA graph replays each (the "
                  f"sweep's children, other processes, are checked apart)")
    line = kernel_line(rows, errs, {"serve": engine["launches"], "serve_gl": engine_gl["launches"],
                                    "serve16": serve16["launches"],
                                    "train": training["launches"],
                                    "vocoder": vocoder["launches"],
                                    "generate": generated["hifigan"]["launches"],
                                    "generate_gl": generated["griffin_lim"]["launches"],
                                    "vocoder_report": report["launches"],
                                    "bench_mas": {"mas": entry["bench_mas"]["launches"]},
                                    "parallel": par["launches"],
                                    "bench": bench_res["launches"],
                                    "tools": tools["launches"]},
                       {"serve": serve_work, "serve_gl": serve_gl_work,
                        "serve16": serve16_work, "train": train_work,
                        "vocoder": vocoder_work, "generate": generate_work,
                        "generate_gl": generate_gl_work, "vocoder_report": report_work,
                        "bench_mas": bench_work, "parallel": par_work,
                        "bench": bench_path_work, "tools": tools_work})
    for k in line["kernels"]:
        if k["name"] == "mas":
            k["chain_step_ns"] = step_ns

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(
        {"card": smi, "build_s": build_s, "checks": errs, "mas_profile": mas_profile,
         "chain_step_ns": step_ns, "engine": engine, "engine_griffin_lim": engine_gl,
         "serve_batch16": serve16, "ffn_variants": ffn, "examples": examples,
         "training": training, "train_graphs": train_graphs, "vocoder_training": vocoder,
         "entry_points": entry, "parallel": {k: v for k, v in par.items() if k != "training"},
         "parallel_training": {k: v for k, v in par["training"].items() if k != "batches"},
         "e2e": e2e, "kernel_rows": rows,
         "attention_per_call": per_call, "mrf_per_stage": mrf_stages,
         "bench": {k: v for k, v in bench_res.items() if k != "kernel_rows"},
         "tools": {k: v for k, v in tools.items() if k != "kernel_rows"}, **line},
        indent=1))
    log(line)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
