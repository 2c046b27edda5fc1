#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`matcha_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out PATH]

Run from the root of a checkout, on a machine with one CUDA card, `nvcc` and
PyTorch built for CUDA. In order:

1. prints the card's name and power limit, builds every kernel of
   `matcha_tpu_torch/csrc/` with nvcc (all sources in parallel);
2. holds each kernel against its plain PyTorch version on the card:
   K1 (attention) at B=2, H=4, T in {128, 1000, 1024}, D=64 with a ragged 0/1
   bias, K2 (MRF step) at every (C, k, d) of the generator at a T that is no
   multiple of a tile, both in float32 and bf16;
3. serves through `TTSEngine` at full width (MatchaConfig() and HiFi-GAN v1,
   random weights from `--seed`, bf16, int16 output): 4 texts with per-request
   seeds, then one `synthesise_lowlatency` at the 1024-frame budget, with the
   launch counts set to 0 just before and read just after;
4. holds the port on the card against itself on the CPU (float32, TF32 off,
   the same weights and noise) and against the frozen reference outputs of
   `tests/fixtures/golden_e2e*.npz`;
5. at every shape the main path gave each kernel (both requests, bf16), holds
   the kernel against its plain version and times the kernel, its plain
   version and the matching PyTorch call, beside the least time the card
   could take.

Prints one JSON line per result; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises and the script exits non-zero; so does a machine with
no CUDA card or a directory without the package. Details (every check,
the profile and each kernel's per-shape times) go to `--out`, by default
build/chip_smoke.json.
"""

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# tolerances of a kernel against its plain version on the same inputs
# (|kernel - plain| <= atol + rtol * |plain| elementwise). float32: sums in
# another order, the JAX package's bar for its attention kernel. bf16: the bar
# of the JAX package's bf16 attention test, a few bf16 steps (2^-8 relative)
# of the output: both versions round the output once, and K2 also rounds
# lrelu(x) and z to bf16 for the tensor cores where the plain version keeps f32.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
TOL_MRF_F32 = (1e-4, 1e-4)  # up to C*k = 2816 products summed per output
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


def check_kernels(dev, seed):
    """Each kernel against its plain version on the card; returns max errors."""
    from matcha_tpu_torch.ops.attention import attention_cuda, attention_plain
    from matcha_tpu_torch.ops.mrf import mrf_step_cuda, mrf_step_plain

    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {"attention_fwd": {}, "mrf_step": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        atol, rtol = TOL[name]
        worst = 0.0
        for t in (128, 1000, 1024):
            q, k, v, bias = attention_inputs(2, 4, t, 64, dtype, dev, gen)
            for bb in (bias, None):
                got = attention_cuda(q, k, v, bb, 0.125)
                torch.cuda.synchronize()
                worst = max(worst, max_err_within(
                    got, attention_plain(q, k, v, bb, 0.125), atol, rtol,
                    f"K1 {name} T={t} bias={'ragged' if bb is not None else 'none'}"))
        errs["attention_fwd"][name] = {"max_abs_err": worst, "atol": atol, "rtol": rtol}
        log(f"K1 attention_fwd {name}: max abs err {worst:.3g} (tolerance atol {atol} rtol {rtol})")

        atol, rtol = TOL_MRF_F32 if dtype == torch.float32 else TOL[name]
        worst = 0.0
        for c in (256, 128, 64, 32):
            for k in (3, 7, 11):
                for d in (1, 3, 5):
                    args = mrf_inputs(2, c, 4099, k, dtype, dev, gen)  # 4099: prime
                    got = mrf_step_cuda(*args, d)
                    torch.cuda.synchronize()
                    worst = max(worst, max_err_within(got, mrf_step_plain(*args, d), atol, rtol,
                                                      f"K2 {name} C={c} k={k} d={d}"))
        errs["mrf_step"][name] = {"max_abs_err": worst, "atol": atol, "rtol": rtol}
        log(f"K2 mrf_step {name}: max abs err {worst:.3g} (tolerance atol {atol} rtol {rtol})")
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


def serve_main_path(dev, mcfg, hcfg, seed):
    """Serve 4 texts and one 1024-frame low-latency request through the
    kernels; returns the engine's numbers."""
    from matcha_tpu_torch.ops.attention import attention
    from matcha_tpu_torch.ops.mrf import mrf_step
    from matcha_tpu_torch.serve import ServeConfig, TTSEngine

    msd, gsd = model_weights(mcfg, hcfg, seed)
    scfg = ServeConfig(bf16=True, vocoder="hifigan", output_dtype="int16")
    engine = TTSEngine(msd, mcfg, scfg, gsd, hcfg, device=dev)
    seeds = list(range(100, 100 + len(TEXTS)))
    t0 = time.perf_counter()
    engine.warmup((1, len(TEXTS)))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    attention.launches = 0
    mrf_step.launches = 0
    wavs, info = engine.synthesise(TEXTS, seeds=seeds)
    wav_ll, info_ll = engine.synthesise_lowlatency(LONG_TEXT, seed=7, budget=1024)
    counts = {"attention_fwd": attention.launches, "mrf_step": mrf_step.launches}

    decodes = 2  # one request group, one low-latency request
    want = {"attention_fwd": decodes * scfg.n_timesteps
            * sum(n for n, _ in attention_shapes(mcfg.decoder, 1024)),
            "mrf_step": decodes * len(mrf_shapes(hcfg, 1))}
    log(f"main path launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    hop = 256
    for wav, ml in list(zip(wavs, info["mel_lengths"])) + [(wav_ll, info_ll["mel_lengths"][0])]:
        if wav.dtype != np.int16 or wav.shape != (ml * hop,) or ml < 8:
            raise AssertionError(f"waveform {wav.dtype} {wav.shape} for {ml} mel frames")
        if np.abs(wav.astype(np.int32)).max() == 0:
            raise AssertionError("silent waveform")
    if info_ll["budget"] != 1024 or any(info["truncated"]) or info_ll["truncated"]:
        raise AssertionError(f"budgets {info['budget']}/{info_ll['budget']}, truncation "
                             f"{info['truncated']}/{info_ll['truncated']}")

    repeats = [(engine.synthesise(TEXTS, seeds=seeds)[1],
                engine.synthesise_lowlatency(LONG_TEXT, seed=7, budget=1024)[1])
               for _ in range(3)]  # steady state, uncounted
    profile = {"lowlatency": profile_request(
                   lambda: engine.synthesise_lowlatency(LONG_TEXT, seed=7, budget=1024)),
               "synthesise": profile_request(lambda: engine.synthesise(TEXTS, seeds=seeds))}
    return {
        "warmup_s": warm_s,
        "synthesise": {"requests": len(TEXTS), "budget": info["budget"],
                       "mel_lengths": info["mel_lengths"], "wall_s": info["wall_s"],
                       "rtf": info["rtf"], "wall_s_repeats": [a["wall_s"] for a, _ in repeats]},
        "lowlatency": {"budget": 1024, "mel_lengths": info_ll["mel_lengths"],
                       "wall_s": info_ll["wall_s"], "rtf": info_ll["rtf"],
                       "wall_s_repeats": [b["wall_s"] for _, b in repeats]},
        "launches": counts,
        "profile": profile,
    }


# (group, substring of the kernel's name), first match wins
KERNEL_GROUPS = (("K1 attention_fwd", "attn_fwd"), ("K2 mrf_step", "mrf_step"),
                 ("convolution", "conv"),
                 ("convolution", "fprop"), ("convolution", "dgrad"),
                 ("convolution", "nchwtonhwc"), ("convolution", "nhwctonchw"),
                 ("matmul", "gemm"), ("matmul", "gemv"), ("normalization", "moments"),
                 ("normalization", "norm"), ("elementwise", "elementwise"))


def profile_request(call):
    """Device time of one request by kernel group, and the card's idle share
    of the request's wall time, from torch.profiler's CUDA kernel events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured (no CUDA events traced)"}
    groups, names = {}, {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        low = e.name.lower()
        group = next((g for g, key in KERNEL_GROUPS if key in low), "other")
        groups[group] = groups.get(group, 0.0) + ms
        names[e.name[:90]] = names.get(e.name[:90], 0.0) + ms
    busy = sum(groups.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "kernel_launches": len(kernels), "by_group_ms": groups, "top_kernels_ms": dict(top)}


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


# ---------------------------------------------------------------- phase 5
def main_path_requests(engine):
    """(name, batch, budget, mel lengths) of the two decodes the main path ran."""
    syn, ll = engine["synthesise"], engine["lowlatency"]
    return [("synthesise", len(syn["mel_lengths"]), syn["budget"], syn["mel_lengths"]),
            ("lowlatency", 1, ll["budget"], ll["mel_lengths"])]


def time_kernels(dev, mcfg, hcfg, seed, requests, n_timesteps=10, reps=20):
    """At every shape the main path gave K1 and K2 (bf16): the kernel against
    its plain version, then per-launch kernel, plain and library times and
    each launch's bound."""
    from matcha_tpu_torch.ops.attention import attention_cuda, attention_plain
    from matcha_tpu_torch.ops.mrf import mrf_step_cuda, mrf_step_plain, pack_weights

    gen = torch.Generator(device=dev).manual_seed(seed)
    dcfg, bf16, elt = mcfg.decoder, torch.bfloat16, 2
    atol, rtol = TOL["bfloat16"]
    h, d = dcfg.num_heads, dcfg.attention_head_dim
    scale = d ** -0.5
    rows = {"attention_fwd": [], "mrf_step": []}
    for req, b, budget, mel_lengths in requests:
        for count, t in attention_shapes(dcfg, budget):
            q, k, v, bias = attention_inputs(b, h, t, d, bf16, dev, gen, mel_lengths, budget)
            what = f"K1 bf16 {req} {[b, h, t, d]}"
            err = max_err_within(attention_cuda(q, k, v, bias, scale),
                                 attention_plain(q, k, v, bias, scale), atol, rtol, what)
            mask = bias[:, None, None, :]
            rows["attention_fwd"].append({
                "request": req, "shape": [b, h, t, d], "count": count * n_timesteps,
                "max_abs_err": err,
                "flops": 4 * b * h * t * t * d, "bytes": 4 * b * h * t * d * elt + b * t * elt,
                "ms": cuda_ms(lambda: attention_cuda(q, k, v, bias, scale), reps),
                "plain_ms": cuda_ms(lambda: attention_plain(q, k, v, bias, scale), reps),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale), reps)})
        for c, t, k, dil in mrf_shapes(hcfg, budget):
            args = mrf_inputs(b, c, t, k, bf16, dev, gen)
            packed = pack_weights(args[1], args[3])  # once, as ResBlock1 packs its weights
            err = max_err_within(mrf_step_cuda(*args, dil, packed), mrf_step_plain(*args, dil),
                                 atol, rtol, f"K2 bf16 {req} {[b, c, t]} k={k} d={dil}")
            rows["mrf_step"].append({
                "request": req, "shape": [b, c, t], "k": k, "d": dil, "count": 1,
                "max_abs_err": err,
                "flops": 4 * b * c * c * k * t,
                "bytes": (2 * b * c * t + 2 * c * c * k + 2 * c) * elt,
                "ms": cuda_ms(lambda: mrf_step_cuda(*args, dil, packed), reps),
                "plain_ms": cuda_ms(lambda: mrf_step_plain(*args, dil), reps),
                "library_ms": None})
    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"] = max(r["flops"] / PEAK_BF16_FLOPS, r["bytes"] / PEAK_BYTES) * 1e3
            lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f}"
            kd = f" k={r['k']} d={r['d']}" if "k" in r else ""
            log(f"{name} {r['request']} {r['shape']}{kd} x{r['count']}: {r['ms']:.4f} ms a "
                f"launch, plain {r['plain_ms']:.4f}{lib}, bound {r['bound_ms']:.5f}, "
                f"max abs err {r['max_abs_err']:.3g}")
        log(f"{name} bf16 at the main path's shapes: max abs err "
            f"{max(r['max_abs_err'] for r in rs):.3g} (tolerance atol {atol} rtol {rtol})")
    return rows


def kernel_line(rows, errs, launches, requests):
    """The `kernels` JSON object: each kernel's times and bound summed over the
    launches the main path made, which are the ones its `launches` counts."""
    sources = {
        "attention_fwd": ("matcha_tpu_torch/csrc/attention_fwd.cu",
                          "matcha_tpu/ops/attention_pallas.py:39"),
        "mrf_step": ("matcha_tpu_torch/csrc/mrf_step.cu", "matcha_tpu/ops/mrf_pallas.py:44"),
    }
    work = " and ".join(f"{req} (batch {b}, budget {budget})" for req, b, budget, _ in requests)
    kernels = []
    for name, rs in rows.items():
        def total(key):
            return sum(r["count"] * r[key] for r in rs)

        if sum(r["count"] for r in rs) != launches[name]:
            raise AssertionError(f"{name}: timed {sum(r['count'] for r in rs)} launches, "
                                 f"the main path made {launches[name]}")
        op_ms, byte_ms = total("flops") / PEAK_BF16_FLOPS * 1e3, total("bytes") / PEAK_BYTES * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max([e["max_abs_err"] for e in errs[name].values()]
                               + [r["max_abs_err"] for r in rs]),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": None if rs[0]["library_ms"] is None else total("library_ms"),
            "work": f"the {launches[name]} launches of the main path: {work}, bf16"})
    return {"kernels": kernels}


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
    from matcha_tpu_torch import apply_tf32_policy
    from matcha_tpu_torch.models.hifigan import HiFiGANConfig
    from matcha_tpu_torch.models.matcha import MatchaConfig
    from matcha_tpu_torch.ops import _build

    # float32 plain versions in full float32: cuDNN would take TF32 by default
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
        for line in _build.build_log(name).splitlines():
            if "Used" in line:
                log(f"  {name}: {line.split(':', 1)[1].strip()}")

    mcfg, hcfg = MatchaConfig(), HiFiGANConfig()  # full width: Matcha-TTS and HiFi-GAN v1
    errs = check_kernels(dev, args.seed)
    engine = serve_main_path(dev, mcfg, hcfg, args.seed)
    log({"engine": engine})
    e2e = {"card_vs_cpu": card_vs_cpu(dev, mcfg, hcfg, args.seed), "golden": golden_on_card(dev)}
    requests = main_path_requests(engine)
    rows = time_kernels(dev, mcfg, hcfg, args.seed, requests)
    line = kernel_line(rows, errs, engine["launches"], requests)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(
        {"card": smi, "build_s": build_s, "checks": errs, "engine": engine, "e2e": e2e,
         "kernel_rows": rows, **line}, indent=1))
    log(line)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
