"""Vocoder quality report: mel -> wav -> mel round-trip L1 for both vocoder paths.

    python -m matcha_tpu_torch.cli.vocoder_report --synthetic \
        --vocoder-ckpt-dir checkpoints_vocoder --out artifacts/vocoder_roundtrip.json
        [--data wavs_dir] [--n 8] [--segment-size 32768] [--device cuda|cpu]

The port of `matcha_tpu/cli/vocoder_report.py`, on the CUDA card unless
`--device` says otherwise. For a set of synthetic or real waveforms, compute
the log-mel, reconstruct audio with

  (a) Griffin-Lim + NNLS inverse mel, its initial phase drawn from a
      generator seeded with the item's index, and
  (b) a trained HiFi-GAN generator (`--vocoder-ckpt-dir`, a `train_vocoder`
      store, folded by `load_generator_for_inference`: K2 in every MRF step
      on the card),

re-extract the log-mel from each reconstruction, and report the mean
|mel - mel_rt| per path. Lower is better.
"""

import argparse
import json
from pathlib import Path

import numpy as np


def mel_l1(cfg, y_true: np.ndarray, y_rec: np.ndarray) -> float:
    """Mean |log-mel(y_true) - log-mel(y_rec)| over the common frame span (on the CPU)."""
    import torch

    from matcha_tpu_torch.audio.mel import mel_spectrogram

    m_true = mel_spectrogram(cfg, torch.from_numpy(np.asarray(y_true, np.float32)[None]))[0]
    m_rec = mel_spectrogram(cfg, torch.from_numpy(np.asarray(y_rec, np.float32)[None]))[0]
    t = min(m_true.shape[1], m_rec.shape[1])
    return float((m_true[:, :t] - m_rec[:, :t]).abs().mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic speech-shaped waveforms (no dataset needed)")
    ap.add_argument("--data", help="directory of wav files (e.g. LJSpeech wavs/)")
    ap.add_argument("--vocoder-ckpt-dir",
                    help="trained VocoderTrainer checkpoint dir (enables HiFi-GAN path)")
    ap.add_argument("--n", type=int, default=8, help="number of evaluation waveforms")
    ap.add_argument("--segment-size", type=int, default=32768,
                    help="samples per synthetic waveform (~1.5 s at 22.05 kHz)")
    ap.add_argument("--out", default="artifacts/vocoder_roundtrip.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    if not (args.synthetic or args.data):
        ap.error("provide --data or --synthetic")

    import torch

    from matcha_tpu_torch import apply_tf32_policy, resolve_device
    from matcha_tpu_torch.audio.griffin_lim import mel_to_audio
    from matcha_tpu_torch.audio.mel import MelConfig, mel_spectrogram

    device = resolve_device(args.device)
    if device.type == "cuda":
        apply_tf32_policy()
    cfg = MelConfig()

    if args.synthetic:
        from matcha_tpu_torch.data.audio_dataset import SyntheticWavDataset

        ds = SyntheticWavDataset(n_items=args.n, segment_size=args.segment_size, seed=1)
        wavs = [ds.get_segment(i, np.random.default_rng(0)) for i in range(args.n)]
    else:
        from matcha_tpu_torch.audio.mel import load_wav

        paths = sorted(Path(args.data).glob("*.wav"))[: args.n]
        wavs = [load_wav(p)[0][: args.segment_size] for p in paths]

    gen = None
    if args.vocoder_ckpt_dir:
        from matcha_tpu_torch.cli.generate import load_vocoder

        gen = load_vocoder(vocoder_ckpt_dir=args.vocoder_ckpt_dir).to(device)

    report = {"paths": {}, "n": len(wavs), "segment_size": args.segment_size,
              "source": "synthetic" if args.synthetic else args.data}
    gl_vals, hg_vals = [], []
    for i, y in enumerate(wavs):
        log_mel = mel_spectrogram(cfg, torch.from_numpy(y[None]).to(device))  # (1, n_mels, T)
        phase_gen = torch.Generator(device=device).manual_seed(i)
        y_gl = mel_to_audio(cfg, log_mel, generator=phase_gen)[0].cpu().numpy()
        gl_vals.append(mel_l1(cfg, y, y_gl))
        if gen is not None:
            y_hg = torch.clamp(gen(log_mel.transpose(1, 2)), -1.0, 1.0)[0].cpu().numpy()
            hg_vals.append(mel_l1(cfg, y, y_hg))

    report["paths"]["griffin_lim"] = {
        "mel_l1_mean": round(float(np.mean(gl_vals)), 4),
        "mel_l1_per_item": [round(v, 4) for v in gl_vals],
    }
    if hg_vals:
        report["paths"]["hifigan_trained"] = {
            "mel_l1_mean": round(float(np.mean(hg_vals)), 4),
            "mel_l1_per_item": [round(v, 4) for v in hg_vals],
            "ckpt_dir": args.vocoder_ckpt_dir,
        }

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["paths"]))


if __name__ == "__main__":
    main()
