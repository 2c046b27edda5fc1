"""Synthesise one sentence with the port: text -> mel -> waveform (Griffin-Lim or HiFi-GAN).

    python -m matcha_tpu_torch.cli.generate --text "Hello" [--vocoder griffin_lim|hifigan]
        [--ckpt-dir checkpoints] [--torch-ckpt matcha_final.ckpt]
        [--hifigan-ckpt generator_v1 | --vocoder-ckpt-dir checkpoints_vocoder]
        [--steps 50] [--temperature 1.0] [--length-scale 1.0]
        [--out-dir generated_audio] [--seed 0] [--device cuda|cpu]

The port of `matcha_tpu/cli/generate.py`, on the CUDA card unless `--device`
says otherwise. Weights come from the reference's Lightning checkpoint
(`--torch-ckpt`) or from a store the port's trainer wrote (`--ckpt-dir`).
The simplified tokenizer, then `MatchaTTS.encode_durations`, a host read of
the predicted length, which sets the frame budget, and `decode_fixed` (the
Euler ODE over the U-Net: K1 in every decoder attention on the card); the
noise, and Griffin-Lim's initial phase, come from a `torch.Generator` seeded
with `--seed`. The HiFi-GAN generator (`--hifigan-ckpt`, the released
`generator_v1`, or a `train_vocoder` store) runs K2 in every MRF step.
Writes `matcha_<vocoder>.wav` and, where matplotlib imports,
`mel_spectrogram.png`.
"""

import argparse
import time
from pathlib import Path

DEFAULT_TEXT = "Hello, I am your Matcha Text to Speech model, what can I do for you."


def load_params(args):
    """A `MatchaTTS(MatchaConfig())` state dict, from `--torch-ckpt` (a reference
    Lightning checkpoint) or from the best checkpoint of `--ckpt-dir`."""
    if args.torch_ckpt:
        from matcha_tpu_torch.compat.torch_import import load_matcha_torch_checkpoint

        return load_matcha_torch_checkpoint(args.torch_ckpt)
    from matcha_tpu_torch.train.checkpoints import CheckpointStore

    try:
        return CheckpointStore(args.ckpt_dir).restore_params(map_location="cpu")
    except FileNotFoundError as e:
        raise FileNotFoundError(f"{e}; train first or pass --torch-ckpt") from None


def load_vocoder(hifigan_ckpt=None, vocoder_ckpt_dir=None):
    """The folded HiFi-GAN generator (eval mode, on the CPU) of a reference
    `generator_v1` file (`--hifigan-ckpt`), else of a `train_vocoder` store
    (`--vocoder-ckpt-dir`)."""
    from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig

    if hifigan_ckpt:
        from matcha_tpu_torch.compat.torch_import import load_hifigan_torch_checkpoint

        return load_hifigan_torch_checkpoint(hifigan_ckpt)
    from matcha_tpu_torch.train.vocoder import load_generator_for_inference

    gen = Generator(HiFiGANConfig())
    gen.load_state_dict(load_generator_for_inference(vocoder_ckpt_dir))
    return gen.eval()


def main(argv=None):
    ap = argparse.ArgumentParser(description="Matcha-TTS synthesis (PyTorch/CUDA port)")
    ap.add_argument("--text", default=DEFAULT_TEXT)
    ap.add_argument("--vocoder", default="griffin_lim", choices=["griffin_lim", "hifigan"])
    ap.add_argument("--ckpt-dir", default="checkpoints",
                    help="checkpoint directory written by the port's trainer (the JAX "
                         "package's Orbax stores cannot be read: pass --torch-ckpt)")
    ap.add_argument("--torch-ckpt", default=None,
                    help="the reference's Lightning checkpoint (matcha_final.ckpt)")
    ap.add_argument("--hifigan-ckpt", default=None,
                    help="torch generator_v1 checkpoint for the hifigan vocoder")
    ap.add_argument("--vocoder-ckpt-dir", default=None,
                    help="checkpoint dir from the port's train_vocoder (weight norm is "
                         "folded for serving)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--length-scale", type=float, default=1.0)
    ap.add_argument("--out-dir", default="generated_audio")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    if args.vocoder == "hifigan" and not (args.hifigan_ckpt or args.vocoder_ckpt_dir):
        raise SystemExit(
            "the hifigan vocoder needs --hifigan-ckpt (torch generator_v1) or "
            "--vocoder-ckpt-dir (a train_vocoder checkpoint)")

    import torch

    from matcha_tpu_torch import apply_tf32_policy, resolve_device
    from matcha_tpu_torch.audio.mel import MelConfig
    from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
    from matcha_tpu_torch.ops.masks import fix_len_compatibility
    from matcha_tpu_torch.text import simple_text_to_sequence
    from matcha_tpu_torch.utils import save_wav
    from matcha_tpu_torch.utils.profiling import rtf as compute_rtf

    device = resolve_device(args.device)
    if device.type == "cuda":
        apply_tf32_policy()
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    model = MatchaTTS(MatchaConfig())
    model.load_state_dict(load_params(args))
    model.eval().to(device)
    vocoder = (load_vocoder(args.hifigan_ckpt, args.vocoder_ckpt_dir).to(device)
               if args.vocoder == "hifigan" else None)

    # Tokenize with the simplified tokenizer, as the reference's generate.py does.
    seq = simple_text_to_sequence(args.text)
    x = torch.tensor([seq], dtype=torch.int64, device=device)
    xl = torch.tensor([len(seq)], dtype=torch.int64, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.perf_counter()
    # Stage 1: durations (the host reads the total frames to pick the budget).
    mu_x, w_ceil, x_mask, y_lengths = model.encode_durations(x, xl, args.length_scale)
    budget = fix_len_compatibility(int(y_lengths.max()))
    # Stage 2: alignment + ODE decode at that budget.
    out = model.decode_fixed(mu_x, w_ceil, x_mask, y_lengths, budget, args.steps,
                             args.temperature, generator=gen)
    n_frames = int(out["mel_lengths"][0])
    mel = out["mel"][:, :n_frames, :]  # (1, T, 80)
    mel_host = mel.cpu()
    wall = time.perf_counter() - t0
    print(f"mel: {tuple(mel.shape)}, rtf={compute_rtf(wall, n_frames):.3f}")

    cfg = MelConfig()
    if vocoder is None:
        from matcha_tpu_torch.audio.griffin_lim import mel_to_audio

        wav = mel_to_audio(cfg, mel.transpose(1, 2), generator=gen)
    else:
        wav = torch.clamp(vocoder(mel), -1.0, 1.0)

    wav_path = out_dir / f"matcha_{args.vocoder}.wav"
    save_wav(wav_path, wav, cfg.sample_rate)
    png = out_dir / "mel_spectrogram.png"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib is not installed: {png} skipped")
    else:
        from matcha_tpu_torch.utils.plotting import save_mel_png

        save_mel_png(mel_host[0].T, png)
    print(f"saved {wav_path}")


if __name__ == "__main__":
    main()
