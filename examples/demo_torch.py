"""End-to-end demo on the PyTorch/CUDA port: text -> mel -> waveform.

The port's counterpart of `examples/demo.py` and `demo_matcha.ipynb` (10
Euler steps, temperature 0.667): the text encoder and durations, the
fixed-budget ODE decode over the U-Net (kernel K1 in every decoder attention
on the card), then two vocoders, Griffin-Lim and HiFi-GAN (kernel K2 in
every MRF step on the card). Prints the real-time factor of each path and
writes `demo_griffin_lim.wav`, `demo_hifigan.wav` and, where matplotlib
imports, `demo_mel.png`.

Weights are random, from `--seed`, unless a checkpoint is given in the
reference's formats (`--torch-ckpt matcha_final.ckpt`, `--hifigan-ckpt
generator_v1`) or as a store the port's trainers wrote (`--ckpt-dir`,
`--vocoder-ckpt-dir`); random weights make noise-like audio through the
whole pipeline. Runs on the CUDA card unless `--device cpu`; `--tiny` takes
a reduced-width model (the notebooks' `MATCHA_DEMO_TINY`).

    python examples/demo_torch.py [--text "..."] [--steps 10] [--out demo_out]
        [--torch-ckpt matcha_final.ckpt | --ckpt-dir checkpoints]
        [--hifigan-ckpt generator_v1 | --vocoder-ckpt-dir checkpoints_vocoder]
        [--seed 0] [--device cpu] [--tiny]
"""

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository's package

DEFAULT_TEXT = "Flow matching makes text to speech fast."


def configs(tiny: bool):
    """(MatchaConfig, HiFiGANConfig, MelConfig): full width, or the tiny
    widths of the tests (8 mels)."""
    from matcha_tpu_torch.audio.mel import MelConfig
    from matcha_tpu_torch.models.hifigan import HiFiGANConfig
    from matcha_tpu_torch.models.matcha import MatchaConfig, tiny_config

    if not tiny:
        return MatchaConfig(), HiFiGANConfig(), MelConfig()
    mcfg = tiny_config()
    return (mcfg, HiFiGANConfig(num_mels=mcfg.n_feats, upsample_initial_channel=16),
            MelConfig(n_mels=mcfg.n_feats))


def load_models(args, mcfg, hcfg):
    """(MatchaTTS, folded HiFi-GAN Generator), in eval mode on the CPU: the
    checkpoints' weights where given, else random from `args.seed`."""
    from matcha_tpu_torch.cli.generate import load_params, load_vocoder
    from matcha_tpu_torch.models.hifigan import Generator
    from matcha_tpu_torch.models.matcha import MatchaTTS

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = MatchaTTS(mcfg)
        vocoder = Generator(hcfg)
    if args.torch_ckpt or args.ckpt_dir:
        model.load_state_dict(load_params(args))
    if args.hifigan_ckpt or args.vocoder_ckpt_dir:
        vocoder = load_vocoder(args.hifigan_ckpt, args.vocoder_ckpt_dir)
    return model.eval(), vocoder.eval()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Text -> mel -> waveform on the PyTorch/CUDA port")
    ap.add_argument("--text", default=DEFAULT_TEXT)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--temperature", type=float, default=0.667)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--torch-ckpt", default=None,
                    help="the reference's Lightning checkpoint (matcha_final.ckpt)")
    ap.add_argument("--ckpt-dir", default=None, help="a store written by the port's trainer")
    ap.add_argument("--hifigan-ckpt", default=None, help="the reference's generator_v1")
    ap.add_argument("--vocoder-ckpt-dir", default=None,
                    help="a store written by the port's vocoder trainer")
    ap.add_argument("--seed", type=int, default=0, help="random weights, noise and phase")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true", help="reduced widths, for tests")
    args = ap.parse_args(argv)

    from matcha_tpu_torch import apply_tf32_policy, resolve_device
    from matcha_tpu_torch.audio.griffin_lim import mel_to_audio
    from matcha_tpu_torch.ops.masks import fix_len_compatibility
    from matcha_tpu_torch.text import simple_text_to_sequence
    from matcha_tpu_torch.utils import save_wav
    from matcha_tpu_torch.utils.profiling import rtf

    device = resolve_device(args.device)
    if device.type == "cuda":
        apply_tf32_policy()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    mcfg, hcfg, mel_cfg = configs(args.tiny)
    model, vocoder = (m.to(device) for m in load_models(args, mcfg, hcfg))

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    seq = simple_text_to_sequence(args.text)
    x = torch.tensor([seq], dtype=torch.int64, device=device)
    xl = torch.tensor([len(seq)], dtype=torch.int64, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.no_grad():
        t0 = synced()
        # stage 1: encoder and durations; the host reads the length to pick the budget
        mu_x, w_ceil, x_mask, y_len = model.encode_durations(x, xl)
        budget = fix_len_compatibility(max(int(y_len.max()), 4))
        # stage 2: alignment and the Euler ODE over the U-Net at that budget
        res = model.decode_fixed(mu_x, w_ceil, x_mask, y_len, budget, args.steps,
                                 args.temperature, generator=gen)
        n_frames = int(res["mel_lengths"][0])
        mel = res["mel"][:, :n_frames]  # (1, T, n_mels)
        t_mel = synced()
        wavs = {"griffin_lim": mel_to_audio(mel_cfg, mel.transpose(1, 2), generator=gen)}
        t_gl = synced()
        wavs["hifigan"] = torch.clamp(vocoder(mel), -1.0, 1.0)
        t_hg = synced()

    hop, sr = mel_cfg.hop_size, mel_cfg.sample_rate
    walls = {"mel": t_mel - t0, "griffin_lim": t_gl - t0, "hifigan": (t_mel - t0) + (t_hg - t_gl)}
    rtfs = {name: rtf(wall, n_frames, hop, sr) for name, wall in walls.items()}
    print(f"{n_frames} mel frames at budget {budget} on {device}: RTF text->mel "
          f"{rtfs['mel']:.4f}, with Griffin-Lim {rtfs['griffin_lim']:.4f}, with HiFi-GAN "
          f"{rtfs['hifigan']:.4f}")
    for name, wav in wavs.items():
        save_wav(out / f"demo_{name}.wav", wav, sr)
    png = out / "demo_mel.png"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib is not installed: {png} skipped")
    else:
        from matcha_tpu_torch.utils.plotting import save_mel_png

        save_mel_png(mel[0].T.float().cpu(), png)
    print(f"wrote {', '.join(f'demo_{n}.wav' for n in wavs)} to {out}")
    return {"model": model, "vocoder": vocoder, "mel": mel, "wavs": wavs, "budget": budget,
            "frames": n_frames, "rtf": rtfs, "device": device}


if __name__ == "__main__":
    main()
