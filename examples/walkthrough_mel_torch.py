"""Mel-pipeline walkthrough on the PyTorch port: the log-mel of a 440 Hz tone.

The port's counterpart of `examples/test_audio_to_Mel.ipynb`: one second of
A4 at `MelConfig()`'s 22.05 kHz (n_fft 1024, hop 256, 80 slaney mels)
through `audio.mel.mel_spectrogram`, the framed-rFFT log-mel, on the CPU,
where the port computes a mel for its data path. Where matplotlib imports,
the image is saved (not shown) to `--out`, by default
build/walkthrough_mel.png; a wav of your own goes in with `--wav`.

    python examples/walkthrough_mel_torch.py [--wav LJ001-0001.wav] [--out PATH]
"""

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the repository's package


def tone(sample_rate: int) -> np.ndarray:
    """The notebook's input: one second of a 440 Hz sine at amplitude 0.5."""
    t = np.arange(sample_rate) / sample_rate
    return (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wav", default=None, help="a wav at 22.05 kHz instead of the tone")
    ap.add_argument("--out", default=str(ROOT / "build" / "walkthrough_mel.png"))
    args = ap.parse_args(argv)
    import torch

    from matcha_tpu_torch.audio.mel import MelConfig, load_wav, mel_spectrogram

    cfg = MelConfig()
    if args.wav is None:
        wav = tone(cfg.sample_rate)
    else:
        wav, sr = load_wav(args.wav)
        if sr != cfg.sample_rate:
            raise SystemExit(f"{args.wav}: {sr} Hz, expected {cfg.sample_rate}")
    log_mel = mel_spectrogram(cfg, torch.from_numpy(wav)[None]).numpy()
    print("log-mel shape (batch, mels, frames):", log_mel.shape)
    res = {"wav": wav, "log_mel": log_mel, "image": None}
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib is absent: no image")
        return res
    from matcha_tpu_torch.utils.plotting import plot_spectrogram

    fig = plot_spectrogram(log_mel[0])
    fig.axes[0].set_title("log-mel of a 440 Hz tone" if args.wav is None else args.wav)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    print("image:", out)
    res["image"] = str(out)
    return res


if __name__ == "__main__":
    main()
