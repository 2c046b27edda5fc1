"""Log-mel spectrogram pipeline in PyTorch.

The port of `matcha_tpu/audio/mel.py`, the reference's feature extractor
(`matcha/utils/audio_process.py:32-71`): reflect-pad by (n_fft - hop) / 2,
framed STFT (periodic Hann, center=False), magnitude sqrt(re^2 + im^2 + 1e-9),
slaney mel projection, log(clamp(x, 1e-5)).

The mel projection is a float32 matrix product in full float32: the JAX package
asks for HIGHEST precision there, and on the card `apply_tf32_policy` keeps
TF32 off, because these features are the training targets.
"""

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.audio.filters import mel_filterbank

MAX_WAV_VALUE = 32768.0


@dataclass(frozen=True)
class MelConfig:
    """Feature-extraction hyperparameters (the reference's LJSpeech defaults)."""

    n_fft: int = 1024
    n_mels: int = 80
    sample_rate: int = 22050
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float = 8000.0

    @property
    def pad_size(self) -> int:
        return (self.n_fft - self.hop_size) // 2


@functools.lru_cache(maxsize=8)
def _mel_basis(cfg: MelConfig) -> np.ndarray:
    return mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)


@functools.lru_cache(maxsize=8)
def _hann_window(win_size: int) -> np.ndarray:
    # periodic Hann, as torch.hann_window(win_size)
    n = np.arange(win_size)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _on_device(name: str, cfg: MelConfig, device: torch.device) -> torch.Tensor:
    """The config's filterbank ("basis", (n_mels, n_freq)) or window ("window")
    as a float32 tensor on `device`, copied there once. A CUDA graph cannot
    capture a copy from host memory, so the serving engine's eager warm-up
    puts these here before it captures a graph that reads them."""
    arr = _mel_basis(cfg) if name == "basis" else _hann_window(cfg.win_size)
    return torch.from_numpy(arr).to(device)


def num_frames(cfg: MelConfig, num_samples: int) -> int:
    """Frames produced for a waveform of `num_samples` samples (after reflect pad)."""
    padded = num_samples + 2 * cfg.pad_size
    return (padded - cfg.n_fft) // cfg.hop_size + 1


def frame_signal(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length) overlapping frames (a strided view)."""
    return y.unfold(-1, frame_length, hop)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of (..., T) by `pad` on both sides."""
    lead = y.shape[:-1]
    out = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    return out.reshape(*lead, out.shape[-1])


def stft_magnitude(cfg: MelConfig, y: torch.Tensor) -> torch.Tensor:
    """(B, T) waveform -> (B, n_freq, n_frames) STFT magnitude, reference-compatible."""
    frames = frame_signal(reflect_pad(y, cfg.pad_size), cfg.n_fft, cfg.hop_size)
    spec = torch.fft.rfft(frames * _on_device("window", cfg, y.device), n=cfg.n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return mag.transpose(-1, -2)


def log_compress(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """Dynamic-range compression log(clamp(x, clip_val)) (`audio_process.py:18-20`)."""
    return torch.log(torch.clamp(x, min=clip_val))


def mel_spectrogram(cfg: MelConfig, y: torch.Tensor) -> torch.Tensor:
    """(B, T) float waveform in [-1, 1] -> (B, n_mels, n_frames) log-mel."""
    mag = stft_magnitude(cfg, y)
    return log_compress(torch.matmul(_on_device("basis", cfg, y.device), mag))


def load_wav(path):
    """Read a wav file -> (float32 waveform in [-1, 1], sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    else:
        y = data.astype(np.float32)
    return y, sr


def load_and_process_audio(path, cfg: MelConfig = MelConfig(), device=None):
    """Wav file -> (1, n_mels, n_frames) log-mel on `device` (None: the card)
    (mirrors `audio_process.py:75-82`)."""
    y, sr = load_wav(path)
    if sr != cfg.sample_rate:
        raise ValueError(f"expected sample rate {cfg.sample_rate}, got {sr}")
    return mel_spectrogram(cfg, torch.from_numpy(y)[None, :].to(resolve_device(device)))
