"""Inverse mel and Griffin-Lim waveform reconstruction in PyTorch.

The port of `matcha_tpu/audio/griffin_lim.py`, the reference's Griffin-Lim
vocoder (`generate.py:73-109`: torchaudio InverseMelScale 80 -> 513 bins, then
GriffinLim with n_fft 1024, hop 256, 32 iterations, power 1):

  * inverse mel: non-negative least squares by 200 projected Landweber steps of
    1 / ||basis||_2^2 on the filterbank (the norm is a constant of the config,
    taken once on the host in float64);
  * Griffin-Lim: the phase-retrieval loop with momentum 0.99, ISTFT -> STFT
    round trips; the STFT is center=True with reflect padding, the ISTFT a
    windowed overlap-add divided by the summed squared window, cropped by
    n_fft // 2.

The initial phase is an input (`phase`), or is drawn from an explicit
`torch.Generator`: torch cannot reproduce JAX's threefry bits, so parity runs
inject the JAX phase, as they inject the decoder's noise `z`. Every step is a
PyTorch call (FFTs and matrix products), as the JAX package leaves them to XLA;
on the card the serving engine replays them inside its CUDA graphs.
"""

import functools
import math
from typing import Optional

import numpy as np
import torch

from matcha_tpu_torch.audio.mel import (MelConfig, _mel_basis, _on_device, frame_signal,
                                        reflect_pad)


@functools.lru_cache(maxsize=8)
def _nnls_step(cfg: MelConfig) -> float:
    """1 / ||basis||_2^2, the largest Landweber step that still converges."""
    return float(1.0 / np.linalg.norm(_mel_basis(cfg).astype(np.float64), ord=2) ** 2)


def draw_phase(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform phase in [-pi, pi), float32, from `generator` (None: one seeded 0)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (2 * math.pi) - math.pi


def _stft(cfg: MelConfig, y: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, n_freq, frames) complex STFT, center=True (torchaudio GriffinLim)."""
    frames = frame_signal(reflect_pad(y, cfg.n_fft // 2), cfg.n_fft, cfg.hop_size)
    spec = torch.fft.rfft(frames * _on_device("window", cfg, y.device), n=cfg.n_fft, dim=-1)
    return spec.transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, n, L) frames -> (B, (n - 1) * hop + L) summed at offsets i * hop: the
    adjoint of `frame_signal`, as L / hop shifted block adds in the JAX
    package's order."""
    b, n, length = frames.shape
    k = length // hop
    acc = frames.new_zeros((b, n + k - 1, hop))
    blocks = frames.reshape(b, n, k, hop)
    for j in range(k):
        acc[:, j: j + n] += blocks[:, :, j]
    return acc.reshape(b, -1)


def _window_sum(cfg: MelConfig, n_frames: int, device) -> torch.Tensor:
    """The overlap-added squared window of `n_frames` frames, floored at 1e-11."""
    window = _on_device("window", cfg, device)
    wsq = (window * window).expand(1, n_frames, -1)
    return torch.clamp(_overlap_add(wsq, cfg.hop_size)[0], min=1e-11)


def _istft(cfg: MelConfig, spec: torch.Tensor, num_samples: int,
           wsum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, n_freq, frames) complex -> (B, num_samples) by windowed overlap-add.
    `wsum` is `_window_sum` of the frame count, if the caller has it."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=cfg.n_fft, dim=-1)
    y = _overlap_add(frames * _on_device("window", cfg, spec.device), cfg.hop_size)
    if wsum is None:
        wsum = _window_sum(cfg, frames.shape[1], spec.device)
    start = cfg.n_fft // 2
    return (y / wsum)[:, start: start + num_samples]


def inverse_mel(cfg: MelConfig, mel: torch.Tensor, n_iter: int = 200) -> torch.Tensor:
    """(B, n_mels, T) linear-power mel -> (B, n_freq, T) non-negative linear spectrogram.

    Projected Landweber / NNLS: minimize ||M s - mel||^2 subject to s >= 0.
    """
    basis = _on_device("basis", cfg, mel.device)  # (n_mels, n_freq)
    step = _nnls_step(cfg)
    s = torch.clamp(torch.matmul(basis.t(), mel), min=0.0)
    for _ in range(n_iter):
        resid = torch.matmul(basis, s) - mel
        s = torch.clamp(s - step * torch.matmul(basis.t(), resid), min=0.0)
    return s


def griffin_lim(cfg: MelConfig, magnitude: torch.Tensor, n_iter: int = 32,
                momentum: float = 0.99, phase: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                length: Optional[int] = None) -> torch.Tensor:
    """(B, n_freq, T) magnitude -> (B, samples) waveform by Griffin-Lim.

    torchaudio's defaults: momentum 0.99, 32 iterations. `phase` (the shape of
    `magnitude`) is the initial phase; without it, one is drawn from `generator`.
    """
    t = magnitude.shape[-1]
    num_samples = length if length is not None else t * cfg.hop_size
    if phase is None:
        phase = draw_phase(magnitude.shape, generator, magnitude.device)
    spec = torch.polar(magnitude, phase.to(magnitude.dtype))
    mom = momentum / (1 + momentum)
    wsum = _window_sum(cfg, t, magnitude.device)
    prev = torch.zeros_like(spec)
    for _ in range(n_iter):
        rebuilt = _stft(cfg, _istft(cfg, spec, num_samples, wsum))[:, :, :t]
        update = rebuilt - mom * prev
        spec = magnitude * (update / torch.clamp(update.abs(), min=1e-16))
        prev = rebuilt
    return _istft(cfg, spec, num_samples, wsum)


def mel_to_audio(cfg: MelConfig, log_mel: torch.Tensor, n_iter: int = 32,
                 phase: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The reference's Griffin-Lim path: (B, n_mels, T) log-mel -> exp -> inverse
    mel -> Griffin-Lim -> (B, T * hop) waveform (`generate.py:100-109`).
    `phase` is (B, n_freq, T), or is drawn from `generator`. The exp runs in
    the mel's dtype and the rest in float32, as in the JAX package."""
    return griffin_lim(cfg, inverse_mel(cfg, torch.exp(log_mel).float()), n_iter=n_iter,
                       phase=phase, generator=generator)
