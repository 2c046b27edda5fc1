"""Rotary positional embeddings over the first `rope_dim` features of each head.

GPT-NeoX pairing: feature i rotates with feature i + rope_dim/2; the remaining
features pass through (the reference passes rope_dim = head_dim / 2).
"""

import numpy as np
import torch


def _rope_tables(seq_len: int, rope_dim: int, base: float = 10_000.0):
    theta = 1.0 / (base ** (np.arange(0, rope_dim, 2, dtype=np.float64) / rope_dim))
    angles = np.arange(seq_len, dtype=np.float64)[:, None] * theta[None, :]
    angles = np.concatenate([angles, angles], axis=1)  # (T, rope_dim)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rope(x: torch.Tensor, rope_dim: int) -> torch.Tensor:
    """x: (B, H, T, D) -> same shape with the first `rope_dim` features rotated."""
    cos, sin = _rope_tables(x.shape[-2], rope_dim)
    # the tables join the activation dtype, so bf16 serving stays bf16
    cos = torch.from_numpy(cos).to(device=x.device, dtype=x.dtype)
    sin = torch.from_numpy(sin).to(device=x.device, dtype=x.dtype)
    x_rope, x_pass = x[..., :rope_dim], x[..., rope_dim:]
    half = rope_dim // 2
    neg_half = torch.cat([-x_rope[..., half:], x_rope[..., :half]], dim=-1)
    return torch.cat([x_rope * cos + neg_half * sin, x_pass], dim=-1)
