"""Rotary positional embeddings over the first `rope_dim` features of each head.

GPT-NeoX pairing: feature i rotates with feature i + rope_dim/2; the remaining
features pass through (the reference passes rope_dim = head_dim / 2).
"""

import torch


def _rope_tables(seq_len: int, rope_dim: int, device, base: float = 10_000.0):
    """cos and sin tables (T, rope_dim) in float32, computed in float64 on
    `device`. They are built there rather than copied from the host, so that
    the encoder has no host-to-device copy and a CUDA graph can capture it."""
    theta = 1.0 / (base ** (torch.arange(0, rope_dim, 2, dtype=torch.float64, device=device)
                            / rope_dim))
    angles = torch.arange(seq_len, dtype=torch.float64, device=device)[:, None] * theta[None, :]
    angles = torch.cat([angles, angles], dim=1)  # (T, rope_dim)
    return torch.cos(angles).float(), torch.sin(angles).float()


def apply_rope(x: torch.Tensor, rope_dim: int) -> torch.Tensor:
    """x: (B, H, T, D) -> same shape with the first `rope_dim` features rotated."""
    cos, sin = _rope_tables(x.shape[-2], rope_dim, x.device)
    # the tables join the activation dtype, so bf16 serving stays bf16
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    x_rope, x_pass = x[..., :rope_dim], x[..., rope_dim:]
    half = rope_dim // 2
    neg_half = torch.cat([-x_rope[..., half:], x_rope[..., :half]], dim=-1)
    return torch.cat([x_rope * cos + neg_half * sin, x_pass], dim=-1)
