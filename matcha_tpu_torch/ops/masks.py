"""Sequence masks, U-Net length rounding and duration -> alignment paths."""

import math

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool mask, True at valid positions."""
    positions = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return positions[None, :] < lengths[:, None]


def fix_len_compatibility(length: int, num_downsamplings: int = 2) -> int:
    """Round `length` up to a multiple of 2**num_downsamplings (host-side ints)."""
    factor = 2 ** num_downsamplings
    return int(math.ceil(length / factor) * factor)


def generate_path(durations: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations (B, Tx) -> 0/1 monotone path (B, Tx, Ty) in `mask`'s dtype.

    Row x covers frames [cum(x-1), cum(x)). Callers pass float32 durations: a
    bf16 cumsum loses integer exactness past 256 frames.
    """
    t_y = mask.shape[2]
    cum = torch.cumsum(durations, dim=1)
    frames = torch.arange(t_y, device=cum.device, dtype=cum.dtype)
    cum_mask = (frames[None, None, :] < cum[:, :, None]).to(mask.dtype)
    shifted = torch.nn.functional.pad(cum_mask, (0, 0, 1, 0))[:, :-1, :]
    return (cum_mask - shifted) * mask
