"""Sequence masks, U-Net length rounding, duration -> alignment paths, the
duration loss and mel normalisation."""

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


def duration_loss(logw: torch.Tensor, logw_target: torch.Tensor, lengths: torch.Tensor):
    """Sum of squared log-duration errors over the total token count."""
    return torch.sum((logw - logw_target) ** 2) / torch.sum(lengths)


def _stat(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-channel statistic, broadcast over the trailing time axis."""
    value = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return value[..., None] if value.dim() > 0 else value


def normalize(data: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std with scalar or per-channel statistics."""
    return (data - _stat(mean, data)) / _stat(std, data)


def denormalize(data: torch.Tensor, mean, std) -> torch.Tensor:
    """x * std + mean with scalar or per-channel statistics."""
    return data * _stat(std, data) + _stat(mean, data)
