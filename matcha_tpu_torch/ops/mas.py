"""Monotonic alignment search: kernels K3a (forward DP) and K3b (backtrack) and their plain version.

Replaces the TPU kernels `matcha_tpu/ops/mas_pallas.py::_forward_kernel` and
`::_backward_kernel` (wrappers `_mas_pallas`, `maximum_path_pallas`); the plain
version ports `matcha_tpu/ops/mas_ref.py` (the same banded Viterbi DP, the same
`NEG`, the same tie rule, f32 throughout), so the path is bit-equal to the
reference's on the same scores.

The CUDA kernels (`csrc/mas.cu`) run one block per utterance:
- K3a keeps one DP cell per thread (text positions across threads) and walks
  the mel frames in order; it writes the take-diagonal decisions as one
  32-bit ballot word per warp and frame, (B, Ty, ceil(Tx/32)) int32;
- K3b stages its utterance's words in shared memory, walks the path back on
  one thread and writes the (B, Tx, Ty) 0/1 path.
Both are bound by a dependency chain of Ty steps, not by bytes or operations.

`maximum_path` takes its path from the tensors: the plain version
(`maximum_path_plain`) for CPU tensors, the kernels for CUDA tensors (or an
exception). `mas_forward.launches` and `mas_backtrack.launches` count kernel
launches.
"""

import ctypes
import functools
from typing import Optional

import torch

from matcha_tpu_torch.ops import _build

NEG = -1e9
MAX_TEXT = 1024  # one thread per text position, 1024 threads a block


def lengths_from_mask(mask: torch.Tensor):
    """(B, Tx, Ty) mask -> (t_x, t_y) int32, as `maximum_path_pallas` derives them."""
    t_x = mask.amax(dim=2).sum(dim=1).to(torch.int32)
    t_y = mask.amax(dim=1).sum(dim=1).to(torch.int32)
    return t_x, t_y


def mas_forward_plain(score: torch.Tensor, t_x: torch.Tensor, t_y: torch.Tensor):
    """The DP over frames. score (B, Ty, Tx) f32 -> take-diagonal bits (B, Ty, Tx) bool."""
    b, ty_max, tx_max = score.shape
    dev = score.device
    xs = torch.arange(tx_max, device=dev, dtype=torch.int32)[None, :]
    t_x = t_x.to(device=dev, dtype=torch.int32)[:, None]
    t_y = t_y.to(device=dev, dtype=torch.int32)[:, None]
    neg = torch.full((b, 1), NEG, device=dev, dtype=torch.float32)
    dp = torch.full((b, tx_max), NEG, device=dev, dtype=torch.float32)
    bits = []
    for y in range(ty_max):
        x_min = torch.clamp(t_x + y - t_y, min=0)
        x_max = torch.clamp(t_x, max=y + 1)
        in_band = (xs >= x_min) & (xs < x_max)
        shifted = torch.cat([neg, dp[:, :-1]], dim=1)
        from_prev = torch.where(xs == 0, 0.0 if y == 0 else NEG, shifted)
        from_same = dp if y > 0 else torch.full_like(dp, NEG)
        from_same = torch.where(xs == y, NEG, from_same)
        take_diag = (from_prev >= from_same) | (xs == y)
        best = torch.where(take_diag, from_prev, from_same)
        dp = torch.where(in_band, best + score[:, y], NEG)
        bits.append(take_diag)
    return torch.stack(bits, dim=1)


def mas_backtrack_plain(bits: torch.Tensor, t_x: torch.Tensor, t_y: torch.Tensor):
    """Walk the bits (B, Ty, Tx) back from (t_x - 1, t_y - 1): (B, Tx, Ty) 0/1 path, f32."""
    b, ty_max, tx_max = bits.shape
    dev = bits.device
    xs = torch.arange(tx_max, device=dev, dtype=torch.int32)[None, :]
    t_y = t_y.to(device=dev, dtype=torch.int32)
    idx = t_x.to(device=dev, dtype=torch.int32) - 1
    rows = [None] * ty_max
    for y in reversed(range(ty_max)):
        active = y < t_y
        onehot = xs == idx[:, None]
        rows[y] = onehot & active[:, None]
        td_at_idx = (onehot & bits[:, y]).any(dim=1)
        dec = active & (y > 0) & (idx > 0) & ((idx == y) | td_at_idx)
        idx = idx - dec.to(torch.int32)
    return torch.stack(rows, dim=2).to(torch.float32)


@functools.cache
def _entries():
    """The kernels' C entries, built and loaded on first use."""
    lib = _build.library("mas")
    fwd, bwd = lib.mas_forward, lib.mas_backtrack
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_lengths(t_x, t_y, b, dev):
    for name, t in (("t_x", t_x), ("t_y", t_y)):
        if t.shape != (b,) or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name} must be ({b},) int32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def mas_forward(score: torch.Tensor, t_x: torch.Tensor, t_y: torch.Tensor):
    """Launch K3a: score (B, Ty, Tx) f32 contiguous on a CUDA device, int32 lengths
    -> (B, Ty, ceil(Tx/32)) int32 ballot words; bit x of word w is text position
    32w + x. Frames at or past t_y are not written."""
    if not score.is_cuda:
        raise ValueError("mas_forward needs the scores on a CUDA device")
    if score.dtype != torch.float32 or score.dim() != 3 or not score.is_contiguous():
        raise ValueError(f"mas_forward takes contiguous (B, Ty, Tx) float32 scores, got "
                         f"{tuple(score.shape)} {score.dtype}")
    b, ty_max, tx_max = score.shape
    if not 1 <= tx_max <= MAX_TEXT:
        raise ValueError(f"mas_forward takes 1 to {MAX_TEXT} text positions, got {tx_max}")
    _check_lengths(t_x, t_y, b, score.device)
    words = torch.empty((b, ty_max, (tx_max + 31) // 32), device=score.device,
                        dtype=torch.int32)
    fwd, _ = _entries()
    with torch.cuda.device(score.device):
        stream = torch.cuda.current_stream(score.device).cuda_stream
        rc = fwd(score.data_ptr(), t_x.data_ptr(), t_y.data_ptr(), words.data_ptr(),
                 b, ty_max, tx_max, stream)
    if rc != 0:
        raise RuntimeError(f"mas_forward kernel launch failed: CUDA error {rc}")
    mas_forward.launches += 1
    return words


def mas_backtrack(words: torch.Tensor, t_x: torch.Tensor, t_y: torch.Tensor, tx_max: int):
    """Launch K3b: K3a's words (B, Ty, ceil(Tx/32)) -> (B, Tx, Ty) 0/1 path, f32."""
    if not words.is_cuda:
        raise ValueError("mas_backtrack needs the words on a CUDA device")
    b, ty_max, n_words = words.shape
    if (words.dtype != torch.int32 or not words.is_contiguous()
            or n_words != (tx_max + 31) // 32):
        raise ValueError(f"mas_backtrack takes contiguous (B, Ty, {(tx_max + 31) // 32}) "
                         f"int32 words, got {tuple(words.shape)} {words.dtype}")
    if ty_max * n_words * 4 + ty_max * 4 > 227 * 1024:
        raise ValueError(f"mas_backtrack stages Ty * ceil(Tx/32) words in shared memory: "
                         f"{ty_max} x {n_words} does not fit")
    _check_lengths(t_x, t_y, b, words.device)
    path = torch.empty((b, tx_max, ty_max), device=words.device, dtype=torch.float32)
    _, bwd = _entries()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = bwd(words.data_ptr(), t_x.data_ptr(), t_y.data_ptr(), path.data_ptr(),
                 b, ty_max, tx_max, stream)
    if rc != 0:
        raise RuntimeError(f"mas_backtrack kernel launch failed: CUDA error {rc}")
    mas_backtrack.launches += 1
    return path


mas_forward.launches = 0
mas_backtrack.launches = 0


def unpack_words(words: torch.Tensor, tx_max: int) -> torch.Tensor:
    """K3a's ballot words (B, Ty, W) int32 -> bits (B, Ty, Tx) bool."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.flatten(2)[..., :tx_max].bool()


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bits (B, Ty, Tx) bool -> (B, Ty, ceil(Tx/32)) int32 words, K3a's layout."""
    b, ty, tx = bits.shape
    n = (tx + 31) // 32
    padded = torch.zeros((b, ty, n * 32), device=bits.device, dtype=torch.int64)
    padded[..., :tx] = bits.to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (padded.view(b, ty, n, 32) << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _scores(value, mask, t_x, t_y):
    """(B, Ty, Tx) f32 masked scores and int32 lengths (from the mask when not given)."""
    if t_x is None or t_y is None:
        dx, dy = lengths_from_mask(mask)
        t_x = dx if t_x is None else t_x
        t_y = dy if t_y is None else t_y
    t_x = t_x.to(device=value.device, dtype=torch.int32)
    t_y = t_y.to(device=value.device, dtype=torch.int32)
    return (value * mask).float().transpose(1, 2).contiguous(), t_x, t_y


@torch.no_grad()
def maximum_path_plain(value: torch.Tensor, mask: torch.Tensor,
                       t_x: Optional[torch.Tensor] = None, t_y: Optional[torch.Tensor] = None):
    """The plain version of `maximum_path`, on any device."""
    score, t_x, t_y = _scores(value, mask, t_x, t_y)
    path = mas_backtrack_plain(mas_forward_plain(score, t_x, t_y), t_x, t_y)
    return (path * mask).to(value.dtype)


@torch.no_grad()
def maximum_path(value: torch.Tensor, mask: torch.Tensor,
                 t_x: Optional[torch.Tensor] = None, t_y: Optional[torch.Tensor] = None):
    """Batch MAS. value, mask (B, Tx, Ty); t_x, t_y (B,) lengths, derived from
    the mask when not given. Returns the (B, Tx, Ty) 0/1 path in value's dtype.

    Precondition, as in the reference: t_y >= t_x per sample.
    """
    if value.device.type == "cpu":
        return maximum_path_plain(value, mask, t_x, t_y)
    score, t_x, t_y = _scores(value, mask, t_x, t_y)
    path = mas_backtrack(mas_forward(score, t_x, t_y), t_x, t_y, value.shape[1])
    return (path * mask).to(value.dtype)
