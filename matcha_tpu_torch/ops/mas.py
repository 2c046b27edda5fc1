"""Monotonic alignment search: the fused kernel of K3a (forward DP) and K3b (walk back), and their plain versions.

Replaces the TPU kernels `matcha_tpu/ops/mas_pallas.py::_forward_kernel` and
`::_backward_kernel` (wrappers `_mas_pallas`, `maximum_path_pallas`); the plain
version ports `matcha_tpu/ops/mas_ref.py` (the same banded Viterbi DP, the same
`NEG`, the same tie rule, f32 throughout), so the path is bit-equal to the
reference's on the same scores. `mas_forward_plain` and `mas_backtrack_plain`
are the plain versions of the two TPU kernels.

The CUDA kernel (`csrc/mas.cu`) is one launch per alignment, one block per
utterance: it reads value and mask in their (B, Tx, Ty) layout and forms
their product as PyTorch does, runs the DP on one warp (text positions in
registers, a shuffle a frame) while the other warps stream the scores into
shared memory and write the output's zeros, keeps the decisions in shared
memory, walks the path back and writes the path cells. It is bound by a
chain of t_y dependent steps, not by bytes or operations. `mas_plan` sizes
its shared memory; `chain_probe` measures one step of the recursion.

`maximum_path` takes its path from the tensors: the plain version
(`maximum_path_plain`) for CPU tensors, the kernel for CUDA tensors (or an
exception). `mas_cuda.launches` counts kernel launches.
"""

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from matcha_tpu_torch.ops import _build

NEG = -1e9
MAX_TEXT = 1024  # 32 cells a lane of the DP warp


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


SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_STAGE_SCORES = 8192  # f32 scores a ring stage holds at most (32 KB)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class MasPlan:
    """The fused kernel's layout of one launch, as `csrc/mas.cu` derives it
    (struct Plan): `cells` text positions a DP lane holds (a power of two,
    32 * cells >= Tx), chunks of `frames` mel frames, a ring of `stages`,
    `smem` bytes of dynamic shared memory."""

    cells: int
    frames: int
    stages: int
    smem: int


def mas_cells(tx: int) -> int:
    """Text positions a lane of the DP warp holds: the least power of two k
    with 32 k >= tx."""
    k = 1
    while 32 * k < tx:
        k *= 2
    return k


def _smem_bytes(cells: int, frames: int, stages: int, ty: int) -> int:
    """Shared memory of a plan (struct Plan in csrc/mas.cu): the ring of f32
    scores (a stage holds a spare row for the DP's look-ahead), two mbarriers
    a stage, Ty x cells decision words, a path index a frame."""
    return stages * (frames + 1) * 32 * cells * 4 + 16 * stages + ty * cells * 4 + ty * 4


def mas_plan(tx: int, ty: int) -> MasPlan:
    """The plan of one launch on (B, tx, ty) inputs.

    A chunk is at most 64 frames (fewer starve the DP warp at a chunk's
    boundary, more delay its first chunk) and at most a 32 KB stage (8
    frames at tx > 512), so that a producer thread loads a whole chunk in one
    batch; the ring takes 4 stages where they fit beside the decisions, else
    3 or 2, else fewer frames a chunk. The scores are stored in f32 whatever
    the input dtypes, so the plan does not depend on them. Raises ValueError
    when tx is past MAX_TEXT or no plan fits in shared memory.
    """
    if not 1 <= tx <= MAX_TEXT:
        raise ValueError(f"MAS takes 1 to {MAX_TEXT} text positions, got {tx}")
    if ty < 1:
        raise ValueError(f"MAS takes at least one mel frame, got {ty}")
    cells = mas_cells(tx)
    frames = min(64, _STAGE_SCORES // (32 * cells))
    while frames >= 4:
        for stages in (4, 3, 2):
            smem = _smem_bytes(cells, frames, stages, ty)
            if smem <= SMEM_LIMIT:
                return MasPlan(cells, frames, stages, smem)
        frames //= 2
    raise ValueError(f"MAS keeps {ty} x {cells} decision words in shared memory: "
                     f"Tx={tx}, Ty={ty} does not fit in {SMEM_LIMIT} bytes")


@functools.cache
def _entries():
    """The kernel's C entries (the fused MAS and the chain probe), built and
    loaded on first use."""
    lib = _build.library("mas")
    path, probe = lib.mas_path, lib.mas_chain_probe
    path.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    path.restype = probe.restype = ctypes.c_int
    return path, probe


def _check_lengths(t_x, t_y, b, dev):
    for name, t in (("t_x", t_x), ("t_y", t_y)):
        if t.shape != (b,) or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name} must be ({b},) int32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def mas_cuda(value: torch.Tensor, mask: torch.Tensor, t_x: torch.Tensor, t_y: torch.Tensor,
             with_bits: bool = False):
    """Launch the fused kernel: value, mask (B, Tx, Ty) contiguous, each float32
    or bfloat16, on a CUDA device; t_x, t_y (B,) int32 there -> the (B, Tx, Ty)
    path in value's dtype (mask's value on the path, 0 elsewhere).

    with_bits (the checks only) also returns the take-diagonal decisions as
    (B, Ty, ceil(Tx/32)) int32 words, bit i of word w = text position 32w + i,
    frames at or past t_y unwritten (`unpack_words` reads them)."""
    if not (value.is_cuda and mask.is_cuda):
        raise ValueError("mas_cuda needs value and mask on a CUDA device")
    if value.dim() != 3 or mask.shape != value.shape or mask.device != value.device:
        raise ValueError(f"mas_cuda takes value and mask of one (B, Tx, Ty) shape, got "
                         f"{tuple(value.shape)} and {tuple(mask.shape)}")
    if value.dtype not in _DTYPES or mask.dtype not in _DTYPES:
        raise ValueError(f"mas_cuda takes float32 or bfloat16, got {value.dtype}, {mask.dtype}")
    if not (value.is_contiguous() and mask.is_contiguous()):
        raise ValueError("mas_cuda takes contiguous value and mask")
    b, tx_max, ty_max = value.shape
    if b < 1:
        raise ValueError("mas_cuda takes at least one utterance")
    plan = mas_plan(tx_max, ty_max)
    _check_lengths(t_x, t_y, b, value.device)
    path = torch.empty_like(value)
    bits = (torch.empty((b, ty_max, (tx_max + 31) // 32), device=value.device,
                        dtype=torch.int32) if with_bits else None)
    entry, _ = _entries()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = entry(value.data_ptr(), mask.data_ptr(), t_x.data_ptr(), t_y.data_ptr(),
                   path.data_ptr(), None if bits is None else bits.data_ptr(), b, tx_max, ty_max,
                   _DTYPES[value.dtype], _DTYPES[mask.dtype], plan.cells, plan.frames,
                   plan.stages, stream)
    if rc != 0:
        raise RuntimeError(f"MAS kernel launch failed: CUDA error {rc}")
    mas_cuda.launches += 1
    return (path, bits) if with_bits else path


mas_cuda.launches = 0


def chain_probe(steps: int, device) -> torch.Tensor:
    """Launch the chain probe of `csrc/mas.cu` on `device`: one thread, `steps`
    dependent steps of the recursion (a max and an add). Its time over steps
    is the chain's latency L of the kernel's bound. Counted toward no path."""
    out = torch.empty(1, device=device, dtype=torch.float32)
    _, probe = _entries()
    with torch.cuda.device(out.device):
        rc = probe(out.data_ptr(), int(steps), torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"MAS chain probe launch failed: CUDA error {rc}")
    return out


def unpack_words(words: torch.Tensor, tx_max: int) -> torch.Tensor:
    """Decision words (B, Ty, W) int32, `mas_cuda(with_bits=True)`'s layout -> bits (B, Ty, Tx) bool."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.flatten(2)[..., :tx_max].bool()


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bits (B, Ty, Tx) bool -> (B, Ty, ceil(Tx/32)) int32 words, bit i of word w = position 32w + i."""
    b, ty, tx = bits.shape
    n = (tx + 31) // 32
    padded = torch.zeros((b, ty, n * 32), device=bits.device, dtype=torch.int64)
    padded[..., :tx] = bits.to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (padded.view(b, ty, n, 32) << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _lengths(value, mask, t_x, t_y):
    """int32 lengths on value's device, from the mask when not given."""
    if t_x is None or t_y is None:
        dx, dy = lengths_from_mask(mask)
        t_x = dx if t_x is None else t_x
        t_y = dy if t_y is None else t_y
    return (t_x.to(device=value.device, dtype=torch.int32),
            t_y.to(device=value.device, dtype=torch.int32))


@torch.no_grad()
def maximum_path_plain(value: torch.Tensor, mask: torch.Tensor,
                       t_x: Optional[torch.Tensor] = None, t_y: Optional[torch.Tensor] = None):
    """The plain version of `maximum_path`, on any device."""
    t_x, t_y = _lengths(value, mask, t_x, t_y)
    score = (value * mask).float().transpose(1, 2).contiguous()
    path = mas_backtrack_plain(mas_forward_plain(score, t_x, t_y), t_x, t_y)
    return (path * mask).to(value.dtype)


@torch.no_grad()
def maximum_path(value: torch.Tensor, mask: torch.Tensor,
                 t_x: Optional[torch.Tensor] = None, t_y: Optional[torch.Tensor] = None):
    """Batch MAS. value, mask (B, Tx, Ty); t_x, t_y (B,) lengths, derived from
    the mask when not given. Returns the (B, Tx, Ty) path in value's dtype:
    the mask's value on the path, 0 elsewhere. On a CUDA device with int32
    lengths there, one kernel launch and nothing else.

    Precondition, as in the reference: t_y >= t_x per sample.
    """
    if value.device.type == "cpu":
        return maximum_path_plain(value, mask, t_x, t_y)
    return mas_cuda(value, mask, *_lengths(value, mask, t_x, t_y))
