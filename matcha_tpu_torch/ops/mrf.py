"""One HiFi-GAN MRF dilation step: kernel K2 and its plain version.

    out = x + conv_k1(lrelu(conv_kd(lrelu(x)) + b1)) + b2,   lrelu slope 0.1

Replaces the TPU kernel `matcha_tpu/ops/mrf_pallas.py::_mrf_kernel` (wrappers
`_fused_mrf`, `fused_mrf_step`). The CUDA kernel (`csrc/mrf_step.cu`) takes
any T: one block per (time tile, batch row) stages lrelu(x) over the tile and
its halo in shared memory, computes z = lrelu(conv_kd(lrelu(x)) + b1) over the
tile +- (k-1)/2 and then conv_k1 + b2 + x for the tile, both convs as implicit
GEMMs on the tensor cores (frames as M, output channels as N): wgmma in bf16,
three TF32 mma.sync products in f32. A producer warp streams the weights into
a ring of shared-memory stages with bulk copies. `mrf_plan` sizes the tiles
and the weight chunks (measured by `tools/tune_mrf_plans.py`); the kernel
checks the plan against its own arithmetic.

Layout: channels-first (B, C, T); weights in the torch Conv1d layout
(C_out, C_in, k). The kernel reads both weights packed (`pack_weights`), so a
caller that steps with the same weights many times (`ResBlock1`) packs them
once and passes `packed`. `mrf_step` takes its path from the tensors: the
plain PyTorch version for CPU tensors, the kernel for CUDA tensors (or an
exception). `mrf_step.launches` counts kernel launches.
"""

import ctypes
import functools
from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F

from matcha_tpu_torch.ops import _build

LRELU_SLOPE = 0.1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 7, 11)
_CHANNELS = (32, 64, 128, 256)

SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
H100_SMS = 132
_WARPS = 8  # compute warps a block (and one producer warp)
# z frames a block can tile (csrc/mrf_step.cu's instantiations), largest first.
# bf16 (wgmma): two warpgroups of 64 MI frames by NW channels (NW = min(C,
# 128), and 64 for C = 128's 64-frame tile); f32 (mma.sync): 8 warps of WM
# frames by min(C, 64) channels, WM 32 or 16.
_BF16_Z_FRAMES = {256: (128, 64), 128: (256, 128, 64), 64: (512, 256, 128), 32: (512, 256)}


def _z_frames(c: int, elt: int):
    if elt == 2:
        return _BF16_Z_FRAMES[c]
    return [wm * _WARPS // (c // min(c, 64)) for wm in (32, 16)]


# stages of the weight ring
_STAGES = (2, 3)
# (element bytes, C) -> the z frames and weight chunk bytes a launch prefers
# (None: a whole conv's row), from tools/tune_mrf_plans.py on an H100 at the
# serving shapes: larger z tiles recompute less of the halo, smaller ones let
# 2-3 blocks share an SM, and larger chunks mean fewer waits on the ring
_PREFERRED = {(2, 256): (64, 128), (2, 128): (128, 256), (2, 64): (256, 512),
              (2, 32): (256, None), (4, 256): (32, 128), (4, 128): (64, 256),
              (4, 64): (128, 512), (4, 32): (256, None)}


def _chunks(c: int, k: int, elt: int):
    """Bytes of each output channel's weight row a ring stage can hold, largest
    first: a whole conv's row, or 1024 down to 128 (bf16 also 64: 32 bf16
    channels), in the steps the kernel takes (32 bytes in bf16, 128 in f32)."""
    row = k * c * elt
    sizes = [row] + [b for b in (1024, 512, 256, 128, 64) if b < row]
    return [b for b in sizes if b % (32 if elt == 2 else 128) == 0]


def mrf_step_plain(x, w1, b1, w2, b2, dilation: int):
    """The dilation step in f32 with torch convolutions; returns x's dtype."""
    k = w1.shape[-1]
    xf = x.float()
    h = F.leaky_relu(xf, LRELU_SLOPE)
    h = F.conv1d(h, w1.float(), b1.float(), padding=dilation * (k - 1) // 2,
                 dilation=dilation)
    h = F.leaky_relu(h, LRELU_SLOPE)
    h = F.conv1d(h, w2.float(), b2.float(), padding=(k - 1) // 2)
    return (xf + h).to(x.dtype)


@dataclass(frozen=True)
class MrfPlan:
    """K2's tiling of one launch, as `csrc/mrf_step.cu` derives it (struct Plan).

    lz frames of z and tt output frames a block; chunk bytes of each output
    channel's weight row a ring stage holds (the last chunk of a conv may hold
    less); stages of the ring; smem bytes of shared memory; blocks of the grid.
    """

    lz: int
    tt: int
    chunk: int
    stages: int
    smem: int
    blocks: int


def _smem_bytes(c, k, d, elt, lz, tt, chunk, stages):
    """Shared memory of a plan (struct Plan in csrc/mrf_step.cu): the weight
    ring; lrelu(x) with its halo and z, time-major; x over the tile,
    channel-major; two mbarriers a stage."""
    groups = c * elt // 16  # 16-byte channel groups, each an odd number of frames long
    xs = groups * ((lz + (k - 1) * d) | 1) * 16
    zs = groups * ((lz + k - 1) | 1) * 16
    xr = c * ((tt * elt + 127) // 128 * 128 + 16)
    return stages * c * chunk + xs + zs + xr + 16 * stages


def mrf_plans(b: int, c: int, t: int, k: int, d: int, elt: int) -> List[MrfPlan]:
    """The tile plans of one K2 launch on (b, c, t) activations of `elt`-byte
    elements that fit in shared memory, largest tile first.

    Each z tile the kernel has (`_z_frames`: lz frames) yields tt = lz - (k-1)
    output frames, rounded down to 8 (so that blocks start on 16-byte
    boundaries), with each weight chunk (`_chunks`) and ring depth
    (`_STAGES`) that fits beside it.
    """
    if c not in _CHANNELS or k not in _KERNEL_SIZES or elt not in (2, 4):
        raise ValueError(f"K2 takes C in {_CHANNELS}, k in {_KERNEL_SIZES} and bf16 or f32; "
                         f"got C={c}, k={k}, {elt}-byte elements")
    fits = []
    for lz in _z_frames(c, elt):
        tt = (lz - (k - 1)) // 8 * 8
        if tt < 8:
            continue
        for chunk in _chunks(c, k, elt):
            for stages in _STAGES:
                smem = _smem_bytes(c, k, d, elt, lz, tt, chunk, stages)
                if smem <= SMEM_LIMIT:
                    fits.append(MrfPlan(lz, tt, chunk, stages, smem, b * -(-t // tt)))
    if not fits:
        raise ValueError(f"no K2 tile plan fits C={c}, k={k}, d={d} in shared memory")
    return fits


def mrf_plan(b: int, c: int, t: int, k: int, d: int, elt: int, sms: int = H100_SMS) -> MrfPlan:
    """The tile plan of one K2 launch, for a card of `sms` multiprocessors.

    Of the plans with a 2-stage ring and no more than the preferred z frames
    and chunk (`_PREFERRED`), the largest tile whose grid still covers the
    card (or, when even the smallest cannot, gives as many blocks as the
    smallest), with the largest chunk.
    """
    lz_max, chunk_max = _PREFERRED[(elt, c)]
    chunk_max = chunk_max or k * c * elt
    fits = mrf_plans(b, c, t, k, d, elt)
    want = min(sms, max(p.blocks for p in fits))
    ok = [p for p in fits if p.stages == 2 and p.lz <= lz_max and p.chunk <= chunk_max] or fits
    ok = [p for p in ok if p.blocks >= want] or ok
    return max(ok, key=lambda p: (p.lz, p.chunk, -p.stages))


def pack_weights(w1, w2):
    """Both convs' (C_out, C_in, k) weights -> one contiguous (2, units, C_out,
    16 / element size) tensor, the order the kernel streams them in.

    Each output channel's row is tap-major, (k, C_in) flattened, and cut into
    16-byte units; unit u of every output channel comes before unit u + 1
    (the tensor cores' core-matrix layout), so that a chunk of any number of
    units is one contiguous copy.
    """
    c, _, k = w1.shape
    per = 16 // w1.element_size()
    w = torch.stack((w1.detach(), w2.detach())).transpose(2, 3)  # (2, C_out, k, C_in)
    return w.reshape(2, c, -1, per).transpose(1, 2).contiguous()


@functools.cache
def _entry():
    """The kernel's C entry, built and loaded on first use."""
    fn = _build.library("mrf_step").mrf_step
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _packed_shape(c, k, elt):
    return (2, k * c * elt // 16, c, 16 // elt)


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mrf_step_cuda(x, w1, b1, w2, b2, dilation: int, packed=None, plan=None):
    """Launch K2 on CUDA tensors. Raises on what the kernel does not take.

    `packed` is `pack_weights(w1, w2)`; without it the weights are packed here.
    `plan` (one of `mrf_plans`) overrides `mrf_plan`'s choice, for tuning.
    """
    b, c, t = x.shape
    k = w1.shape[-1]
    tensors = (x, w1, b1, w2, b2) + (() if packed is None else (packed,))
    if not all(a.is_cuda and a.device == x.device for a in tensors):
        raise ValueError("mrf_step_cuda needs every tensor on one CUDA device")
    if x.dtype not in _DTYPES or any(a.dtype != x.dtype for a in tensors):
        raise ValueError(f"mrf_step_cuda takes f32 or bf16 tensors of one dtype, got "
                         f"{[str(a.dtype) for a in tensors]}")
    if (k not in _KERNEL_SIZES or c not in _CHANNELS or w1.shape != (c, c, k)
            or w2.shape != (c, c, k) or b1.shape != (c,) or b2.shape != (c,)
            or (packed is not None and packed.shape != _packed_shape(c, k, x.element_size()))):
        raise ValueError(f"mrf_step_cuda takes x (B, C, T) with C in {_CHANNELS}, weights "
                         f"(C, C, k) with k in {_KERNEL_SIZES}, biases (C,) and packed "
                         f"weights as pack_weights makes them; got "
                         f"{[tuple(a.shape) for a in tensors]}")
    if packed is None:
        packed = pack_weights(w1, w2)
    if not all(a.is_contiguous() for a in (x, b1, b2, packed)):
        raise ValueError("mrf_step_cuda takes contiguous x, biases and packed weights")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("mrf_step_cuda reads x and the packed weights 16 bytes at a time: "
                         "their storage must start on a 16-byte boundary")
    if plan is None:
        plan = mrf_plan(b, c, t, k, int(dilation), x.element_size(), _sm_count(x.device))
    out = torch.empty_like(x)
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), packed.data_ptr(), b1.data_ptr(), b2.data_ptr(), out.data_ptr(),
                b, c, t, k, int(dilation), _DTYPES[x.dtype], plan.lz, plan.tt, plan.chunk,
                plan.stages, stream)
    if rc != 0:
        raise RuntimeError(f"mrf_step kernel launch failed: CUDA error {rc}")
    mrf_step.launches += 1
    return out


def mrf_step(x, w1, b1, w2, b2, dilation: int, packed=None):
    """One fused MRF dilation step on (B, C, T) activations; `packed`, if
    given, is `pack_weights(w1, w2)` for the kernel."""
    if x.device.type == "cpu":
        return mrf_step_plain(x, w1, b1, w2, b2, dilation)
    return mrf_step_cuda(x, w1, b1, w2, b2, dilation, packed)


mrf_step.launches = 0
