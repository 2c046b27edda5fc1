"""One HiFi-GAN MRF dilation step: kernel K2 and its plain version.

    out = x + conv_k1(lrelu(conv_kd(lrelu(x)) + b1)) + b2,   lrelu slope 0.1

Replaces the TPU kernel `matcha_tpu/ops/mrf_pallas.py::_mrf_kernel` (wrappers
`_fused_mrf`, `fused_mrf_step`). The CUDA kernel (`csrc/mrf_step.cu`) takes
any T: one block per (time tile, batch row) stages lrelu(x) over the tile and
its halo, then lrelu(conv_kd + b1) over the tile +- (k-1)/2, in shared memory,
and writes conv_k1 + b2 + x for the tile. It is bound by operations
(4*C^2*k flops per frame against 2*C elements moved): in bf16 both convs run
as implicit GEMMs on the tensor cores (mma.sync), in f32 as FMAs on the CUDA
cores.

Layout: channels-first (B, C, T); weights in the torch Conv1d layout
(C_out, C_in, k). The kernel reads both weights packed tap-major
(`pack_weights`), so a caller that steps with the same weights many times
(`ResBlock1`) packs them once and passes `packed`. `mrf_step` takes its path
from the tensors: the plain PyTorch version for CPU tensors, the kernel for
CUDA tensors (or an exception). `mrf_step.launches` counts kernel launches.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from matcha_tpu_torch.ops import _build

LRELU_SLOPE = 0.1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 7, 11)


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


def pack_weights(w1, w2):
    """Both convs' (C_out, C_in, k) weights -> one contiguous (2, C_out, k, C_in)
    tensor, the layout the kernel reads."""
    return torch.stack((w1.detach(), w2.detach())).transpose(2, 3).contiguous()


@functools.cache
def _entry():
    """The kernel's C entry, built and loaded on first use."""
    fn = _build.library("mrf_step").mrf_step
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mrf_step_cuda(x, w1, b1, w2, b2, dilation: int, packed=None):
    """Launch K2 on CUDA tensors. Raises on what the kernel does not take.

    `packed` is `pack_weights(w1, w2)`; without it the weights are packed here.
    """
    b, c, t = x.shape
    k = w1.shape[-1]
    tensors = (x, w1, b1, w2, b2) + (() if packed is None else (packed,))
    if not all(a.is_cuda and a.device == x.device for a in tensors):
        raise ValueError("mrf_step_cuda needs every tensor on one CUDA device")
    if x.dtype not in _DTYPES or any(a.dtype != x.dtype for a in tensors):
        raise ValueError(f"mrf_step_cuda takes f32 or bf16 tensors of one dtype, got "
                         f"{[str(a.dtype) for a in tensors]}")
    if (k not in _KERNEL_SIZES or c % 32 or w1.shape != (c, c, k) or w2.shape != (c, c, k)
            or b1.shape != (c,) or b2.shape != (c,)
            or (packed is not None and packed.shape != (2, c, k, c))):
        raise ValueError(f"mrf_step_cuda takes x (B, C, T) with C % 32 == 0, weights "
                         f"(C, C, k) with k in {_KERNEL_SIZES}, biases (C,) and packed "
                         f"weights (2, C, k, C); got {[tuple(a.shape) for a in tensors]}")
    if packed is None:
        packed = pack_weights(w1, w2)
    if not all(a.is_contiguous() for a in (x, b1, b2, packed)):
        raise ValueError("mrf_step_cuda takes contiguous x, biases and packed weights")
    out = torch.empty_like(x)
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), packed.data_ptr(), b1.data_ptr(), b2.data_ptr(), out.data_ptr(),
                b, c, t, k, int(dilation), _DTYPES[x.dtype], stream)
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
