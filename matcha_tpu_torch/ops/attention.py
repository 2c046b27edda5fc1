"""Decoder self-attention with an additive per-key bias: kernel K1 and its plain version.

Replaces the TPU kernel `matcha_tpu/ops/attention_pallas.py::_attn_kernel`
(wrappers `_fused_attention`, `fused_attention`). The CUDA kernel
(`csrc/attention_fwd.cu`) is flash-style: one block per (64-query tile,
batch*head), 64-key tiles of K and V in shared memory, online softmax in f32
registers, so the (T, T) score matrix never exists. Its bound at the decoder's
shapes (H = 4, D = 64, T <= 1024) is operations: 4*B*H*T^2*D flops against
4*B*H*T*D elements moved. In bf16 at D = 64 both products run on the tensor
cores (mma.sync); in f32 as FMAs on the CUDA cores.

`attention` takes its path from the tensors: the plain PyTorch version for CPU
tensors, the kernel for CUDA tensors (or an exception). `attention.launches`
counts kernel launches.
"""

import ctypes
import functools
from typing import Optional

import torch

from matcha_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64


def attention_plain(q, k, v, bias: Optional[torch.Tensor], scale: float):
    """softmax(q k^T * scale + bias[:, None, None, :]) v with scores and softmax in f32.

    q, k, v: (B, H, T, D); bias: (B, T) or None. Returns q's dtype.
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


@functools.cache
def _entry():
    """The kernel's C entry, built and loaded on first use."""
    fn = _build.library("attention_fwd").attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p] + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention_cuda(q, k, v, bias: Optional[torch.Tensor], scale: float):
    """Launch K1 on CUDA tensors. Raises on what the kernel does not take."""
    b, h, t, d = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention_cuda needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention_cuda takes f32 or bf16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape or d != _HEAD_DIM:
        raise ValueError(f"attention_cuda takes equal (B, H, T, {_HEAD_DIM}) q/k/v, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention_cuda takes contiguous q, k, v")
    if any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("attention_cuda takes q, k, v starting on 16-byte boundaries")
    if bias is not None and (bias.shape != (b, t) or bias.device != q.device
                             or bias.dtype != q.dtype or bias.stride(1) != 1):
        # a row-strided view (the decoder's truncated masks) is read in place
        raise ValueError(f"bias must be ({b}, {t}) {q.dtype} on {q.device} with unit key "
                         f"stride, got {tuple(bias.shape)} {bias.dtype} on {bias.device} "
                         f"with strides {bias.stride()}")
    out = torch.empty_like(q)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(),
                0 if bias is None else bias.stride(0), out.data_ptr(),
                b, h, t, d, float(scale), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error {rc}")
    attention.launches += 1
    return out


def attention(q, k, v, bias: Optional[torch.Tensor] = None, scale: float = 1.0):
    """Fused attention; q, k, v (B, H, T, D), bias (B, T) added to the logits."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, scale)
    return attention_cuda(q, k, v, bias, scale)


attention.launches = 0
