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

The backward replaces `attention_pallas.py::_attn_bwd_kernel` (wrapper
`_fused_attention_bwd`, custom_vjp `_attention_core`): `attention` is a
`torch.autograd.Function` that saves only q, k, v and the bias, as the TPU's
custom_vjp does, and recomputes the softmax in its backward. On CUDA tensors
the backward is kernel K4 (`csrc/attention_bwd.cu`): three launches (row
statistics, then dk/dv/dbias by key tile, then dq by query tile), each counted
in `attention_backward.launches`; on CPU tensors it is `attention_bwd_plain`.
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


def _check_inputs(q, k, v, bias: Optional[torch.Tensor], who: str) -> None:
    """Raise on what K1 and K4 do not take."""
    b, h, t, d = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{who} needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{who} takes f32 or bf16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape or d != _HEAD_DIM:
        raise ValueError(f"{who} takes equal (B, H, T, {_HEAD_DIM}) q/k/v, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{who} takes contiguous q, k, v")
    if any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError(f"{who} takes q, k, v starting on 16-byte boundaries")
    if bias is not None and (bias.shape != (b, t) or bias.device != q.device
                             or bias.dtype != q.dtype or bias.stride(1) != 1):
        # a row-strided view (the decoder's truncated masks) is read in place
        raise ValueError(f"bias must be ({b}, {t}) {q.dtype} on {q.device} with unit key "
                         f"stride, got {tuple(bias.shape)} {bias.dtype} on {bias.device} "
                         f"with strides {bias.stride()}")


def attention_cuda(q, k, v, bias: Optional[torch.Tensor], scale: float):
    """Launch K1 on CUDA tensors. Raises on what the kernel does not take."""
    _check_inputs(q, k, v, bias, "attention_cuda")
    b, h, t, d = q.shape
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


def attention_forward(q, k, v, bias: Optional[torch.Tensor], scale: float):
    """The forward without autograd: plain on CPU tensors, K1 otherwise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, scale)
    return attention_cuda(q, k, v, bias, scale)


def attention_bwd_plain(q, k, v, bias: Optional[torch.Tensor], do, scale: float):
    """(dq, dk, dv, dbias) of `attention_plain`, step by step as the TPU kernel.

    The softmax is recomputed in f32; p and ds are rounded to the activation
    dtype where they enter a product; ds = p * (dp - rowsum(dp * p)) with p
    in f32. dbias (B, T) is f32, summed over queries and heads.
    """
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", dsc, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dsc, qf) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=2).sum(dim=1)


@functools.cache
def _bwd_entries():
    """K4's three C entries, built and loaded on first use."""
    lib = _build.library("attention_bwd")
    head = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    stats, dkdv, dq = lib.attention_bwd_stats, lib.attention_bwd_dkdv, lib.attention_bwd_dq
    stats.argtypes = head + [ctypes.c_void_p] + tail
    dkdv.argtypes = head + [ctypes.c_void_p] * 4 + tail
    dq.argtypes = head + [ctypes.c_void_p] * 2 + tail
    stats.restype = dkdv.restype = dq.restype = ctypes.c_int
    return stats, dkdv, dq


def attention_bwd_cuda(q, k, v, bias: Optional[torch.Tensor], do, scale: float,
                       need_dbias: bool = True):
    """Launch K4 on CUDA tensors: (dq, dk, dv, dbias or None), dbias (B, T) f32."""
    if not (do.is_cuda and do.device == q.device):
        raise ValueError("attention_bwd_cuda needs do on the CUDA device of q")
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError(f"do must be contiguous {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    if do.data_ptr() % 16:
        raise ValueError("attention_bwd_cuda takes do starting on a 16-byte boundary")
    _check_inputs(q, k, v, bias, "attention_bwd_cuda")
    b, h, t, d = q.shape
    stats = torch.empty((3, b * h, t), device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias_h = (torch.empty((b, h, t), device=q.device, dtype=torch.float32)
               if need_dbias else None)
    bias_ptr = None if bias is None else bias.data_ptr()
    bias_stride = 0 if bias is None else bias.stride(0)
    common = (b, h, t, d, float(scale), _DTYPES[q.dtype])
    f_stats, f_dkdv, f_dq = _bwd_entries()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, bias_stride,
                  do.data_ptr())
        for name, fn, outs in (
                ("stats", f_stats, (stats.data_ptr(),)),
                ("dkdv", f_dkdv, (stats.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                  None if dbias_h is None else dbias_h.data_ptr())),
                ("dq", f_dq, (stats.data_ptr(), dq.data_ptr()))):
            rc = fn(*inputs, *outs, *common, stream)
            if rc != 0:
                raise RuntimeError(f"attention_bwd {name} kernel launch failed: CUDA error {rc}")
            attention_backward.launches += 1
    return dq, dk, dv, None if dbias_h is None else dbias_h.sum(dim=1)


def attention_backward(q, k, v, bias: Optional[torch.Tensor], do, scale: float,
                       need_dbias: bool = True):
    """(dq, dk, dv, dbias): plain on CPU tensors, K4 otherwise; dbias (B, T) f32."""
    if q.device.type == "cpu":
        dq, dk, dv, dbias = attention_bwd_plain(q, k, v, bias, do, scale)
        return dq, dk, dv, dbias if need_dbias else None
    return attention_bwd_cuda(q, k, v, bias, do, scale, need_dbias)


attention_backward.launches = 0


class _Attention(torch.autograd.Function):
    """Forward K1 (or plain), backward K4 (or plain); saves q, k, v and bias only."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return attention_forward(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = attention_backward(q, k, v, bias, do.contiguous(), ctx.scale,
                                               need_dbias)
        return dq, dk, dv, None if dbias is None else dbias.to(bias.dtype), None


def attention(q, k, v, bias: Optional[torch.Tensor] = None, scale: float = 1.0):
    """Fused attention; q, k, v (B, H, T, D), bias (B, T) added to the logits.
    Differentiable in q, k, v and bias."""
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (q, k, v, bias)):
        return _Attention.apply(q, k, v, bias, scale)
    return attention_forward(q, k, v, bias, scale)


attention.launches = 0
