"""Decoder self-attention with an additive per-key bias: kernels K1 and K4 and their plain versions.

K1 replaces the TPU kernel `matcha_tpu/ops/attention_pallas.py::_attn_kernel`
(wrappers `_fused_attention`, `fused_attention`). The CUDA kernel
(`csrc/attention_fwd.cu`) is flash-style: one block per (64-query tile,
batch*head), 64-key tiles of K and V streamed through shared memory by
cp.async, online softmax in f32 registers, so the (T, T) score matrix never
exists. When the grid leaves SMs idle (batch 1 serving), each row's keys are
split over the blocks of a thread-block cluster, which combine their partial
results through distributed shared memory, in one launch. Its bound at the
decoder's shapes (H = 4, D = 64, T <= 1024) is operations: 4*B*H*T^2*D flops
against 4*B*H*T*D elements moved. Both dtypes run on the tensor cores: bf16
as mma.sync m16n8k16, f32 as three TF32 products a product (big*big +
big*small + small*big), which keeps about f32 accuracy
(`csrc/attention_tiles.cuh`).

`attention` takes its path from the tensors: the plain PyTorch version for CPU
tensors, the kernel for CUDA tensors (or an exception). `attention.launches`
counts kernel launches.

K4 replaces `attention_pallas.py::_attn_bwd_kernel` (wrapper
`_fused_attention_bwd`, custom_vjp `_attention_core`): `attention` is a
`torch.autograd.Function` whose forward also computes the row log-sum-exp
`lse` (f32, (B, H, T)) and saves q, k, v, the bias, the output o and lse. The
TPU's custom_vjp saves only q, k, v and the bias and recomputes the softmax;
here the backward takes p = exp(s - lse) tile by tile and D = rowsum(do * o),
at the cost of keeping o and lse until the backward. On CUDA tensors the
backward is K4 (`csrc/attention_bwd.cu`): two launches (dq by query tile,
which also writes D; then dk/dv/dbias by key tile), each counted in
`attention_backward.launches`; on CPU tensors it is `attention_bwd_plain`.
"""

import ctypes
import functools
from typing import Optional

import torch

from matcha_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64
_TILE = 64
_MAX_SPLITS = 8  # blocks of a thread-block cluster, the portable limit


def _scores(q, k, bias: Optional[torch.Tensor], scale: float):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    return s


def attention_plain(q, k, v, bias: Optional[torch.Tensor], scale: float, with_lse: bool = False):
    """softmax(q k^T * scale + bias[:, None, None, :]) v with scores and softmax in f32.

    q, k, v: (B, H, T, D); bias: (B, T) or None. Returns q's dtype, and with
    `with_lse` also the row log-sum-exp of the scores, (B, H, T) f32.
    """
    s = _scores(q, k, bias, scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if with_lse else o


@functools.cache
def _entry():
    """The kernel's C entry, built and loaded on first use."""
    fn = _build.library("attention_fwd").attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def key_splits(b: int, h: int, t: int, dtype: torch.dtype, sms: int) -> int:
    """Key ranges per query tile of K1, a power of two of at least 2 key
    tiles each, for a card of `sms` SMs. A split costs a cluster barrier and
    a combine, so it pays only where each block walks many tiles on a grid
    that leaves SMs idle. Measured on the H100 (`tools/tune_key_splits.py`):
    bf16 gains from splitting blocks of 8 tiles or more, up to one wave;
    f32, whose tiles carry three TF32 products, from 4 tiles, up to two."""
    tiles = -(-t // _TILE)
    f32 = dtype == torch.float32
    if tiles < (4 if f32 else 8):
        return 1
    s = min(tiles // 2, (2 if f32 else 1) * sms // (tiles * b * h), _MAX_SPLITS)
    return 1 << (s.bit_length() - 1) if s > 1 else 1


def attention_cuda(q, k, v, bias: Optional[torch.Tensor], scale: float, with_lse: bool = False):
    """Launch K1 on CUDA tensors: o, and with `with_lse` also lse (B, H, T) f32.
    Raises on what the kernel does not take."""
    _check_inputs(q, k, v, bias, "attention_cuda")
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32) if with_lse else None
    splits = key_splits(b, h, t, q.dtype, _sm_count(q.device))
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(),
                0 if bias is None else bias.stride(0), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                b, h, t, d, float(scale), splits, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error {rc}")
    attention.launches += 1
    return (out, lse) if with_lse else out


def attention_forward(q, k, v, bias: Optional[torch.Tensor], scale: float,
                      with_lse: bool = False):
    """The forward without autograd: plain on CPU tensors, K1 otherwise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, scale, with_lse)
    return attention_cuda(q, k, v, bias, scale, with_lse)


def attention_bwd_plain(q, k, v, bias: Optional[torch.Tensor], do, o, lse, scale: float):
    """(dq, dk, dv, dbias) of `attention_plain`, step by step as K4.

    p = exp(s - lse) in f32 from the forward's lse; D = rowsum(do * o) in f32
    from the forward's output o; ds = p * (dp - D). p and ds are rounded to the
    activation dtype where they enter a product, as the TPU kernel rounds
    them. dbias (B, T) is f32, summed over queries and heads.
    """
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(_scores(q, k, bias, scale) - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - (dof * o.float()).sum(dim=-1, keepdim=True))
    dsc = ds.to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", dsc, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dsc, qf) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=2).sum(dim=1)


@functools.cache
def _bwd_entries():
    """K4's two C entries, built and loaded on first use."""
    lib = _build.library("attention_bwd")
    head = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    dq, dkdv = lib.attention_bwd_dq, lib.attention_bwd_dkdv
    dq.argtypes = head + [ctypes.c_void_p] * 4 + tail
    dkdv.argtypes = head + [ctypes.c_void_p] * 5 + tail
    dq.restype = dkdv.restype = ctypes.c_int
    return dq, dkdv


def attention_bwd_cuda(q, k, v, bias: Optional[torch.Tensor], do, o, lse, scale: float,
                       need_dbias: bool = True):
    """Launch K4 on CUDA tensors: (dq, dk, dv, dbias or None), dbias (B, T) f32."""
    _check_inputs(q, k, v, bias, "attention_bwd_cuda")
    for name, a in (("do", do), ("o", o)):
        if a.device != q.device or a.shape != q.shape or a.dtype != q.dtype \
                or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous {tuple(q.shape)} {q.dtype} on "
                             f"{q.device} from a 16-byte boundary, got {tuple(a.shape)} "
                             f"{a.dtype} on {a.device}")
    b, h, t, d = q.shape
    if lse.device != q.device or lse.shape != (b, h, t) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous ({b}, {h}, {t}) float32 on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    delta = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias_h = (torch.empty((b, h, t), device=q.device, dtype=torch.float32)
               if need_dbias else None)
    common = (b, h, t, d, float(scale), _DTYPES[q.dtype])
    f_dq, f_dkdv = _bwd_entries()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if bias is None else bias.data_ptr(),
                  0 if bias is None else bias.stride(0), do.data_ptr())
        for name, fn, rest in (
                ("dq", f_dq, (o.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr())),
                ("dkdv", f_dkdv, (lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr(),
                                  None if dbias_h is None else dbias_h.data_ptr()))):
            rc = fn(*inputs, *rest, *common, stream)
            if rc != 0:
                raise RuntimeError(f"attention_bwd {name} kernel launch failed: CUDA error {rc}")
            attention_backward.launches += 1
    return dq, dk, dv, None if dbias_h is None else dbias_h.sum(dim=1)


def attention_backward(q, k, v, bias: Optional[torch.Tensor], do, o, lse, scale: float,
                       need_dbias: bool = True):
    """(dq, dk, dv, dbias): plain on CPU tensors, K4 otherwise; dbias (B, T) f32."""
    if q.device.type == "cpu":
        dq, dk, dv, dbias = attention_bwd_plain(q, k, v, bias, do, o, lse, scale)
        return dq, dk, dv, dbias if need_dbias else None
    return attention_bwd_cuda(q, k, v, bias, do, o, lse, scale, need_dbias)


attention_backward.launches = 0


class _Attention(torch.autograd.Function):
    """Forward K1 (or plain) with lse, backward K4 (or plain); saves q, k, v,
    the bias, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        o, lse = attention_forward(q, k, v, bias, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = attention_backward(q, k, v, bias, do.contiguous(), o, lse,
                                               ctx.scale, need_dbias)
        return dq, dk, dv, None if dbias is None else dbias.to(bias.dtype), None


def attention(q, k, v, bias: Optional[torch.Tensor] = None, scale: float = 1.0):
    """Fused attention; q, k, v (B, H, T, D), bias (B, T) added to the logits.
    Differentiable in q, k, v and bias."""
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (q, k, v, bias)):
        return _Attention.apply(q, k, v, bias, scale)
    return attention_forward(q, k, v, bias, scale)


attention.launches = 0
