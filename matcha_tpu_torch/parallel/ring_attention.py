"""Ring (blockwise) self-attention over a process group of sequence shards.

The port of `matcha_tpu/parallel/ring_attention.py`. Each rank holds the
queries, keys and values of its block of frames; K, V and the 0/1 key bias
travel one hop around the ring a step (`dist.batch_isend_irecv`, to rank + 1,
from rank - 1), so after n steps every rank has seen every key block and no
rank holds the (T, T) scores or the gathered K/V. The decoder's quirk stays:
the bias is the raw 0/1 key mask added to the scaled logits.

A block step takes its path from the tensors:
  * CPU tensors: the JAX online update (`_online_block_update`: running max,
    normaliser and output in f32, a block at a time);
  * CUDA tensors: K1 (`ops/attention.py`, `with_lse=True`) on the local
    queries against the visiting block, which gives the block's output o_i
    and row log-sum-exp lse_i; the partials merge in f32 by their
    log-sum-exps. K1 rounds each o_i to the activation dtype, where JAX
    carries f32, so bf16 is held to K1's bf16 bar.
The rotation after the last step, which JAX keeps to give its loop a uniform
body, is skipped: n - 1 hops a call.
"""

import math
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from matcha_tpu_torch.ops.attention import attention_cuda


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _online_block_update(q, k_blk, v_blk, bias_blk, m, l, o, scale):
    """One flash-style step over a key block, in f32: q (B, H, Tq, D),
    k_blk/v_blk (B, H, Tk, D), bias_blk (B, Tk) additive; m, l (B, H, Tq)
    running max and normaliser, o (B, H, Tq, D)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * scale
    s = s + bias_blk[:, None, None, :].to(s.dtype)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # the bias is 0/1, never -inf, so m_new is finite
    correction = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk)
    return m_new, l_new, o_new


def ring_attention_local(q, blocks: Iterable, scale: Optional[float] = None):
    """Attention of the local queries q (B, H, Tq, D) over the key blocks
    `blocks` yields, (k, v, bias) each, in the ring's order: the per-rank
    computation of `ring_attention` without the communication."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        acc = torch.promote_types(q.dtype, torch.float32)
        qa = q.to(acc)
        m = torch.full(q.shape[:3], -math.inf, dtype=acc)
        l = torch.zeros(q.shape[:3], dtype=acc)
        o = torch.zeros(q.shape, dtype=acc)
        for k, v, bias in blocks:
            m, l, o = _online_block_update(qa, k.to(acc), v.to(acc), bias, m, l, o, scale)
        return (o / l[..., None]).to(q.dtype)
    o = lse = None
    for k, v, bias in blocks:
        o_i, lse_i = attention_cuda(q, k, v, bias, scale, with_lse=True)
        if o is None:
            o, lse = o_i.float(), lse_i
            continue
        new = torch.logaddexp(lse, lse_i)
        o = o * torch.exp(lse - new)[..., None] + o_i.float() * torch.exp(lse_i - new)[..., None]
        lse = new
    return o.to(q.dtype)


def _ring_blocks(k, v, bias, group):
    """The key blocks a rank sees, its own first, each later one received
    from rank - 1 while the current one goes to rank + 1."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt, prv = dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n)
    blk = (k.contiguous(), v.contiguous(), bias.contiguous())
    for i in range(n):
        yield blk
        if i == n - 1:
            return
        recv = tuple(torch.empty_like(t) for t in blk)
        ops = [dist.P2POp(dist.isend, t, nxt, group) for t in blk]
        ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        blk = recv


def ring_attention(q, k, v, bias, group, scale: Optional[float] = None):
    """Blockwise self-attention with K/V (and the key bias) rotating over `group`.

    q, k, v: this rank's (B, H, T_local, D); bias: (B, T_local) additive key
    bias of the local keys. Returns the (B, H, T_local, D) output of the
    local queries, in q's dtype. Forward only.
    """
    return ring_attention_local(q, _ring_blocks(k, v, bias, group), scale)


def ring_attention_reference(q, k, v, bias, scale: Optional[float] = None):
    """The dense one-device oracle with the same semantics (additive 0/1 bias)."""
    scale = _scale(q, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s + bias[:, None, None, :].float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def make_ring_self_attention(group):
    """fn(q, k, v, bias) on global (B, H, T, D) arrays, the same on every rank
    of `group`: each rank runs the ring on its block of T (T / n frames) and
    the blocks are gathered, so every rank returns the (B, H, T, D) output."""
    n, r = dist.get_world_size(group), dist.get_rank(group)

    def fn(q, k, v, bias):
        t = q.shape[2]
        if t % n:
            raise ValueError(f"T = {t} does not split over {n} ranks")
        tl = t // n
        cut = lambda a, dim: a.narrow(dim, r * tl, tl).contiguous()  # noqa: E731
        out = ring_attention(cut(q, 2), cut(k, 2), cut(v, 2), cut(bias, 1), group)
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out, group=group)
        return torch.cat(parts, dim=2)

    return fn
