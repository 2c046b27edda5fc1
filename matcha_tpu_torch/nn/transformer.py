"""Decoder transformer block (diffusers `BasicTransformerBlock`, gelu config).

Pre-LN self-attention + pre-LN GELU feed-forward with residuals, on (B, T, C).
The attention adds the raw (B, T) 0/1 key mask to the logits (the diffusers
`baddbmm(beta=1)` quirk the reference keeps) and runs through kernel K1
(`ops/attention.py`). Parameter names are the reference's: `norm1`,
`attn1.to_q/to_k/to_v/to_out.0`, `norm3`, `ff.net.0.proj`, `ff.net.2`.
Dropout (`DecoderConfig.dropout`, active in `train()` only) follows `to_out`
and the GELU, as in diffusers and the JAX package. A block draws both masks
on entry (`dropout_masks`) and can take them as an argument instead, so that
an activation checkpoint's recompute (`DecoderConfig.remat`) reuses them.

Tensor parallelism (`parallel/sharding.py`): with `tp_group` set, the
attention runs its block of heads (K1 and K4 on heads / n) and the
feed-forward its block of the hidden, each summing its output projection
over the group. Sequence parallelism: with `seq` (a process group whose
ranks hold consecutive blocks of T), the attention is `ring_attention`.
"""

import math

import torch.nn as nn
import torch.nn.functional as F

from matcha_tpu_torch.nn.dropout import Dropout
from matcha_tpu_torch.ops.attention import attention
from matcha_tpu_torch.parallel.ring_attention import ring_attention
from matcha_tpu_torch.parallel.sharding import copy_to_group, row_parallel


class DiffusersAttention(nn.Module):
    tp_group = None  # the model group, under tensor parallelism

    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), Dropout(dropout)])

    def forward(self, x, attn_bias, keep=None, seq=None):
        b, t, _ = x.shape
        if self.tp_group is not None:
            x = copy_to_group(x, self.tp_group)

        def split(a):  # (B, T, H*D) -> contiguous (B, H, T, D), H this rank's heads
            return a.view(b, t, -1, self.dim_head).transpose(1, 2).contiguous()

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        scale = 1.0 / math.sqrt(self.dim_head)
        if seq is not None:
            out = ring_attention(q, k, v, attn_bias, seq, scale)
        else:
            out = attention(q, k, v, attn_bias, scale=scale)
        out = out.transpose(1, 2).reshape(b, t, -1)
        if self.tp_group is not None:
            return self.to_out[1](row_parallel(self.to_out[0], out, self.tp_group), keep)
        return self.to_out[1](self.to_out[0](out), keep)


class GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return F.gelu(self.proj(x))  # exact (erf) gelu


class FeedForward(nn.Module):
    tp_group = None  # the model group, under tensor parallelism

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(GELUProj(dim, dim * mult), Dropout(dropout),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x, keep=None):
        if self.tp_group is None:
            return self.net[2](self.net[1](self.net[0](x), keep))
        h = self.net[1](self.net[0](copy_to_group(x, self.tp_group)), keep)
        return row_parallel(self.net[2], h, self.tp_group)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = DiffusersAttention(dim, num_attention_heads, attention_head_dim, dropout)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, dropout=dropout)

    def dropout_masks(self, x):
        """The keep masks of the attention output and the feed-forward hidden
        for input x (B, T, C), in the order the block uses them; None in eval."""
        b, t, c = x.shape
        return (self.attn1.to_out[1].keep_mask((b, t, c), x.device, x.dtype),
                self.ff.net[1].keep_mask((b, t, self.ff.net[2].in_features), x.device, x.dtype))

    def forward(self, x, attention_mask=None, keep_attn=None, keep_ff=None, seq=None):
        """x: (B, T, C); attention_mask: (B, T) 0/1, added to the logits;
        keep_attn, keep_ff: dropout masks (drawn here when not given); seq:
        the sequence group, when x holds this rank's block of frames."""
        if keep_attn is None and keep_ff is None:
            keep_attn, keep_ff = self.dropout_masks(x)
        x = x + self.attn1(self.norm1(x), attention_mask, keep_attn, seq)
        return x + self.ff(self.norm3(x), keep_ff)
