"""Decoder transformer block (diffusers `BasicTransformerBlock`, gelu config).

Pre-LN self-attention + pre-LN GELU feed-forward with residuals, on (B, T, C).
The attention adds the raw (B, T) 0/1 key mask to the logits (the diffusers
`baddbmm(beta=1)` quirk the reference keeps) and runs through kernel K1
(`ops/attention.py`). Parameter names are the reference's: `norm1`,
`attn1.to_q/to_k/to_v/to_out.0`, `norm3`, `ff.net.0.proj`, `ff.net.2`.
"""

import math

import torch.nn as nn
import torch.nn.functional as F

from matcha_tpu_torch.ops.attention import attention


class DiffusersAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, attn_bias):
        b, t, _ = x.shape

        def split(a):  # (B, T, H*D) -> contiguous (B, H, T, D)
            return a.view(b, t, self.heads, self.dim_head).transpose(1, 2).contiguous()

        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        out = attention(q, k, v, attn_bias, scale=1.0 / math.sqrt(self.dim_head))
        return self.to_out[0](out.transpose(1, 2).reshape(b, t, -1))


class GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return F.gelu(self.proj(x))  # exact (erf) gelu


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # slot 1 is the reference's dropout (identity at inference)
        self.net = nn.Sequential(GELUProj(dim, dim * mult), nn.Identity(),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = DiffusersAttention(dim, num_attention_heads, attention_head_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, attention_mask=None):
        """x: (B, T, C); attention_mask: (B, T) 0/1, added to the logits."""
        x = x + self.attn1(self.norm1(x), attention_mask)
        return x + self.ff(self.norm3(x))
