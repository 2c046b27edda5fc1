"""CFM velocity-estimator U-Net, channels-first (B, C, T).

Sinusoidal time embedding -> MLP; down blocks (ResNet1D + transformer +
stride-2 conv / k3 conv), mid blocks, up blocks with skip concatenation and
ConvTranspose(k4, s2, p1) / k3 conv; conv-GroupNorm-Mish-projection head.
Parameter names are the reference's (`time_mlp.*`, `Downsampling_Blocks.*`,
`Mid_Blocks.*`, `Upsampling_Blocks.*`, `final_conv`, `final_norm`,
`final_proj`).

Reference quirks kept: downsampled masks are truncations of the previous
mask, the up path re-expands masks by nearest repeat, and the transformer
blocks add the raw 0/1 mask to their logits. Mel lengths are padded to a
multiple of 2**downsamples, so skip joins always line up.

`DecoderConfig.remat` checkpoints each ResNet and transformer block (the
JAX package's `nn.remat`, `matcha_tpu/nn/decoder.py:195-206`): "full" keeps
only each block's inputs and recomputes the rest in the backward; "dots"
also keeps the outputs of matrix products (`aten.mm`, `addmm`, `bmm`,
`baddbmm`), as `jax.checkpoint_policies.checkpoint_dots` does. A recompute
reruns the block's attention forward, K1 included. The transformer blocks'
dropout masks are drawn before the checkpoint and passed in, and a block
runs on the parameter tensors of its first run (the bf16 view of
mixed-precision training), so the recompute repeats the first run exactly.
"""

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from matcha_tpu_torch.nn.transformer import BasicTransformerBlock


@dataclass(frozen=True)
class DecoderConfig:
    in_channels: int = 160  # 2 * n_feats (x ++ mu)
    out_channels: int = 80
    channels: Tuple[int, ...] = (256, 256)
    dropout: float = 0.05
    attention_head_dim: int = 64
    n_blocks: int = 1
    num_mid_blocks: int = 2
    num_heads: int = 4
    # activation checkpointing of the U-Net blocks: None, "full" or "dots"
    remat: Optional[str] = None

    def __post_init__(self):
        if self.remat not in (None, "full", "dots"):
            raise ValueError(f"remat must be None, 'full' or 'dots', got {self.remat!r}")


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, scale: float = 1000.0):
    """(B,) f32 time -> (B, dim) f32 embedding at scale 1000."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Block1D(nn.Module):
    """Conv k3 -> GroupNorm(8) -> Mish, masked in and out."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv1d(in_ch, out_ch, 3, padding=1),
                                   nn.GroupNorm(8, out_ch, eps=1e-5), nn.Mish())

    def forward(self, x, mask):
        return self.block(x * mask) * mask


class ResnetBlock1D(nn.Module):
    """Two Block1Ds with an additive time injection and a 1x1 residual conv."""

    def __init__(self, in_ch: int, out_ch: int, time_dim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Mish(), nn.Linear(time_dim, out_ch))
        self.block1 = Block1D(in_ch, out_ch)
        self.block2 = Block1D(out_ch, out_ch)
        self.res_conv = nn.Conv1d(in_ch, out_ch, 1)

    def forward(self, x, mask, t_emb):
        h = self.block1(x, mask) + self.mlp(t_emb)[:, :, None]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask)


class Downsample1D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample1D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(module: nn.Module, remat: str, *args):
    """module(*args) under a non-reentrant activation checkpoint. The
    recompute runs on the tensors `module` holds now, which are a view's
    while `functional_call` has swapped them in."""
    state = dict(module.named_parameters())
    state.update(module.named_buffers())

    def run(*a):
        return functional_call(module, state, a)

    kwargs = {}
    if remat == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _dots_policy)
    # the blocks draw no random numbers inside (their dropout masks are
    # arguments), so the default generators need no saving
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


def _transformers(cfg: DecoderConfig, dim: int) -> nn.ModuleList:
    return nn.ModuleList([
        BasicTransformerBlock(dim, cfg.num_heads, cfg.attention_head_dim, cfg.dropout)
        for _ in range(cfg.n_blocks)])


def _run_transformers(blocks, x, mask, remat=None):
    h = x.transpose(1, 2)
    for blk in blocks:
        if remat is None:
            h = blk(h, mask[:, 0, :])
        else:
            h = _checkpointed(blk, remat, h, mask[:, 0, :], *blk.dropout_masks(h))
    return h.transpose(1, 2)


class Decoder(nn.Module):
    """U-Net velocity estimator v(x, t | mu)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels
        time_dim = ch[0] * 4
        self.time_mlp = TimestepEmbedding(cfg.in_channels, time_dim)

        self.Downsampling_Blocks = nn.ModuleList()
        prev = cfg.in_channels
        for i, c in enumerate(ch):
            last = i == len(ch) - 1
            down = nn.Conv1d(c, c, 3, padding=1) if last else Downsample1D(c)
            self.Downsampling_Blocks.append(nn.ModuleList(
                [ResnetBlock1D(prev, c, time_dim), _transformers(cfg, c), down]))
            prev = c

        self.Mid_Blocks = nn.ModuleList([
            nn.ModuleList([ResnetBlock1D(ch[-1], ch[-1], time_dim), _transformers(cfg, ch[-1])])
            for _ in range(cfg.num_mid_blocks)])

        up_ch = tuple(reversed(ch)) + (ch[0],)
        self.Upsampling_Blocks = nn.ModuleList()
        for i in range(len(up_ch) - 1):
            c = up_ch[i + 1]
            last = i == len(up_ch) - 2
            up = nn.Conv1d(c, c, 3, padding=1) if last else Upsample1D(c)
            self.Upsampling_Blocks.append(nn.ModuleList(
                [ResnetBlock1D(up_ch[i] * 2, c, time_dim), _transformers(cfg, c), up]))

        self.final_conv = nn.Conv1d(ch[0], ch[0], 3, padding=1)
        self.final_norm = nn.GroupNorm(8, ch[0], eps=1e-5)
        self.final_proj = nn.Conv1d(ch[0], cfg.out_channels, 1)

    def forward(self, x, mask, mu, t):
        """x, mu: (B, n_feats, T); mask: (B, 1, T); t: (B,) f32 flow time.

        Returns the (B, out_channels, T) velocity. T must be a multiple of
        2**(len(channels) - 1).
        """
        # sinusoidal angles in f32; the embedding then joins the activation dtype
        t_emb = self.time_mlp(sinusoidal_pos_emb(t, self.cfg.in_channels).to(x.dtype))
        x = torch.cat([x, mu], dim=1)

        remat = self.cfg.remat if torch.is_grad_enabled() else None

        def resnet(block, h, m):
            return block(h, m, t_emb) if remat is None else _checkpointed(block, remat, h, m, t_emb)

        hiddens, masks = [], [mask]
        for i, (res, blocks, down) in enumerate(self.Downsampling_Blocks):
            m = masks[-1]
            x = _run_transformers(blocks, resnet(res, x, m), m, remat)
            hiddens.append(x)
            x = down(x * m)
            masks.append(m[:, :, : x.shape[-1]])  # truncation (identity on the last level)
        masks = masks[:-1]

        m = masks[-1]
        for res, blocks in self.Mid_Blocks:
            x = _run_transformers(blocks, resnet(res, x, m), m, remat)

        for res, blocks, up in self.Upsampling_Blocks:
            m = masks.pop()
            hidden = hiddens.pop()
            if x.shape[-1] != hidden.shape[-1]:
                raise ValueError("skip-join length mismatch: pad the mel length with "
                                 "fix_len_compatibility")
            x = _run_transformers(blocks, resnet(res, torch.cat([x, hidden], dim=1), m), m,
                                  remat)
            x = up(x * m)
            if x.shape[-1] != m.shape[-1]:  # nearest re-expansion after an upsample
                m = m.repeat_interleave(x.shape[-1] // m.shape[-1], dim=-1)

        x = self.final_conv(x * m)
        x = F.mish(self.final_norm(x))
        return self.final_proj(x * m) * mask
