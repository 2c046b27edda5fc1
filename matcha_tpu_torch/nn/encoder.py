"""Text encoder stack, channels-first (B, C, T).

Scaled embedding -> 3-layer ConvReluNorm prenet -> post-LN transformer with
RoPE over half of each head -> mean projection, plus a duration predictor on
the detached encoding. Module and parameter names are the reference's
(`encoder.prenet.*`, `encoder.encoder.*`, `encoder.duration_predictor.*`).
Padded keys are masked with -1e4; LayerNorm eps is 1e-5.

Dropout sits where the JAX package puts it (`matcha_tpu/nn/encoder.py`): after
each prenet layer (0.1, fixed), on the attention probabilities, after both
ConvFFN convolutions and on both residual branches (`p_dropout`), and after
both duration-predictor blocks (`dp_p_dropout`). It is active in `train()`
only and draws from the generator `nn.dropout.dropout_generator` sets; the
prenet's residual projection starts at zero, as the reference's.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from matcha_tpu_torch.nn.dropout import Dropout
from matcha_tpu_torch.nn.rope import apply_rope
from matcha_tpu_torch.ops.masks import sequence_mask


@dataclass(frozen=True)
class EncoderConfig:
    n_vocab: int = 150
    n_feats: int = 80
    n_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    prenet: bool = True
    filter_channels_dp: int = 256
    dp_kernel_size: int = 3
    dp_p_dropout: float = 0.1


def _channel_norm(norm: nn.LayerNorm, x):
    """LayerNorm over the channel axis of (B, C, T)."""
    return norm(x.transpose(1, 2)).transpose(1, 2)


class ConvReluNorm(nn.Module):
    """Conv prenet with a residual projection."""

    dropout_rate = 0.1

    def __init__(self, channels: int, kernel_size: int = 5, n_layers: int = 3):
        super().__init__()
        self.convolutions = nn.ModuleList(
            [nn.Conv1d(channels, channels, kernel_size, padding=kernel_size // 2)
             for _ in range(n_layers)])
        self.normalizations = nn.ModuleList(
            [nn.LayerNorm(channels, eps=1e-5) for _ in range(n_layers)])
        self.dropout = Dropout(self.dropout_rate)
        self.projection = nn.Conv1d(channels, channels, 1)
        nn.init.zeros_(self.projection.weight)
        nn.init.zeros_(self.projection.bias)

    def forward(self, x, mask):
        residual = x
        for conv, norm in zip(self.convolutions, self.normalizations):
            x = self.dropout(torch.relu(_channel_norm(norm, conv(x * mask))))
        return (residual + self.projection(x)) * mask


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        pad = kernel_size // 2
        self.conv_layer_1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=pad)
        self.norm_layer_1 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.conv_layer_2 = nn.Conv1d(filter_channels, filter_channels, kernel_size, padding=pad)
        self.norm_layer_2 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.dropout = Dropout(p_dropout)
        self.output_projection = nn.Conv1d(filter_channels, 1, 1)

    def forward(self, x, mask):
        x = self.dropout(_channel_norm(self.norm_layer_1, torch.relu(self.conv_layer_1(x * mask))))
        x = self.dropout(_channel_norm(self.norm_layer_2, torch.relu(self.conv_layer_2(x * mask))))
        return self.output_projection(x * mask) * mask


class RoPEMultiHeadAttention(nn.Module):
    """Self-attention with 1x1-conv projections and RoPE on half of each head."""

    def __init__(self, channels: int, n_heads: int, p_dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = Dropout(p_dropout)
        self.head_dim = channels // n_heads
        self.query_conv = nn.Conv1d(channels, channels, 1)
        self.key_conv = nn.Conv1d(channels, channels, 1)
        self.value_conv = nn.Conv1d(channels, channels, 1)
        self.output_conv = nn.Conv1d(channels, channels, 1)

    def forward(self, x, attn_mask):
        b, c, t = x.shape

        def heads(a):  # (B, C, T) -> (B, H, T, Dh)
            return a.view(b, self.n_heads, self.head_dim, t).transpose(2, 3)

        q, k, v = heads(self.query_conv(x)), heads(self.key_conv(x)), heads(self.value_conv(x))
        rope_dim = int(self.head_dim * 0.5)
        q, k = apply_rope(q, rope_dim), apply_rope(k, rope_dim)
        scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(self.head_dim)
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        probs = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.matmul(probs, v).transpose(2, 3).reshape(b, c, t)
        return self.output_conv(out)


class ConvFFN(nn.Module):
    def __init__(self, channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        pad = kernel_size // 2
        # the reference's Sequential slots: conv, ReLU, Dropout, conv
        self.conv_net = nn.Sequential(
            nn.Conv1d(channels, filter_channels, kernel_size, padding=pad), nn.ReLU(),
            Dropout(p_dropout), nn.Conv1d(filter_channels, channels, kernel_size, padding=pad))
        self.dropout = Dropout(p_dropout)

    def forward(self, x, mask):
        return self.dropout(self.conv_net(x * mask)) * mask


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        ch, n = cfg.n_channels, cfg.n_layers
        p = cfg.p_dropout
        self.attention_layers = nn.ModuleList(
            [RoPEMultiHeadAttention(ch, cfg.n_heads, p) for _ in range(n)])
        self.norm_layers_1 = nn.ModuleList([nn.LayerNorm(ch, eps=1e-5) for _ in range(n)])
        self.ffn_layers = nn.ModuleList(
            [ConvFFN(ch, cfg.filter_channels, cfg.kernel_size, p) for _ in range(n)])
        self.norm_layers_2 = nn.ModuleList([nn.LayerNorm(ch, eps=1e-5) for _ in range(n)])
        self.dropout = Dropout(p)

    def forward(self, x, mask):
        attn_mask = mask.unsqueeze(2) * mask.unsqueeze(-1)  # (B, 1, T, T)
        for attn, n1, ffn, n2 in zip(self.attention_layers, self.norm_layers_1,
                                     self.ffn_layers, self.norm_layers_2):
            x = x * mask
            x = _channel_norm(n1, x + self.dropout(attn(x, attn_mask)))
            x = _channel_norm(n2, x + self.dropout(ffn(x, mask)))
        return x * mask


class TextEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.n_vocab, cfg.n_channels)
        self.prenet = ConvReluNorm(cfg.n_channels) if cfg.prenet else nn.Identity()
        self.encoder = TransformerEncoder(cfg)
        self.mean_projection = nn.Conv1d(cfg.n_channels, cfg.n_feats, 1)
        self.duration_predictor = DurationPredictor(
            cfg.n_channels, cfg.filter_channels_dp, cfg.dp_kernel_size, cfg.dp_p_dropout)

    def forward(self, x, x_lengths):
        """x: (B, Tx) token ids, x_lengths: (B,).

        Returns mu (B, n_feats, Tx), logw (B, 1, Tx), mask (B, 1, Tx).
        """
        emb = self.embedding(x) * math.sqrt(self.cfg.n_channels)
        h = emb.transpose(1, 2)
        mask = sequence_mask(x_lengths, x.shape[1]).unsqueeze(1).to(h.dtype)
        h = self.prenet(h, mask) if self.cfg.prenet else h
        h = self.encoder(h, mask)
        mu = self.mean_projection(h) * mask
        logw = self.duration_predictor(h.detach(), mask)
        return mu, logw, mask
