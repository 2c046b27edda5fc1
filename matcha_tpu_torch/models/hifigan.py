"""HiFi-GAN v1: generator, discriminators and GAN losses, channels-first inside.

Generator: conv k7 pre -> 4 x [leaky-relu, ConvTranspose upsample,
multi-receptive-field fusion of 3 ResBlocks] -> leaky-relu (slope 0.01, the
reference's quirk) -> conv k7 post -> tanh. Parameter names are the
reference's `generator_v1` names (`conv_pre`, `ups.{i}`,
`resblocks.{n}.convs1/convs2.{m}`, `conv_post`). Two forms:

  * serving (`weight_norm=False`, no autograd): each ResBlock1 dilation step
    runs through kernel K2 (`ops/mrf.py`); weight-normed state dicts
    (`weight_g`/`weight_v`) are folded into plain weights when they are loaded;
  * training (`weight_norm=True`, autograd): every conv is weight-normed as
    flax's `nn.WeightNorm` is (`WN_EPS`, g initialised to 1), its weight
    recomputed from g and v on every call, and ResBlock1 runs the plain conv
    sequence, as the JAX package does (`matcha_tpu/models/hifigan.py:176-209`:
    K2 has no backward). Its state dict holds `<name>.weight_g` and
    `<name>.weight_v`, which the serving form loads as they are.

The discriminators (five period, three scale) and the LSGAN and
feature-matching losses follow the JAX package (`models/hifigan.py:338-477`),
which carries no weight or spectral norm on them. Kernels start N(0, 0.01)
and biases 0 (`norm_init_`), as the JAX package initialises them.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from matcha_tpu_torch.ops.mrf import LRELU_SLOPE, mrf_step, pack_weights


@dataclass(frozen=True)
class HiFiGANConfig:
    """Generator v1 hyperparameters."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050


def _padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


# flax WeightNorm's epsilon, added to the sum of squares inside the square root
WN_EPS = 1e-12


def fold_weight_norm(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`<p>.weight_g` + `<p>.weight_v` -> `<p>.weight` = g * v / sqrt(sum(v^2) +
    WN_EPS), the sum over every axis but 0 (torch weight_norm dim=0); other
    keys pass through."""
    out = {}
    for key, val in state_dict.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            prefix = key[: -len(".weight_v")]
            g = torch.as_tensor(state_dict[f"{prefix}.weight_g"])
            v = torch.as_tensor(val)
            norm = torch.sqrt(torch.sum(v.double() ** 2, dim=tuple(range(1, v.ndim)),
                                        keepdim=True) + WN_EPS)
            out[f"{prefix}.weight"] = (g.double() * v.double() / norm).to(v.dtype)
        else:
            out[key] = val
    return out


def _wn_weight(g, v):
    """flax WeightNorm's weight: v / sqrt(sum(v^2) + WN_EPS) * g, the sum over
    every axis but 0 (a conv's output channels, a transposed conv's input
    channels: flax's feature axis, the kernel's last)."""
    return v * torch.rsqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True)
                           + WN_EPS) * g


def _split_weight(conv: nn.Module) -> None:
    """Replace `conv.weight` by the direction `weight_v` and the scale `weight_g`
    (shape (weight.shape[0], 1, ...), torch weight_norm's), g = 1."""
    v = conv.weight.detach().clone()
    del conv.weight
    conv.weight_v = nn.Parameter(v)
    conv.weight_g = nn.Parameter(torch.ones((v.shape[0],) + (1,) * (v.ndim - 1)))


class WNConv1d(nn.Conv1d):
    """Conv1d weight-normed as flax's WeightNorm: its weight is recomputed from
    g and v on every call (inside a CUDA graph too)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _split_weight(self)

    def forward(self, x):
        return self._conv_forward(x, _wn_weight(self.weight_g, self.weight_v), self.bias)


class WNConvTranspose1d(nn.ConvTranspose1d):
    """ConvTranspose1d weight-normed as flax's WeightNorm, per input channel."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _split_weight(self)

    def forward(self, x):
        return F.conv_transpose1d(x, _wn_weight(self.weight_g, self.weight_v), self.bias,
                                  self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


@torch.no_grad()
def norm_init_(module: nn.Module) -> nn.Module:
    """The JAX package's init (`_norm_init`): every kernel, the direction v of
    a weight-normed one included, N(0, 0.01); biases 0; scales g 1."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif name.endswith("weight_g"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.01)
    return module


class ResBlock1(nn.Module):
    """Dilated residual MRF block. Serving: each dilation step is one K2 launch
    on the card. Training (`weight_norm`): the plain conv sequence."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3, 5),
                 weight_norm: bool = False):
        super().__init__()
        self.dilations = tuple(dilations)
        self.weight_norm = weight_norm
        conv = WNConv1d if weight_norm else nn.Conv1d
        self.convs1 = nn.ModuleList([
            conv(channels, channels, kernel_size, dilation=d,
                 padding=_padding(kernel_size, d)) for d in dilations])
        self.convs2 = nn.ModuleList([
            conv(channels, channels, kernel_size, padding=_padding(kernel_size))
            for _ in dilations])
        self._packed = {}  # step -> (its weights' storage and version, K2's packing)

    def _packed_weights(self, i: int):
        """Step i's weights packed for K2; packed again only after a load, a
        cast or a move has given them new values or new storage."""
        w1, w2 = self.convs1[i].weight, self.convs2[i].weight
        key = tuple((w.data_ptr(), w._version, w.dtype, w.device) for w in (w1, w2))
        hit = self._packed.get(i)
        if hit is None or hit[0] != key:
            hit = self._packed[i] = (key, pack_weights(w1, w2))
        return hit[1]

    def forward(self, x):
        if self.weight_norm:
            for c1, c2 in zip(self.convs1, self.convs2):
                x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            return x
        for i, (c1, c2, d) in enumerate(zip(self.convs1, self.convs2, self.dilations)):
            packed = None if x.device.type == "cpu" else self._packed_weights(i)
            x = mrf_step(x, c1.weight, c1.bias, c2.weight, c2.bias, d, packed)
        return x


class ResBlock2(nn.Module):
    """Two-conv residual block variant."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3),
                 weight_norm: bool = False):
        super().__init__()
        conv = WNConv1d if weight_norm else nn.Conv1d
        self.convs = nn.ModuleList([
            conv(channels, channels, kernel_size, dilation=d,
                 padding=_padding(kernel_size, d)) for d in dilations])

    def forward(self, x):
        for conv in self.convs:
            x = x + conv(F.leaky_relu(x, LRELU_SLOPE))
        return x


class Generator(nn.Module):
    """mel (B, T, num_mels) -> waveform (B, T * prod(upsample_rates)).

    `weight_norm=False` is the serving form (no autograd, K2 on the card);
    `weight_norm=True` the training form (autograd, plain convs, weight-normed,
    initialised by `norm_init_`)."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig(), weight_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.weight_norm = weight_norm
        conv, conv_t = ((WNConv1d, WNConvTranspose1d) if weight_norm
                        else (nn.Conv1d, nn.ConvTranspose1d))
        ch0 = cfg.upsample_initial_channel
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        self.conv_pre = conv(cfg.num_mels, ch0, 7, 1, padding=3)
        self.ups = nn.ModuleList([
            conv_t(ch0 // 2 ** i, ch0 // 2 ** (i + 1), k, u, padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes))])
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        self.resblocks = nn.ModuleList([
            block(ch0 // 2 ** (i + 1), k, d, weight_norm)
            for i in range(len(self.ups))
            for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)])
        self.conv_post = conv(ch0 // 2 ** len(self.ups), 1, 7, 1, padding=3)
        if weight_norm:
            norm_init_(self)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Serving form: loads plain or weight-normed (`weight_g`/`weight_v`) state
        dicts, folding the latter; training form: weight-normed ones as they are."""
        if not self.weight_norm:
            state_dict = fold_weight_norm(state_dict)
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def forward(self, mel):
        if self.weight_norm:
            return self._forward(mel)
        with torch.no_grad():
            return self._forward(mel)

    def _forward(self, mel):
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(self.num_kernels):
                y = self.resblocks[i * self.num_kernels + j](x)
                acc = y if acc is None else acc + y
            x = acc / self.num_kernels
        x = F.leaky_relu(x, 0.01)  # torch's default slope, as the reference calls it
        return torch.tanh(self.conv_post(x))[:, 0, :]


# --------------------------------------------------------------------------- #
# Discriminators and GAN losses (vocoder training)
# --------------------------------------------------------------------------- #


class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform folded into a (T / p, p) map, reflect-padded
    to a multiple of p. Its strided convs all pad 2, whatever `kernel_size` is,
    as the JAX package's do. `channels` shrinks it for tests."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Tuple[int, ...] = (32, 128, 512, 1024)):
        super().__init__()
        self.period = period
        c_in = (1,) + tuple(channels)
        self.convs = nn.ModuleList(
            [nn.Conv2d(ci, co, (kernel_size, 1), (stride, 1), padding=(2, 0))
             for ci, co in zip(c_in[:-1], c_in[1:])]
            + [nn.Conv2d(channels[-1], channels[-1], (kernel_size, 1), 1, padding=(2, 0))])
        self.conv_post = nn.Conv2d(channels[-1], 1, (3, 1), 1, padding=(1, 0))
        norm_init_(self)

    def forward(self, x):
        """(B, T) -> ((B, frames) scores, the feature maps (B, C, T / p, p))."""
        b, t = x.shape
        p = self.period
        x = x[:, None, :]
        if t % p:
            x = F.pad(x, (0, p - t % p), mode="reflect")
        x = x.reshape(b, 1, -1, p)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


# rows (channels, kernel, stride, groups, padding) of a scale discriminator: v1's
MSD_SPEC = (
    (128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
    (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
    (1024, 5, 1, 1, 2),
)


class DiscriminatorS(nn.Module):
    """Scale discriminator: a stack of grouped 1-D convs (`spec` rows)."""

    def __init__(self, spec=MSD_SPEC):
        super().__init__()
        c_in = (1,) + tuple(row[0] for row in spec)
        self.convs = nn.ModuleList([
            nn.Conv1d(ci, ch, k, s, groups=g, padding=pad)
            for ci, (ch, k, s, g, pad) in zip(c_in, spec)])
        self.conv_post = nn.Conv1d(c_in[-1], 1, 3, 1, padding=1)
        norm_init_(self)

    def forward(self, x):
        """(B, T) -> ((B, frames) scores, the feature maps (B, C, frames))."""
        x = x[:, None, :]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """Periods 2, 3, 5, 7, 11."""

    def __init__(self, periods=(2, 3, 5, 7, 11), channels=(32, 128, 512, 1024)):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorP(p, channels=channels)
                                             for p in periods])

    def forward(self, y, y_hat):
        """Scores and feature maps of the real and the generated waveforms:
        (outs_r, outs_g, fmaps_r, fmaps_g), one entry a discriminator."""
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for d in self.discriminators:
            o_r, f_r = d(y)
            o_g, f_g = d(y_hat)
            outs_r.append(o_r)
            outs_g.append(o_g)
            fmaps_r.append(f_r)
            fmaps_g.append(f_g)
        return outs_r, outs_g, fmaps_r, fmaps_g


class MultiScaleDiscriminator(nn.Module):
    """Three scales, each after an average pool (4, stride 2, padding 2, the
    padding counted) of the one before."""

    def __init__(self, spec=MSD_SPEC):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorS(spec) for _ in range(3)])

    def forward(self, y, y_hat):
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i:
                y, y_hat = (F.avg_pool1d(w[:, None, :], 4, 2, padding=2,
                                         count_include_pad=True)[:, 0, :] for w in (y, y_hat))
            o_r, f_r = d(y)
            o_g, f_g = d(y_hat)
            outs_r.append(o_r)
            outs_g.append(o_g)
            fmaps_r.append(f_r)
            fmaps_g.append(f_g)
        return outs_r, outs_g, fmaps_r, fmaps_g


def feature_loss(fmap_r, fmap_g):
    """L1 feature matching, times 2."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real, disc_gen):
    """LSGAN discriminator loss: (sum, real terms, generated terms)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean((1 - dr) ** 2)
        g = torch.mean(dg ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN generator loss: (sum, one term a discriminator)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        term = torch.mean((1 - dg) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses
