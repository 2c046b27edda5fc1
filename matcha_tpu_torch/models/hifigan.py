"""HiFi-GAN v1 generator for inference, channels-first inside.

conv k7 pre -> 4 x [leaky-relu, ConvTranspose upsample, multi-receptive-field
fusion of 3 ResBlocks] -> leaky-relu (slope 0.01, the reference's quirk) ->
conv k7 post -> tanh. Each ResBlock1 dilation step runs through kernel K2
(`ops/mrf.py`). Parameter names are the reference's `generator_v1` names
(`conv_pre`, `ups.{i}`, `resblocks.{n}.convs1/convs2.{m}`, `conv_post`);
weight-normed checkpoints (`weight_g`/`weight_v`) are folded into plain
weights when they are loaded. Discriminators are not ported yet (ROADMAP M10).
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


def fold_weight_norm(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`<p>.weight_g` + `<p>.weight_v` -> `<p>.weight` = g * v / ||v||, the norm
    over every axis but 0 (torch weight_norm dim=0); other keys pass through."""
    out = {}
    for key, val in state_dict.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            prefix = key[: -len(".weight_v")]
            g = torch.as_tensor(state_dict[f"{prefix}.weight_g"])
            v = torch.as_tensor(val)
            norm = torch.sqrt(torch.sum(v.double() ** 2, dim=tuple(range(1, v.ndim)),
                                        keepdim=True))
            out[f"{prefix}.weight"] = (g.double() * v.double() / norm).to(v.dtype)
        else:
            out[key] = val
    return out


class ResBlock1(nn.Module):
    """Dilated residual MRF block; each dilation step is one K2 launch on the card."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3, 5)):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=_padding(kernel_size, d)) for d in dilations])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, padding=_padding(kernel_size))
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
        for i, (c1, c2, d) in enumerate(zip(self.convs1, self.convs2, self.dilations)):
            packed = None if x.device.type == "cpu" else self._packed_weights(i)
            x = mrf_step(x, c1.weight, c1.bias, c2.weight, c2.bias, d, packed)
        return x


class ResBlock2(nn.Module):
    """Two-conv residual block variant."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=_padding(kernel_size, d)) for d in dilations])

    def forward(self, x):
        for conv in self.convs:
            x = x + conv(F.leaky_relu(x, LRELU_SLOPE))
        return x


class Generator(nn.Module):
    """mel (B, T, num_mels) -> waveform (B, T * prod(upsample_rates))."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.upsample_initial_channel
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch0, 7, 1, padding=3)
        self.ups = nn.ModuleList([
            nn.ConvTranspose1d(ch0 // 2 ** i, ch0 // 2 ** (i + 1), k, u, padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes))])
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        self.resblocks = nn.ModuleList([
            block(ch0 // 2 ** (i + 1), k, d)
            for i in range(len(self.ups))
            for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)])
        self.conv_post = nn.Conv1d(ch0 // 2 ** len(self.ups), 1, 7, 1, padding=3)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Loads plain or weight-normed (`weight_g`/`weight_v`) state dicts."""
        return super().load_state_dict(fold_weight_norm(state_dict), strict=strict,
                                       assign=assign)

    @torch.no_grad()
    def forward(self, mel):
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
