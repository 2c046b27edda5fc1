"""MatchaTTS inference: text -> durations -> alignment -> ODE decode -> mel.

State-dict keys are the reference's (`encoder.*`, `decoder.estimator.*`), so
the reference's checkpoints and the test fixtures load directly. Public
methods keep the JAX package's layouts: `z` and `mel` are (B, T, n_feats).

Reference quirks kept: `length_scale` multiplies after `ceil`, and the
duration cumsum and path are built in f32 whatever the activation dtype.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn as nn

from matcha_tpu_torch.flow import sample_cfm
from matcha_tpu_torch.nn.decoder import Decoder, DecoderConfig
from matcha_tpu_torch.nn.encoder import EncoderConfig, TextEncoder
from matcha_tpu_torch.ops.masks import generate_path, sequence_mask


@dataclass(frozen=True)
class MatchaConfig:
    n_vocab: int = 150
    n_feats: int = 80
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    solver: str = "euler"
    mel_mean: float = 0.0
    mel_std: float = 1.0


def tiny_config(n_feats: int = 8) -> MatchaConfig:
    """Reduced widths, same topology: for tests and bring-up on the CPU."""
    return MatchaConfig(
        n_feats=n_feats,
        encoder=EncoderConfig(n_feats=n_feats, n_channels=16, filter_channels=32,
                              n_heads=2, n_layers=1, filter_channels_dp=16),
        decoder=DecoderConfig(in_channels=2 * n_feats, out_channels=n_feats,
                              channels=(16, 16), attention_head_dim=8, num_heads=2,
                              num_mid_blocks=1),
    )


class CFM(nn.Module):
    """Holds the U-Net estimator under the reference's `decoder.estimator` name."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.estimator = Decoder(cfg)


class MatchaTTS(nn.Module):
    def __init__(self, cfg: MatchaConfig = MatchaConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg.encoder)
        self.decoder = CFM(cfg.decoder)

    @torch.no_grad()
    def encode_durations(self, x, x_lengths, length_scale: float = 1.0):
        """Stage 1: (B, Tx) ids -> mu_x (B, Tx, n_feats), w_ceil (B, Tx),
        x_mask (B, Tx, 1), y_lengths (B,) int32."""
        mu_x, logw, x_mask = self.encoder(x, x_lengths)
        w = torch.exp(logw) * x_mask
        w_ceil = torch.ceil(w) * length_scale
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int32)
        return mu_x.transpose(1, 2), w_ceil[:, 0, :], x_mask.transpose(1, 2), y_lengths

    @torch.no_grad()
    def decode_fixed(self, mu_x, w_ceil, x_mask, y_lengths, y_max_length: int,
                     n_timesteps: int, temperature: float = 1.0,
                     z: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """Stage 2: alignment + ODE decode at a static frame budget `y_max_length`.

        `z`: optional (B, y_max_length, n_feats) pre-temperature noise; else it
        is drawn from `generator`. `y_max_length` must be a multiple of
        2**(len(decoder.channels) - 1).
        """
        cfg = self.cfg
        y_lengths = torch.clamp(y_lengths, max=y_max_length)
        y_mask = sequence_mask(y_lengths, y_max_length).to(mu_x.dtype)[:, :, None]
        attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, :, 0][:, None, :]
        attn = generate_path(w_ceil.float(), attn_mask.float()).to(mu_x.dtype)
        mu_y = torch.einsum("bxy,bxf->byf", attn, mu_x)

        est = self.decoder.estimator
        if z is not None:
            z = z.transpose(1, 2)
        dec = sample_cfm(est, mu_y.transpose(1, 2), y_mask.transpose(1, 2), n_timesteps,
                         temperature, solver=cfg.solver, z=z, generator=generator)
        dec = dec.transpose(1, 2) * y_mask
        mel = dec * cfg.mel_std + cfg.mel_mean
        return {"encoder_outputs": mu_y, "decoder_outputs": dec, "mel": mel,
                "attn": attn, "mel_lengths": y_lengths}

    @torch.no_grad()
    def synthesise_fixed(self, x, x_lengths, y_max_length: int, n_timesteps: int,
                         temperature: float = 1.0, length_scale: float = 1.0,
                         z: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """Text ids -> mel at a static frame budget (both stages)."""
        mu_x, w_ceil, x_mask, y_lengths = self.encode_durations(x, x_lengths, length_scale)
        return self.decode_fixed(mu_x, w_ceil, x_mask, y_lengths, y_max_length,
                                 n_timesteps, temperature, z=z, generator=generator)
