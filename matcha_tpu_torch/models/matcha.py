"""MatchaTTS: training losses, and inference text -> durations -> alignment -> ODE decode -> mel.

Training (`compute_losses`): encoder, Gaussian log-prior of every (token,
frame) pair, MAS (kernels K3a/K3b on the card, `ops/mas.py`) on the detached
prior, duration loss, optional random crop, mu_y = attn^T mu_x, the CFM loss
over the U-Net (K1 forward, K4 backward) and the prior loss.

State-dict keys are the reference's (`encoder.*`, `decoder.estimator.*`), so
the reference's checkpoints and the test fixtures load directly. Public
methods keep the JAX package's layouts: `z` and `mel` are (B, T, n_feats).

Several ranks (`parallel/`): under `parallel.batch_rows` a rank's losses
are its share of the global batch's (normalisers summed over the data
group, noise drawn at the global shape and cut to its rows); `decode_fixed`
with `seq_axis` splits the U-Net's frames over that axis of the ambient
mesh.

Reference quirks kept: `length_scale` multiplies after `ceil`, the
duration cumsum and path are built in f32 whatever the activation dtype, and
the prior loss keeps +log(2 pi) inside its masked sum.
"""

import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from matcha_tpu_torch.flow import SIGMA_MIN, cfm_loss, sample_cfm
from matcha_tpu_torch.models.precision import mixed_precision_params
from matcha_tpu_torch.nn.decoder import Decoder, DecoderConfig
from matcha_tpu_torch.nn.encoder import EncoderConfig, TextEncoder
from matcha_tpu_torch.ops.mas import maximum_path
from matcha_tpu_torch.ops.masks import duration_loss, generate_path, sequence_mask
from matcha_tpu_torch.parallel.mesh import batch_sum, current_mesh, draw_rows


@dataclass(frozen=True)
class MatchaConfig:
    n_vocab: int = 150
    n_feats: int = 80
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    solver: str = "euler"
    sigma_min: float = SIGMA_MIN
    prior_loss: bool = True
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

    def compute_losses(self, x, x_lengths, y, y_lengths, *, out_size: Optional[int] = None,
                       decoder_dtype: Optional[torch.dtype] = None,
                       generator: Optional[torch.Generator] = None,
                       t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                       offsets: Optional[torch.Tensor] = None):
        """Training forward: dict(dur_loss, prior_loss, diff_loss, attn).

        x (B, Tx) ids, x_lengths (B,); y (B, Ty, n_feats) target mel, y_lengths
        (B,) with y_lengths >= x_lengths (the MAS precondition, which collate
        enforces). Ty must be a multiple of 2**(len(decoder.channels) - 1).
        out_size: train the decoder on a window of this many frames per sample
        (same multiple, <= Ty), at `offsets` (B,) or at offsets drawn from
        `generator`. decoder_dtype: run the U-Net on a view of its parameters
        and inputs in that dtype (mixed precision), its output back in f32.
        Unless injected, the crop offsets, then t, then z are drawn from
        `generator`. Dropout follows `self.training`.
        """
        cfg = self.cfg
        mu, logw, x_mask = self.encoder(x, x_lengths)
        mu_x, logw, x_mask = mu.transpose(1, 2), logw.transpose(1, 2), x_mask.transpose(1, 2)
        y_mask = sequence_mask(y_lengths, y.shape[1]).to(x_mask.dtype)[:, :, None]
        attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, :, 0][:, None, :]  # (B, Tx, Ty)

        with torch.no_grad():  # the alignment search is gradient-free
            mu_sg = mu_x.detach()
            const = -0.5 * math.log(2 * math.pi) * cfg.n_feats
            s_yy = -0.5 * torch.sum(y ** 2, dim=-1)  # (B, Ty)
            cross = torch.einsum("bxf,byf->bxy", mu_sg, y)
            s_mm = -0.5 * torch.sum(mu_sg ** 2, dim=-1)  # (B, Tx)
            log_prior = s_yy[:, None, :] + cross + s_mm[:, :, None] + const
            attn = maximum_path(log_prior, attn_mask, t_x=x_lengths, t_y=y_lengths)

        logw_target = torch.log(1e-8 + torch.sum(attn, dim=-1))[:, :, None] * x_mask
        dur = duration_loss(logw, logw_target, x_lengths)

        if out_size is not None and out_size < y.shape[1]:
            max_offset = torch.clamp(y_lengths - out_size, min=0)
            if offsets is None:
                u = draw_rows(lambda s: torch.rand(s, generator=generator, device=y.device),
                              (y.shape[0],))
                offsets = torch.floor(u * torch.clamp(max_offset, min=1)).to(torch.int64)
            offsets = torch.minimum(offsets.to(device=y.device, dtype=torch.int64), max_offset)
            window = offsets[:, None] + torch.arange(out_size, device=y.device)  # (B, out)
            y = torch.gather(y, 1, window[:, :, None].expand(-1, -1, y.shape[2]))
            attn = torch.gather(attn, 2, window[:, None, :].expand(-1, attn.shape[1], -1))
            y_mask = sequence_mask(torch.clamp(y_lengths, max=out_size),
                                   out_size).to(x_mask.dtype)[:, :, None]
            y = y * y_mask
            attn = attn * y_mask[:, :, 0][:, None, :]

        mu_y = torch.einsum("bxy,bxf->byf", attn, mu_x)

        est = self.decoder.estimator
        if decoder_dtype is None:
            def estimator(xt, m, mu_, tt):
                return est(xt.transpose(1, 2), m.transpose(1, 2), mu_.transpose(1, 2),
                           tt).transpose(1, 2)
        else:
            view = mixed_precision_params(est, decoder_dtype)

            def estimator(xt, m, mu_, tt):
                args = (xt.transpose(1, 2).to(decoder_dtype), m.transpose(1, 2).to(decoder_dtype),
                        mu_.transpose(1, 2).to(decoder_dtype), tt)
                return functional_call(est, view, args).transpose(1, 2).float()
        diff, _ = cfm_loss(estimator, y, y_mask, mu_y, sigma_min=cfg.sigma_min,
                           generator=generator, t=t, z=z)

        if cfg.prior_loss:
            prior = torch.sum(0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi)) * y_mask)
            prior = prior / (batch_sum(torch.sum(y_mask)) * cfg.n_feats)
        else:
            prior = torch.zeros((), device=y.device)
        return {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff, "attn": attn}

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
                     generator: Optional[torch.Generator] = None,
                     seq_axis: Optional[str] = None):
        """Stage 2: alignment + ODE decode at a static frame budget `y_max_length`.

        `z`: optional (B, y_max_length, n_feats) pre-temperature noise; else it
        is drawn from `generator`. `y_max_length` must be a multiple of
        2**(len(decoder.channels) - 1).

        `seq_axis`: an axis of the ambient mesh (`with mesh:`) whose n ranks
        each decode a block of y_max_length / n frames (`Decoder.forward`'s
        `seq`, ring attention in its transformer blocks); z is drawn whole and
        cut, and the mel is gathered, so every rank returns what the call
        without `seq_axis` returns. y_max_length must then be a multiple of
        n * 2**(len(decoder.channels) - 1).
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
        mu_c, mask_c = mu_y.transpose(1, 2), y_mask.transpose(1, 2)
        if seq_axis is None:
            dec = sample_cfm(est, mu_c, mask_c, n_timesteps, temperature, solver=cfg.solver,
                             z=z, generator=generator)
        else:
            dec = self._decode_seq(est, mu_c, mask_c, n_timesteps, temperature, z, generator,
                                   current_mesh().group(seq_axis))
        dec = dec.transpose(1, 2) * y_mask
        mel = dec * cfg.mel_std + cfg.mel_mean
        return {"encoder_outputs": mu_y, "decoder_outputs": dec, "mel": mel,
                "attn": attn, "mel_lengths": y_lengths}

    def _decode_seq(self, est, mu, mask, n_timesteps, temperature, z, generator, group):
        """sample_cfm over (B, C, T) mu and mask with the U-Net split over the
        ranks of `group`, each holding T / n frames; the whole result on every
        rank."""
        import torch.distributed as dist

        n, r = dist.get_world_size(group), dist.get_rank(group)
        t = mu.shape[-1]
        factor = n * 2 ** (len(self.cfg.decoder.channels) - 1)
        if t % factor:
            raise ValueError(f"y_max_length {t} must be a multiple of {factor} "
                             f"({n} sequence ranks x the U-Net's factor)")
        tl = t // n
        if z is None:
            z = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=torch.float32)

        def cut(a):
            return a[:, :, r * tl: (r + 1) * tl]

        dec = sample_cfm(lambda x, m, mu_, tt: est(x, mask, mu_, tt, seq=group), cut(mu),
                         cut(mask), n_timesteps, temperature, solver=self.cfg.solver, z=cut(z))
        parts = [torch.empty_like(dec) for _ in range(n)]
        dist.all_gather(parts, dec.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @torch.no_grad()
    def synthesise_fixed(self, x, x_lengths, y_max_length: int, n_timesteps: int,
                         temperature: float = 1.0, length_scale: float = 1.0,
                         z: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """Text ids -> mel at a static frame budget (both stages)."""
        mu_x, w_ceil, x_mask, y_lengths = self.encode_durations(x, x_lengths, length_scale)
        return self.decode_fixed(mu_x, w_ceil, x_mask, y_lengths, y_max_length,
                                 n_timesteps, temperature, z=z, generator=generator)
