"""Batched text -> waveform serving engine.

A request group pays two device stages: the encoder with durations, after
which the host reads the predicted lengths and picks the smallest mel budget
that fits, then one decode stage at that budget (noise, alignment path, ODE
decode over the U-Net, HiFi-GAN, clip and packing). `synthesise_lowlatency`
runs the whole chain at one fixed budget with no host read in between.

Determinism: with `seeds=`, each request's noise is drawn from
`torch.Generator(device).manual_seed(seed)` at shape (budget, n_feats), so a
waveform depends only on (text, seed, budget), never on its batch mates. The
noise is not the JAX package's (torch has no threefry); parity runs inject `z`.

On the card the decoder attention and the MRF steps always run their CUDA
kernels (K1, K2): the JAX engine's TPU-measured selection knobs (`attn_impl`,
`attn_pallas_min_budget`, `vocoder_resblock_impl`) are not ported. Not ported
yet: the threaded batching worker (`start_batching`/`serve`), `mesh=`, and
the Griffin-Lim vocoder (ROADMAP M7, M8).
"""

import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from matcha_tpu_torch import apply_tf32_policy, resolve_device
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
from matcha_tpu_torch.models.precision import bf16_serving
from matcha_tpu_torch.ops.masks import fix_len_compatibility
from matcha_tpu_torch.text import simple_text_to_sequence


@dataclass(frozen=True)
class MelConfig:
    """The audio frame of a mel frame (the reference's LJSpeech defaults); the
    rest of the JAX package's MelConfig comes with the audio port (M7)."""

    sample_rate: int = 22050
    hop_size: int = 256


def rtf(wall_seconds: float, mel_frames: int, hop: int = 256, sr: int = 22050) -> float:
    """Real-time factor: wall time over the duration of the audio produced."""
    return wall_seconds * sr / (mel_frames * hop)


@dataclass(frozen=True)
class ServeConfig:
    n_timesteps: int = 10
    temperature: float = 1.0
    length_scale: float = 1.0
    text_pad_multiple: int = 16
    max_text_len: int = 256
    # mel-frame budgets; a batch decodes at the smallest one that fits its
    # longest predicted utterance (each a multiple of 4, the U-Net's factor)
    mel_budgets: Tuple[int, ...] = (128, 256, 512, 1024)
    max_batch: int = 16
    bf16: bool = False
    vocoder: str = "hifigan"  # the only vocoder ported so far
    # "float32", or "int16": 16-bit PCM quantized on the device, as a PCM16
    # wav stores it (4x less device->host traffic)
    output_dtype: str = "float32"
    mel_cfg: MelConfig = field(default_factory=MelConfig)


class TTSEngine:
    """Batched text -> waveform synthesis on one device."""

    def __init__(self, params, model_cfg: MatchaConfig = MatchaConfig(),
                 cfg: ServeConfig = ServeConfig(), vocoder_params=None,
                 hifigan_cfg: Optional[HiFiGANConfig] = None, device=None, seed: int = 0):
        """`params`: a MatchaTTS state dict; `vocoder_params`: a HiFi-GAN
        generator state dict, plain or weight-normed. `device=None` is the card."""
        if cfg.vocoder == "griffin_lim":
            raise NotImplementedError(
                "the Griffin-Lim vocoder is not ported yet (ROADMAP M7); use vocoder='hifigan'")
        if cfg.vocoder != "hifigan":
            raise ValueError(f"unknown vocoder {cfg.vocoder!r}")
        if vocoder_params is None:
            raise ValueError("the hifigan vocoder needs vocoder_params (a generator state dict)")
        if cfg.output_dtype not in ("float32", "int16"):
            raise ValueError(f"output_dtype must be 'float32' or 'int16', got {cfg.output_dtype!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            apply_tf32_policy()
        self.model = MatchaTTS(model_cfg)
        self.model.load_state_dict(params)
        self.vocoder = Generator(hifigan_cfg or HiFiGANConfig())
        self.vocoder.load_state_dict(vocoder_params)
        for m in (self.model, self.vocoder):
            m.eval().to(self.device)
            if cfg.bf16:
                bf16_serving(m)
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        # serializes the engine rng and each request group's device sequence
        self._lock = threading.Lock()

    # ----------------------------------------------------------- stages
    def _tokenize(self, texts: Sequence[str]):
        cfg = self.cfg
        seqs = [simple_text_to_sequence(t)[: cfg.max_text_len] for t in texts]
        longest = max(len(s) for s in seqs)
        tx = min(-(-longest // cfg.text_pad_multiple) * cfg.text_pad_multiple,
                 cfg.max_text_len)
        x = np.zeros((len(seqs), max(tx, 1)), np.int64)
        xl = np.zeros((len(seqs),), np.int64)
        for i, s in enumerate(seqs):
            x[i, : len(s)] = s
            xl[i] = len(s)
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(xl).to(self.device))

    def _pick_budget(self, max_frames: int) -> int:
        for b in sorted(self.cfg.mel_budgets):
            if b >= max_frames:
                return b
        return max(self.cfg.mel_budgets)

    def _noise(self, n: int, budget: int, seed: Optional[int],
               seeds: Optional[Sequence[int]]) -> torch.Tensor:
        """(n, budget, n_feats) f32 pre-temperature noise."""
        nf = self.model.cfg.n_feats

        def draw(shape, gen):
            return torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)

        if seeds is not None:
            return torch.stack([
                draw((budget, nf), torch.Generator(device=self.device).manual_seed(int(s)))
                for s in seeds])
        gen = (torch.Generator(device=self.device).manual_seed(int(seed))
               if seed is not None else self._rng)
        return draw((n, budget, nf), gen)

    def _decode_vocode(self, enc, z, budget: int) -> torch.Tensor:
        """Decode + vocode + pack: (B, budget*hop + 2) rows laid out as
        [waveform..., mel length, predicted length] in the wire dtype."""
        mu_x, w_ceil, x_mask, y_lengths = enc
        out = self.model.decode_fixed(mu_x, w_ceil, x_mask, y_lengths, budget,
                                      self.cfg.n_timesteps, self.cfg.temperature, z=z)
        wav = torch.clamp(self.vocoder(out["mel"]).float(), -1.0, 1.0)
        predicted = torch.clamp(y_lengths, max=32767)
        if self.cfg.output_dtype == "int16":
            wav = torch.round(wav * 32767.0).to(torch.int16)
        tails = torch.stack([out["mel_lengths"], predicted], dim=1).to(wav.dtype)
        return torch.cat([wav, tails], dim=1)

    def _finish(self, packed: np.ndarray, n: int):
        hop = self.cfg.mel_cfg.hop_size
        wav, lengths = packed[:n, :-2], packed[:n, -2].astype(np.int32)
        predicted = packed[:n, -1].astype(np.int32)
        wavs = [wav[i, : min(int(lengths[i]) * hop, wav.shape[1])] for i in range(n)]
        return wavs, lengths, predicted

    def _info(self, wall, budget, lengths, truncated):
        hop, sr = self.cfg.mel_cfg.hop_size, self.cfg.mel_cfg.sample_rate
        return {"rtf": rtf(wall, int(lengths.sum()), hop, sr), "budget": budget,
                "wall_s": wall, "mel_lengths": lengths.tolist(), "truncated": truncated}

    # ------------------------------------------------------------- API
    def warmup(self, batch_sizes: Sequence[int] = (1,), text: str = "warm up the kernels"):
        """Run every (batch, budget) decode once: builds the CUDA kernels and
        lets the convolution library pick its algorithms before serving."""
        for bs in batch_sizes:
            with self._lock:
                x, xl = self._tokenize([text] * bs)
                enc = self.model.encode_durations(x, xl, self.cfg.length_scale)
                for budget in self.cfg.mel_budgets:
                    z = self._noise(bs, budget, seed=0, seeds=None)
                    self._decode_vocode(enc, z, budget).cpu()

    def synthesise(self, texts: Sequence[str], seed: Optional[int] = None,
                   seeds: Optional[Sequence[int]] = None):
        """Texts -> (list of waveforms, info). Thread-safe.

        `seed`: one noise draw shaped over the batch. `seeds`: one seed per
        text, each waveform a function of (text, seed, budget) only. Neither:
        the engine's own generator. Waveforms are float32, or int16 when
        `output_dtype="int16"`.
        """
        cfg = self.cfg
        if len(texts) == 0:
            return [], {"rtf": float("nan"), "budget": 0}
        if len(texts) > cfg.max_batch:
            raise ValueError(f"batch of {len(texts)} exceeds max_batch={cfg.max_batch}")
        if seeds is not None and len(seeds) != len(texts):
            raise ValueError("seeds must have one entry per text")
        with self._lock:
            t0 = time.perf_counter()
            x, xl = self._tokenize(texts)
            enc = self.model.encode_durations(x, xl, cfg.length_scale)
            y_np = enc[3].cpu().numpy()  # the one host read: picks the budget
            budget = self._pick_budget(fix_len_compatibility(int(y_np.max())))
            z = self._noise(len(texts), budget, seed, seeds)
            packed = self._decode_vocode(enc, z, budget).cpu().numpy()
            wall = time.perf_counter() - t0
        wavs, lengths, predicted = self._finish(packed, len(texts))
        truncated = [int(p) > budget for p in predicted]
        if any(truncated):
            warnings.warn(
                f"{sum(truncated)}/{len(texts)} utterance(s) exceed the largest mel budget "
                f"({budget} frames) and were truncated; raise ServeConfig.mel_budgets "
                "for longer audio", stacklevel=2)
        return wavs, self._info(wall, budget, lengths, truncated)

    def synthesise_lowlatency(self, text: str, seed: Optional[int] = None,
                              budget: Optional[int] = None):
        """One utterance at a fixed `budget` (default: the largest), with no host
        read between encoder and decoder. Returns (waveform, info); with a seed,
        equals `synthesise([text], seeds=[seed])` when that picks the same budget."""
        budget = budget if budget is not None else max(self.cfg.mel_budgets)
        with self._lock:
            t0 = time.perf_counter()
            x, xl = self._tokenize([text])
            enc = self.model.encode_durations(x, xl, self.cfg.length_scale)
            z = self._noise(1, budget, None, None if seed is None else [seed])
            packed = self._decode_vocode(enc, z, budget).cpu().numpy()
            wall = time.perf_counter() - t0
        wavs, lengths, predicted = self._finish(packed, 1)
        truncated = int(predicted[0]) > budget
        if truncated:
            warnings.warn(f"utterance predicts {int(predicted[0])} mel frames, beyond the "
                          f"{budget}-frame budget; output truncated, pass a larger `budget`",
                          stacklevel=2)
        return wavs[0], self._info(wall, budget, lengths, truncated)
