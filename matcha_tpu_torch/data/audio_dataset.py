"""Waveform segments for vocoder (HiFi-GAN) training.

The port of `matcha_tpu/data/audio_dataset.py`, numpy on the host, so that it
gives the JAX package's batches bit for bit: fixed (batch, segment_size)
float32 segments, cut from wav files at offsets drawn from the epoch's
generator (or from synthetic speech-shaped waveforms). The mels of the
generator's input and of the reconstruction loss are computed on the device
inside the GAN step (`train/vocoder.py`). `process_index`/`process_count`
keep the JAX schedule for several processes; the port trains on one.
"""

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List

import numpy as np

from matcha_tpu_torch.audio.mel import load_wav


@dataclass(frozen=True)
class AudioDataConfig:
    batch_size: int = 16
    segment_size: int = 8192  # samples per training segment
    shuffle_seed: int = 1234


class WavSegmentDataset:
    """A metadata file of `wav_path|text` lines (or a directory of wavs) -> waveforms."""

    def __init__(self, source, segment_size: int = 8192):
        self.segment_size = segment_size
        src = Path(source)
        self.paths: List[str] = []
        if src.is_dir():
            self.paths = sorted(str(p) for p in src.glob("**/*.wav"))
        else:
            with open(src, encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split("|")
                    if parts and parts[0]:
                        self.paths.append(parts[0])
        if not self.paths:
            raise ValueError(f"no wav files found under {source}")

    def __len__(self):
        return len(self.paths)

    def get_segment(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        """A random fixed-size segment of utterance `idx` (zero-padded if shorter)."""
        y, _ = load_wav(self.paths[idx])
        seg = self.segment_size
        if len(y) >= seg:
            start = int(rng.integers(0, len(y) - seg + 1))
            return y[start : start + seg]
        return np.pad(y, (0, seg - len(y)))


class SyntheticWavDataset:
    """Deterministic speech-shaped waveforms with the WavSegmentDataset interface."""

    def __init__(self, n_items: int = 64, segment_size: int = 8192, seed: int = 0,
                 sample_rate: int = 22050):
        self.n_items = n_items
        self.segment_size = segment_size
        self.seed = seed
        self.sample_rate = sample_rate

    def __len__(self):
        return self.n_items

    def get_segment(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        item_rng = np.random.default_rng(self.seed * 100003 + idx)
        t = np.arange(self.segment_size, dtype=np.float32) / self.sample_rate
        f0 = float(item_rng.uniform(80, 300))
        # a few harmonics under an amplitude envelope, plus light noise
        y = np.zeros_like(t)
        for h in range(1, 5):
            y += item_rng.uniform(0.1, 0.5) / h * np.sin(2 * np.pi * f0 * h * t)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * item_rng.uniform(1, 4) * t)
        y = y * env + 0.01 * item_rng.standard_normal(len(t)).astype(np.float32)
        return (0.8 * y / max(np.abs(y).max(), 1e-5)).astype(np.float32)


def wav_batch_iterator(
    ds,
    cfg: AudioDataConfig,
    epoch: int = 0,
    shuffle: bool = True,
    process_index: int = 0,
    process_count: int = 1,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """Static-shape (batch, segment_size) float32 batches.

    Every process computes the same global schedule (a permutation seeded by
    `shuffle_seed + epoch`, cut into buckets of `batch_size * process_count`
    indices, a short tail dropped or wrap-padded) and loads its
    `[process_index::process_count]` slice of each bucket.
    """
    order = np.arange(len(ds))
    rng = np.random.default_rng(cfg.shuffle_seed + epoch)
    if shuffle:
        rng.shuffle(order)
    gbs = cfg.batch_size * process_count
    for i in range(0, len(order), gbs):
        idxs = order[i : i + gbs]
        if len(idxs) < gbs:
            if drop_last:
                return
            idxs = np.tile(idxs, -(-gbs // len(idxs)))[:gbs]
        local = idxs[process_index::process_count]
        yield np.stack([ds.get_segment(int(j), rng) for j in local])
