"""Text+mel training data: the JAX package's data pipeline.

The port of `matcha_tpu/data/dataset.py`. For a given seed it gives the same
arrays and the same batch schedule as the JAX package:

  * batches are bucketed by length and padded to static (Tx, Ty) shapes, Ty a
    multiple of the U-Net's 2**downsamples;
  * every process computes the same global schedule from length metadata and
    loads its own contiguous block of each batch (block `process_index` of
    `process_count`);
  * `collate` guards the MAS precondition mel_frames >= text_tokens.

Tokenization is the training path's: `english_cleaners`, then char -> id, no EOS.
`TextMelDataset` reads `wav_path|text` metadata (an LJSpeech split from
`data/ljspeech.py`) and caches each file's log-mel on disk under the JAX
package's file names. `SyntheticDataset` gives deterministic speech-shaped
data with the same interface, so training runs without a dataset on disk.
Batches are numpy arrays: this is host-side data preparation, and the
trainer copies each batch to the device.
"""

import hashlib
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from matcha_tpu_torch.audio.mel import MelConfig, load_wav, mel_spectrogram, num_frames
from matcha_tpu_torch.ops.masks import fix_len_compatibility
from matcha_tpu_torch.text import train_text_to_sequence


@dataclass(frozen=True)
class DataConfig:
    batch_size: int = 16
    text_pad_multiple: int = 32
    mel_pad_multiple: int = 64  # a multiple of 4 (U-Net)
    max_text_len: int = 256
    max_mel_len: int = 1024
    shuffle_seed: int = 0


def _wav_num_samples(path) -> int:
    """Per-channel sample count from the RIFF header, without decoding audio.

    Walks the chunk list (fmt for the block size, data for the payload
    size), so float32 wavs and files with extra chunks are measured exactly.
    """
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        block_align = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size + (size & 1))
                block_align = struct.unpack("<H", fmt[12:14])[0]  # channels * bits / 8
            elif cid == b"data":
                if not block_align:
                    raise ValueError(f"{path}: data chunk before fmt chunk")
                return max(size // block_align, 1)
            else:
                f.seek(size + (size & 1), os.SEEK_CUR)
    raise ValueError(f"{path}: no data chunk found")


class TextMelDataset:
    """A metadata file of `wav_path|text` lines -> token ids and a cached log-mel.

    Each file's log-mel, (T, n_mels) float32, is computed once on the CPU
    (`audio.mel.mel_spectrogram`, host-side data preparation like collate)
    and saved under `cache_dir` (default: `mel_cache` beside the metadata)
    as `<wav stem>_<sha1 of the path, 16 hex>.npy`, the JAX package's name.
    """

    def __init__(self, metadata_path, mel_cfg: MelConfig = MelConfig(), cache_dir=None):
        self.mel_cfg = mel_cfg
        self.items: List[Tuple[str, str]] = []
        with open(metadata_path, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("|")
                if len(parts) >= 2:
                    self.items.append((parts[0], parts[1]))
        if cache_dir is None:
            cache_dir = Path(metadata_path).parent / "mel_cache"
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def __len__(self):
        return len(self.items)

    def _cache_path(self, wav_path: str) -> Path:
        key = hashlib.sha1(wav_path.encode()).hexdigest()[:16]
        return self.cache_dir / f"{Path(wav_path).stem}_{key}.npy"

    def _compute_mel(self, wav_path: str) -> np.ndarray:
        y, _ = load_wav(wav_path)
        mel = mel_spectrogram(self.mel_cfg, torch.from_numpy(y)[None, :])[0]  # (n_mels, T)
        return mel.T.numpy().astype(np.float32)

    def get(self, idx: int) -> dict:
        wav_path, text = self.items[idx]
        cache = self._cache_path(wav_path)
        if cache.exists():
            mel = np.load(cache)
        else:
            mel = self._compute_mel(wav_path)
            np.save(cache, mel)
        ids = np.asarray(train_text_to_sequence(text), dtype=np.int32)
        return {"x": ids, "y": mel}

    def mel_length(self, idx: int) -> int:
        """Mel frames from the RIFF header alone: a pure function of the wav
        file, never of the cache, so every process schedules alike."""
        return num_frames(self.mel_cfg, _wav_num_samples(self.items[idx][0]))

    def text_length(self, idx: int) -> int:
        """Token count, from the text alone."""
        return len(train_text_to_sequence(self.items[idx][1]))


class SyntheticDataset:
    """Deterministic speech-shaped data: `get(i)` -> {"x": ids, "y": (T, n_mels) mel}."""

    _SENTENCES = [
        "the quick brown fox jumps over the lazy dog",
        "hello world this is a synthetic matcha sample",
        "flow matching makes text to speech fast",
        "tensor processing units chew through matmuls",
        "monotonic alignment search runs on chip now",
    ]

    def __init__(self, n_items: int = 64, n_mels: int = 80, seed: int = 0,
                 min_frames: int = 80, max_frames: int = 400):
        self.n_mels = n_mels
        self.n_items = n_items
        self.seed = seed
        self.min_frames = min_frames
        self.max_frames = max_frames

    def __len__(self):
        return self.n_items

    def mel_length(self, idx: int) -> int:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        return int(rng.integers(self.min_frames, self.max_frames + 1))

    def text_length(self, idx: int) -> int:
        text = self._SENTENCES[idx % len(self._SENTENCES)]
        return min(len(train_text_to_sequence(text)), self.mel_length(idx))

    def get(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        t = int(rng.integers(self.min_frames, self.max_frames + 1))
        text = self._SENTENCES[idx % len(self._SENTENCES)]
        # text cropped to <= mel frames: every item meets the MAS precondition
        ids = np.asarray(train_text_to_sequence(text), dtype=np.int32)[:t]
        # smooth low-rank "mel": a random walk over time times fixed spectral envelopes
        k = 6
        env = rng.standard_normal((k, self.n_mels)).astype(np.float32)
        coef = np.cumsum(0.3 * rng.standard_normal((t, k)).astype(np.float32), axis=0)
        mel = np.tanh(coef @ env) * 2.0 - 5.0
        return {"x": ids, "y": mel.astype(np.float32)}


def _round_up(v, m):
    return ((v + m - 1) // m) * m


def pad_shapes(cfg: DataConfig, max_text: int, max_mel: int) -> Tuple[int, int]:
    """(Tx, Ty) static pad shapes for a batch with the given raw max lengths."""
    tx = min(_round_up(max_text, cfg.text_pad_multiple), cfg.max_text_len)
    ty_raw = min(_round_up(max_mel, cfg.mel_pad_multiple), cfg.max_mel_len)
    return tx, fix_len_compatibility(ty_raw)


def collate(items: List[dict], cfg: DataConfig, shape: Optional[Tuple[int, int]] = None) -> dict:
    """Pad examples to static shapes: {"x", "x_lengths", "y", "y_lengths"} numpy arrays.

    `shape`: an explicit (Tx, Ty), the global batch's when several processes
    collate slices of one batch. Raises when an item has fewer mel frames than
    text tokens: no monotonic alignment gives every token a frame then.
    """
    xs = [it["x"][: cfg.max_text_len] for it in items]
    ys = [it["y"][: cfg.max_mel_len] for it in items]
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        if yi.shape[0] < len(xi):
            raise ValueError(
                f"sample {i}: mel has {yi.shape[0]} frames but text has {len(xi)} "
                "tokens; monotonic alignment requires mel_frames >= text_tokens "
                "(filter or re-crop the example)")
    if shape is None:
        shape = pad_shapes(cfg, max(len(x) for x in xs), max(y.shape[0] for y in ys))
    tx, ty = shape
    n_mels = ys[0].shape[1]

    b = len(items)
    x = np.zeros((b, tx), np.int32)
    y = np.zeros((b, ty, n_mels), np.float32)
    xl = np.zeros((b,), np.int32)
    yl = np.zeros((b,), np.int32)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        lx, ly = min(len(xi), tx), min(yi.shape[0], ty)
        x[i, :lx] = xi[:lx]
        y[i, :ly] = yi[:ly]
        xl[i] = lx
        yl[i] = ly
    return {"x": x, "x_lengths": xl, "y": y, "y_lengths": yl}


def num_batches(n_items: int, cfg: DataConfig, process_count: int = 1,
                drop_last: bool = True) -> int:
    """Exact per-epoch batch count of `batch_iterator` for n_items.

    Items are cut into sort windows of 16 global batches; each window yields
    its full batches, plus one wrap-padded remainder when drop_last is False.
    The lr schedule's epoch length comes from here.
    """
    global_bs = cfg.batch_size * process_count
    window = global_bs * 16
    total = 0
    for start in range(0, n_items, window):
        chunk = min(window, n_items - start)
        total += chunk // global_bs
        if not drop_last and chunk % global_bs:
            total += 1
    return total


def batch_iterator(dataset, cfg: DataConfig, epoch: int = 0, shuffle: bool = True,
                   process_index: int = 0, process_count: int = 1,
                   drop_last: bool = True) -> Iterator[dict]:
    """Length-bucketed batches padded to static shapes, the same schedule on every process.

    Items are shuffled (seeded by `shuffle_seed` and `epoch`), sorted by mel
    length within windows of 16 global batches, cut into batches, and the batch
    order is shuffled. With drop_last=False the last short batch of a window
    is wrap-padded by cycling its items; its `n_real` key counts the distinct
    items, so validation can weight the batch mean.
    """
    n = len(dataset)
    global_bs = cfg.batch_size * process_count
    rng = np.random.default_rng(cfg.shuffle_seed * 1_000_003 + epoch)
    order = rng.permutation(n) if shuffle else np.arange(n)

    mel_lens = np.empty(n, np.int64)
    text_lens = np.empty(n, np.int64)
    for i in order:
        mel_lens[i] = dataset.mel_length(int(i))
        text_lens[i] = dataset.text_length(int(i))
    # the MAS precondition, checked on the schedule's metadata so every process raises alike
    eff_text = np.minimum(text_lens, cfg.max_text_len)
    eff_mel = np.minimum(mel_lens, cfg.max_mel_len)
    bad = np.nonzero(eff_text > eff_mel)[0]
    if bad.size:
        raise ValueError(
            f"dataset items {bad[:8].tolist()}...: text tokens exceed mel frames; "
            "monotonic alignment requires mel_frames >= text_tokens per sample "
            "(filter or re-crop these examples)")

    window = global_bs * 16
    buckets = []
    for start in range(0, len(order), window):
        chunk = order[start : start + window]
        chunk = chunk[np.argsort(mel_lens[chunk], kind="stable")]
        for bstart in range(0, len(chunk), global_bs):
            batch_idx = chunk[bstart : bstart + global_bs]
            n_real = len(batch_idx)
            if n_real < global_bs:
                if drop_last:
                    continue
                reps = -(-global_bs // n_real)
                batch_idx = np.tile(batch_idx, reps)[:global_bs]
            buckets.append((batch_idx, n_real))
    if shuffle:
        rng.shuffle(buckets)
    for batch_idx, n_real in buckets:
        shape = pad_shapes(cfg, int(text_lens[batch_idx].max()), int(mel_lens[batch_idx].max()))
        # Block `process_index` of the global batch, the rows that `draw_rows`
        # gives this rank's noise, crops and dropout: world n then trains as
        # world 1 at the global batch, which is what the JAX package's
        # single-process `make_mesh(data=n)` does. This departs on purpose from
        # the JAX package's multi-host pairing, a strided cut
        # (`matcha_tpu/data/dataset.py:328`, `parallel/mesh.py:116-130`).
        b = cfg.batch_size
        local_idx = batch_idx[process_index * b:(process_index + 1) * b]
        batch = collate([dataset.get(int(i)) for i in local_idx], cfg, shape=shape)
        batch["n_real"] = n_real
        yield batch
