"""LJSpeech splits: `train.txt` and `val.txt` from `metadata.csv`.

The port of `matcha_tpu/data/ljspeech.py` without its download: `extract`
unpacks a tarball that is already on disk, and `process_csv` writes
`<wav path>|<transcript>` lines with the 98/2 split drawn from
`random.Random(SPLIT_SEED)`, the same lines as the JAX package writes.
"""

import random
import tarfile
from pathlib import Path

SPLIT_SEED = 42
TRAIN_FRACTION = 0.98


def extract(tar_path, out_dir) -> Path:
    """Unpack the LJSpeech tarball `tar_path` into `out_dir`."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with tarfile.open(tar_path) as tf:
        tf.extractall(out_dir, filter="data")
    return out_dir


def _find_base(ljpath) -> Path:
    """The directory holding metadata.csv: `ljpath`, its `LJSpeech-1.1`, or a
    subdirectory whose name contains "ljspeech"."""
    ljpath = Path(ljpath)
    if (ljpath / "metadata.csv").exists():
        return ljpath
    if (ljpath / "LJSpeech-1.1" / "metadata.csv").exists():
        return ljpath / "LJSpeech-1.1"
    for subdir in ljpath.iterdir():
        if subdir.is_dir() and "ljspeech" in subdir.name.lower():
            if (subdir / "metadata.csv").exists():
                return subdir
    raise FileNotFoundError(f"metadata.csv not found under {ljpath}")


def process_csv(ljpath, output_dir=None, seed: int = SPLIT_SEED):
    """Write train.txt and val.txt (98/2 split) from metadata.csv; returns
    (train count, val count)."""
    basepath = _find_base(Path(ljpath))
    wavpath = basepath / "wavs"
    output_dir = Path(output_dir) if output_dir is not None else basepath
    output_dir.mkdir(parents=True, exist_ok=True)

    rng = random.Random(seed)
    train_count = val_count = 0
    with (
        open(basepath / "metadata.csv", encoding="utf-8") as csvf,
        open(output_dir / "train.txt", "w", encoding="utf-8") as tf,
        open(output_dir / "val.txt", "w", encoding="utf-8") as vf,
    ):
        for line in csvf:
            parts = line.strip().split("|")
            if len(parts) < 2:
                continue
            wavfile = str(wavpath / f"{parts[0]}.wav")
            if rng.random() < TRAIN_FRACTION:
                tf.write(f"{wavfile}|{parts[1]}\n")
                train_count += 1
            else:
                vf.write(f"{wavfile}|{parts[1]}\n")
                val_count += 1
    return train_count, val_count
