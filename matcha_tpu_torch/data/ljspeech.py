"""LJSpeech acquisition and splits: `train.txt` and `val.txt` from `metadata.csv`.

The port of `matcha_tpu/data/ljspeech.py`: `download` fetches the LJSpeech-1.1
tarball (network access required; a failed fetch leaves no partial file),
`extract` unpacks it, and `process_csv` writes `<wav path>|<transcript>` lines
with the 98/2 split drawn from `random.Random(SPLIT_SEED)`, the same lines as
the JAX package writes. `prepare` (or `python -m matcha_tpu_torch.data.ljspeech
[output_dir] [-s save_dir]`) does all three, reusing a tarball already there.
"""

import random
import sys
import tarfile
import urllib.request
from pathlib import Path

URL = "https://data.keithito.com/data/speech/LJSpeech-1.1.tar.bz2"
SPLIT_SEED = 42
TRAIN_FRACTION = 0.98


def download(save_path, url: str = URL) -> Path:
    """Fetch the dataset tarball to `save_path`; remove the partial file on failure."""
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = save_path.with_suffix(".partial")
    try:
        urllib.request.urlretrieve(url, tmp)
        tmp.rename(save_path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    return save_path


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


def prepare(output_dir="data", save_dir=None):
    """Download (unless the tarball is in `save_dir`, or else `output_dir`),
    extract into `output_dir` and split; returns (train count, val count)."""
    outpath = Path(output_dir)
    outpath.mkdir(parents=True, exist_ok=True)
    tarball = Path(save_dir if save_dir is not None else outpath) / URL.rsplit("/", 1)[-1]
    if not tarball.exists():
        print(f"downloading {URL} -> {tarball}", file=sys.stderr)
        download(tarball)
    extract(tarball, outpath)
    return process_csv(outpath)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Download, extract and split LJSpeech-1.1")
    ap.add_argument("output_dir", nargs="?", default="data")
    ap.add_argument("-s", "--save-dir", default=None)
    args = ap.parse_args()
    prepare(args.output_dir, args.save_dir)
