"""Pretrained artifact download utilities.

The port of `matcha_tpu/data/download.py`: fetch a released checkpoint by URL
with partial-file clean-up, and tar or zip extraction. The URLs of the
reference's released artifacts are kept for users loading the original
weights (`compat/torch_import.py`).
"""

import tarfile
import urllib.request
import zipfile
from pathlib import Path

MATCHA_CKPT_URL = (
    "https://github.com/Raph1821/Matcha-TTS-etu-UPMC-ENSAM/releases/download/v1.0/matcha_final.ckpt"
)
HIFIGAN_V1_URL = (
    "https://github.com/Raph1821/Matcha-TTS-etu-UPMC-ENSAM/releases/download/v1.0/generator_v1"
)


def download_pretrained_model(url: str, dest) -> Path:
    """Download `url` to `dest` unless present; remove the partial file on failure."""
    dest = Path(dest)
    if dest.exists():
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".partial")
    try:
        print(f"downloading {url} -> {dest}")
        urllib.request.urlretrieve(url, tmp)
        tmp.rename(dest)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    return dest


def extract_archive(archive_path, out_dir) -> Path:
    """Extract a .tar[.gz|.bz2] or .zip archive into `out_dir`."""
    archive_path, out_dir = Path(archive_path), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = archive_path.name
    if name.endswith(".zip"):
        with zipfile.ZipFile(archive_path) as zf:
            zf.extractall(out_dir)
    elif ".tar" in name or name.endswith((".tgz", ".tbz2")):
        with tarfile.open(archive_path) as tf:
            tf.extractall(out_dir, filter="data")
    else:
        raise ValueError(f"unknown archive format: {name}")
    return out_dir
