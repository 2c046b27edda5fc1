"""The port's examples run end to end on the CPU at tiny widths.

`examples/demo_torch.py` and `examples/demo_serving_torch.py`, each in a
subprocess as a user runs it (`--tiny --device cpu`, 2 Euler steps): exit 0
and the wavs they announce, each 16-bit PCM at 22050 Hz, non-silent, a whole
number of hops long.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

ROOT = Path(__file__).resolve().parents[1]
HOP = 256


def _run(script, out, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--tiny",
                           "--device", "cpu", "--steps", "2", "--out", str(out), *extra],
                          cwd=out.parent, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def _check_wav(path):
    sr, wav = wavfile.read(path)
    assert sr == 22050 and wav.dtype == np.int16 and wav.ndim == 1, (path, sr, wav.dtype)
    assert wav.size > 0 and wav.size % HOP == 0 and np.abs(wav).max() > 0, path


def test_demo_torch_runs(tmp_path):
    out = tmp_path / "demo"
    stdout = _run("demo_torch.py", out)
    assert "RTF text->mel" in stdout and "with HiFi-GAN" in stdout, stdout
    for name in ("griffin_lim", "hifigan"):
        _check_wav(out / f"demo_{name}.wav")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert "demo_mel.png skipped" in stdout
    else:
        assert (out / "demo_mel.png").stat().st_size > 0


@pytest.mark.parametrize("vocoder", ["hifigan", "griffin_lim"])
def test_demo_serving_torch_runs(tmp_path, vocoder):
    out = tmp_path / "served"
    stdout = _run("demo_serving_torch.py", out, "--vocoder", vocoder)
    assert "low-latency: budget 128" in stdout and "serve() request 3" in stdout, stdout
    wavs = sorted(p.name for p in out.iterdir())
    assert wavs == sorted([f"batch_{i}.wav" for i in range(4)] + ["lowlatency.wav"]
                          + [f"serve_{i}.wav" for i in range(4)])
    for name in wavs:
        _check_wav(out / name)
