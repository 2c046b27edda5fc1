"""The port stands alone: no JAX, nothing of `matcha_tpu`, no silent CPU path.

Run in a fresh interpreter, so that modules other tests imported do not hide
an import the port makes itself.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import matcha_tpu_torch

names = ["matcha_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(matcha_tpu_torch.__path__, "matcha_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules
                if n == "jax" or n.startswith(("jax.", "jaxlib", "flax", "optax"))
                or n == "matcha_tpu" or n.startswith("matcha_tpu."))
print("MODULES", len(names))
print("LEAKED", leaked)
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    n_modules = int(out.stdout.split("MODULES ")[1].split()[0])
    assert n_modules >= 20  # every module of the package, not just its root


_NO_CUDA = r"""
import torch
from matcha_tpu_torch import resolve_device
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaTTS, tiny_config
from matcha_tpu_torch.ops.attention import attention
from matcha_tpu_torch.ops.mrf import mrf_step
from matcha_tpu_torch.serve import ServeConfig, TTSEngine

assert not torch.cuda.is_available()
for call in (lambda: resolve_device(None),
             lambda: TTSEngine(MatchaTTS(tiny_config()).state_dict(), tiny_config(),
                               ServeConfig(), Generator(HiFiGANConfig(num_mels=8)).state_dict(),
                               HiFiGANConfig(num_mels=8))):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("a default-device entry point ran without CUDA")

# a tensor that is not on the CPU never takes the plain path: the wrapper
# goes to the kernel, which refuses a tensor that is not on a CUDA device
q = torch.empty(1, 4, 8, 64, device="meta")
w = torch.empty(8, 8, 3, device="meta")
b = torch.empty(8, device="meta")
for call in (lambda: attention(q, q, q, None, 0.125),
             lambda: mrf_step(torch.empty(1, 8, 16, device="meta"), w, b, w, b, 1)):
    try:
        call()
    except ValueError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("a wrapper ran its plain version on a non-CPU tensor")
assert attention.launches == 0 and mrf_step.launches == 0
print("OK")
"""


def test_default_device_raises_without_cuda_and_nothing_falls_back():
    out = subprocess.run([sys.executable, "-c", _NO_CUDA], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stdout + out.stderr
