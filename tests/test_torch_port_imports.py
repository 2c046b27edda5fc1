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
new = {"matcha_tpu_torch.nn.dropout", "matcha_tpu_torch.data.ljspeech",
       "matcha_tpu_torch.utils.profiling", "matcha_tpu_torch.utils.plotting",
       "matcha_tpu_torch.data.audio_dataset", "matcha_tpu_torch.train.vocoder",
       "matcha_tpu_torch.cli.train_vocoder", "matcha_tpu_torch.text.cmudict",
       "matcha_tpu_torch.compat.torch_import", "matcha_tpu_torch.ops.mas_cpp",
       "matcha_tpu_torch.cli.generate", "matcha_tpu_torch.cli.serve",
       "matcha_tpu_torch.cli.bench_mas", "matcha_tpu_torch.cli.vocoder_report",
       "matcha_tpu_torch.cli.analyze", "matcha_tpu_torch.data.download",
       "matcha_tpu_torch.parallel", "matcha_tpu_torch.parallel.mesh",
       "matcha_tpu_torch.parallel.sharding", "matcha_tpu_torch.parallel.ring_attention",
       "matcha_tpu_torch.cli.bench_scaling"}
assert new <= set(names), new - set(names)
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
from matcha_tpu_torch.ops import mas
from matcha_tpu_torch.ops.attention import attention, attention_backward
from matcha_tpu_torch.ops.mrf import mrf_step
from matcha_tpu_torch.serve import ServeConfig, TTSEngine
from matcha_tpu_torch.train.trainer import TrainConfig, Trainer
from matcha_tpu_torch.train.vocoder import VocoderTrainConfig, VocoderTrainer
from matcha_tpu_torch.cli import (bench_mas, bench_scaling, generate, serve, train_vocoder,
                                  vocoder_report)
from matcha_tpu_torch.audio.mel import MelConfig
from matcha_tpu_torch.parallel import make_mesh
from matcha_tpu_torch.parallel.ring_attention import ring_attention_local

assert not torch.cuda.is_available()
for call in (lambda: resolve_device(None),
             lambda: TTSEngine(MatchaTTS(tiny_config()).state_dict(), tiny_config(),
                               ServeConfig(vocoder="hifigan"),
                               Generator(HiFiGANConfig(num_mels=8)).state_dict(),
                               HiFiGANConfig(num_mels=8)),
             lambda: Trainer(tiny_config(), TrainConfig(ckpt_dir="unused-ckpt-dir")),
             lambda: Trainer(tiny_config(), TrainConfig(ckpt_dir="unused-ckpt-dir",
                                                        steps_per_dispatch=4)),
             lambda: VocoderTrainer(train_cfg=VocoderTrainConfig(ckpt_dir="unused-ckpt-dir")),
             lambda: train_vocoder.main(["--synthetic", "--ckpt-dir", "unused-ckpt-dir"]),
             lambda: generate.main(["--ckpt-dir", "unused-ckpt-dir",
                                    "--out-dir", "unused-ckpt-dir"]),
             lambda: serve.main(["--texts", "a", "--ckpt-dir", "unused-ckpt-dir",
                                 "--out-dir", "unused-ckpt-dir"]),
             lambda: bench_mas.main([]),
             lambda: bench_scaling.main(["--devices", "2"]),
             lambda: TTSEngine(MatchaTTS(tiny_config()).state_dict(), tiny_config(),
                               ServeConfig(mel_cfg=MelConfig(n_mels=8)),
                               mesh=make_mesh(devices=["cuda", "cuda"])),
             lambda: vocoder_report.main(["--synthetic", "--out", "unused-ckpt-dir/r.json"])):
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
value = torch.empty(2, 8, 16, device="meta")
lengths = torch.empty(2, dtype=torch.int32, device="meta")
for call in (lambda: attention(q, q, q, None, 0.125),
             lambda: mrf_step(torch.empty(1, 8, 16, device="meta"), w, b, w, b, 1),
             lambda: mas.maximum_path(value, value, lengths, lengths),
             lambda: attention_backward(q, q, q, None, q, q,
                                        torch.empty(1, 4, 8, device="meta"), 0.125),
             lambda: ring_attention_local(q, [(q, q, torch.empty(1, 8, device="meta"))])):
    try:
        call()
    except ValueError as e:
        assert "CUDA" in str(e), e
    else:
        raise SystemExit("a wrapper ran its plain version on a non-CPU tensor")
assert attention.launches == 0 and mrf_step.launches == 0
assert attention_backward.launches == 0
assert mas.mas_cuda.launches == 0
import os
assert not os.path.exists("unused-ckpt-dir")  # raised before touching the disk
print("OK")
"""


def test_default_device_raises_without_cuda_and_nothing_falls_back():
    out = subprocess.run([sys.executable, "-c", _NO_CUDA], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stdout + out.stderr
