"""matcha_tpu_torch: the PyTorch/CUDA port of the Matcha-TTS framework.

A second package beside the JAX reference `matcha_tpu`. It imports neither JAX
nor anything of `matcha_tpu`: plain tensor code is PyTorch, and each Pallas
kernel of the reference is a CUDA C++ kernel for Hopper (`csrc/`), built with
`nvcc` on first use (`ops/_build.py`).

Device policy: entry points take `device=None`, which means the CUDA card; they
raise when there is none and never run on the CPU unless the caller asks for it
(`device="cpu"`, as the tests do). Kernel wrappers pick their path from the
tensor they are given: the plain PyTorch version for a CPU tensor, the kernel
for a CUDA tensor (or an exception) — no fallback between the two.

Precision policy: float32 runs are float32 end to end. TF32 is off for both
matmuls and cuDNN convolutions (`apply_tf32_policy`), so a float32 run on the
card can be held against the CPU and the JAX reference.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA card. Raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "matcha_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def apply_tf32_policy() -> None:
    """Keep float32 matmuls and cuDNN convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
