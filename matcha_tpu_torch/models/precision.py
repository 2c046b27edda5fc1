"""Serving precision: cast a module's floating-point parameters to bf16.

Every activation of the port follows its parameters' dtype (embedding output,
masks, noise), so a bf16 module runs the whole forward in bf16; paths, time
values and the kernels' softmax and accumulators stay f32 where the code says.
"""

import torch


def bf16_serving(module: torch.nn.Module) -> torch.nn.Module:
    """Cast `module`'s floating-point parameters and buffers to bf16, in place."""
    return module.to(torch.bfloat16)
