"""Precision helpers: bf16 serving, and the bf16 view of mixed-precision training.

Serving casts a module's floating-point parameters to bf16 in place. Every
activation of the port follows its parameters' dtype (embedding output,
masks, noise), so a bf16 module runs the whole forward in bf16; paths, time
values and the kernels' softmax and accumulators stay f32 where the code says.
"""

import torch


def bf16_serving(module: torch.nn.Module) -> torch.nn.Module:
    """Cast `module`'s floating-point parameters and buffers to bf16, in place."""
    return module.to(torch.bfloat16)


def mixed_precision_params(module: torch.nn.Module, dtype=torch.bfloat16):
    """A `dtype` view of `module`'s floating-point parameters for one forward.

    The casts are autograd operations: run the module on them with
    `torch.func.functional_call`, and the gradients flow back, cast to f32,
    into the f32 master parameters, which stay as they are (`module.to(dtype)`
    would cast the masters in place). Non-floating buffers pass unchanged.
    """
    view = {name: p.to(dtype) if p.is_floating_point() else p
            for name, p in module.named_parameters()}
    view.update({name: b.to(dtype) if b.is_floating_point() else b
                 for name, b in module.named_buffers()})
    return view
