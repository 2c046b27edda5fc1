"""Dropout that draws its masks from an explicit generator.

`nn.Dropout` draws from the default generator, which a training step would
have to reseed (a host call) and which a CUDA graph of K micro-steps cannot
reseed between its steps. This `Dropout` draws from the generator that
`dropout_generator` sets for the current context (the trainer's, one per
micro-step slot; a CUDA graph registers it and the host seeds it before each
replay), or from the default generator when none is set. A mask is
Bernoulli(1 - p), 0/1 in the activation's dtype (exact in bf16), and the
kept values are scaled by 1 / (1 - p) in f32 arithmetic; the same seed draws
the same masks eagerly and in a replay.

`keep_mask` draws a mask apart from its use: the decoder's transformer
blocks draw theirs before an activation checkpoint, so that a recompute
reuses them (`torch.utils.checkpoint` restores only the default generators).
A subclass of `nn.Dropout`: no parameters, so state-dict keys are unchanged.

Several ranks (`parallel/`): a mask is drawn at the global batch's shape and
cut to this rank's rows (`draw_rows` under `batch_rows`), and a mask on a
tensor-parallel hidden at full width and cut to this rank's block (`split`,
set by `TensorParallel.shard`), so the masks do not depend on how the work
is split.
"""

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn as nn

from matcha_tpu_torch.parallel.mesh import draw_rows

_generator: contextvars.ContextVar = contextvars.ContextVar("dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]):
    """Draw every `Dropout` mask of this context from `generator`."""
    token = _generator.set(generator)
    try:
        yield
    finally:
        _generator.reset(token)


class Dropout(nn.Dropout):
    """Zero each element with probability p and scale the rest by 1 / (1 - p),
    in `train()` only."""

    # (dim, index, count): this rank's block of a tensor-parallel dimension
    split = None

    def keep_mask(self, shape, device, dtype=torch.float32) -> Optional[torch.Tensor]:
        """A 0/1 mask of `shape` (1 = kept), or None when dropout is off."""
        if not self.training or self.p == 0:
            return None
        gen = _generator.get()
        return draw_rows(lambda full: torch.empty(full, device=device, dtype=dtype).bernoulli_(
            1.0 - self.p, generator=gen), shape, self.split)

    def forward(self, x, keep: Optional[torch.Tensor] = None):
        if not self.training or self.p == 0:
            return x
        if keep is None:
            keep = self.keep_mask(x.shape, x.device, x.dtype)
        return x * keep * (1.0 / (1.0 - self.p))
