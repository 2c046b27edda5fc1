"""Tensor parallelism: the Megatron rules and the collectives they need.

The port of `matcha_tpu/parallel/sharding.py`. Data parallelism is the main
strategy (every parameter replicated); a mesh with a `model` axis also
shards the Megatron pairs over it: the column-parallel projections keep
their block of output features (and of the bias), the row-parallel ones
their block of input features, and each row-parallel output is summed over
the model group before its (replicated) bias is added. The rules, in the
port's state-dict names (the reference's):

  * encoder RoPE attention: `query_conv`, `key_conv`, `value_conv` column,
    `output_conv` row (heads split over the group; RoPE stays per head);
  * encoder ConvFFN: `conv_net.0` column, `conv_net.3` row;
  * decoder attention: `attn1.to_q`, `to_k`, `to_v` column, `to_out.0` row;
  * decoder feed-forward: `ff.net.0.proj` column, `ff.net.2` row.

The collectives are a pair of autograd functions, so that they run, and are
captured, inside the training graphs: `copy_to_group` (identity forward,
sum of the gradients backward) where a replicated activation enters a
column-parallel projection, and `reduce_from_group` (sum forward, identity
backward) after a row-parallel one. A dropout mask on a sharded hidden is
drawn at full width and cut (`Dropout.split`). Every rank builds the full
model from the seed and keeps its blocks (`TensorParallel.shard`), and a
checkpoint holds the gathered, full state (`gather`), so it loads at any
model size.
"""

import re
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from matcha_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

# (state-dict name pattern, the dimension a model rank keeps a block of)
RULES = (
    (r"encoder\.encoder\.attention_layers\.\d+\.(query|key|value)_conv\.(weight|bias)", 0),
    (r"encoder\.encoder\.attention_layers\.\d+\.output_conv\.weight", 1),
    (r"encoder\.encoder\.ffn_layers\.\d+\.conv_net\.0\.(weight|bias)", 0),
    (r"encoder\.encoder\.ffn_layers\.\d+\.conv_net\.3\.weight", 1),
    (r".*\.attn1\.to_[qkv]\.weight", 0),
    (r".*\.attn1\.to_out\.0\.weight", 1),
    (r".*\.ff\.net\.0\.proj\.(weight|bias)", 0),
    (r".*\.ff\.net\.2\.weight", 1),
)
# the modules whose forward runs the tensor-parallel path (`tp_group`)
_TP_MODULES = (r"encoder\.encoder\.attention_layers\.\d+", r"encoder\.encoder\.ffn_layers\.\d+",
               r".*\.attn1", r".*\.ff")
# where a sharded hidden meets a dropout: (module pattern, its dropout, the dim)
_TP_DROPOUTS = ((r"encoder\.encoder\.attention_layers\.\d+", "dropout", 1),
                (r"encoder\.encoder\.ffn_layers\.\d+", "conv_net.2", 1),
                (r".*\.ff", "net.1", 2))


def param_spec(name: str) -> Optional[int]:
    """The dimension of parameter `name` that a model rank keeps a block of,
    or None for a replicated parameter."""
    for pattern, dim in RULES:
        if re.fullmatch(pattern, name):
            return dim
    return None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over `group` (Megatron's f)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over `group`; the gradient passes through (Megatron's g)."""
    return _ReduceFromGroup.apply(x, group)


def row_parallel(layer: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel `nn.Linear` or `nn.Conv1d` on this rank's block of input
    features: its product summed over `group`, then its bias, once."""
    if isinstance(layer, nn.Linear):
        y = F.linear(x, layer.weight)
        bias = layer.bias
    else:
        y = F.conv1d(x, layer.weight, None, layer.stride, layer.padding, layer.dilation)
        bias = None if layer.bias is None else layer.bias[:, None]
    y = reduce_from_group(y, group)
    return y if bias is None else y + bias


class TensorParallel:
    """The tensor-parallel state of one model on the `model` axis of `mesh`.

    `shard()` cuts the parameters in place to this rank's blocks and turns on
    the modules' tensor-parallel path; `sharded` flags the parameters
    (in `model.parameters()` order) that hold a block. `norm`, `gather` and
    `load` work on lists in that order: the global norm of a gradient,
    full tensors from blocks, and blocks from a full state dict.
    """

    def __init__(self, model: nn.Module, mesh: Mesh):
        self.model = model
        self.group = mesh.group(MODEL_AXIS)
        self.index, self.count = mesh.index(MODEL_AXIS), mesh.size(MODEL_AXIS)
        self.names = [n for n, _ in model.named_parameters()]
        self.dims = [param_spec(n) for n in self.names]
        self.sharded = [d is not None for d in self.dims]

    def _block(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        size = full.shape[dim]
        if size % self.count:
            raise ValueError(f"dimension {dim} of size {size} does not split over "
                             f"{self.count} model ranks")
        n = size // self.count
        return full.narrow(dim, self.index * n, n).clone()

    @torch.no_grad()
    def shard(self) -> None:
        for p, dim in zip(self.model.parameters(), self.dims):
            if dim is not None:
                p.data = self._block(p.data, dim)
        for name, mod in self.model.named_modules():
            if any(re.fullmatch(pat, name) for pat in _TP_MODULES):
                heads = getattr(mod, "n_heads", getattr(mod, "heads", None))
                if heads is not None and heads % self.count:
                    raise ValueError(f"{name} has {heads} heads, which do not split over "
                                     f"{self.count} model ranks")
                mod.tp_group = self.group
                for sub in mod.modules():  # the sliced layers report their local widths
                    if isinstance(sub, nn.Linear):
                        sub.out_features, sub.in_features = sub.weight.shape
                    elif isinstance(sub, nn.Conv1d):
                        sub.out_channels, sub.in_channels = sub.weight.shape[:2]
            for pat, attr, dim in _TP_DROPOUTS:
                if re.fullmatch(pat, name):
                    mod.get_submodule(attr).split = (dim, self.index, self.count)

    def norm(self, tensors) -> torch.Tensor:
        """The global L2 norm of `tensors` (one per parameter): replicated ones
        counted once, the squares of the blocks summed over the model group."""
        sq = [torch.sum(t.float() ** 2) for t in tensors]
        rep = [s for s, sh in zip(sq, self.sharded) if not sh]
        blk = torch.stack([s for s, sh in zip(sq, self.sharded) if sh]).sum()
        dist.all_reduce(blk, group=self.group)
        return torch.sqrt(torch.stack(rep).sum() + blk)

    @torch.no_grad()
    def gather(self, tensors) -> list:
        """Full tensors from this rank's blocks (a collective on the model group)."""
        out = []
        for t, dim in zip(tensors, self.dims):
            if dim is None:
                out.append(t)
                continue
            parts = [torch.empty_like(t) for _ in range(self.count)]
            dist.all_gather(parts, t.contiguous(), group=self.group)
            out.append(torch.cat(parts, dim=dim))
        return out

    def state_dict(self) -> dict:
        """The model's full state dict, its blocks gathered."""
        sd = self.model.state_dict()
        full = self.gather([sd[n] for n in self.names])
        sd.update(zip(self.names, full))
        return sd

    def blocks(self, tensors) -> list:
        """This rank's blocks of full tensors (one per parameter)."""
        return [t if d is None else self._block(t, d) for t, d in zip(tensors, self.dims)]

    @torch.no_grad()
    def load_state_dict(self, full: dict) -> None:
        sd = dict(full)
        sd.update(zip(self.names, self.blocks([full[n] for n in self.names])))
        self.model.load_state_dict(sd)
