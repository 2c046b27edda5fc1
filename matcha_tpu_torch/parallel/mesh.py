"""Process groups, the port's mesh, and a rank's rows of a global batch.

The port of `matcha_tpu/parallel/mesh.py` on `torch.distributed`. A run over
several cards is one process a card, started by `torchrun --nproc_per_node
N`; `init_distributed` joins them from the launcher's environment (NCCL for
the card, gloo for `device="cpu"`), and a rank's card is `cuda:LOCAL_RANK`.
`make_mesh` lays the ranks out as a (`data`, `model`) grid with one process
group an axis (`torch.distributed.device_mesh.init_device_mesh`), row-major
as `jax.make_mesh`: rank = data index * model + model index. One process
serving over its local cards takes a mesh of devices instead
(`make_mesh(devices=...)`), which has no process groups.

Global-batch semantics. JAX computes a step on the global batch array, which
its ranks hold in row blocks. A rank of the port holds its block only, so
what JAX draws or sums over the global batch is done here explicitly, under
`batch_rows(rows)`:
  * `draw_rows(draw, shape)` draws the global shape (this rank's block of
    rows times the rank count) and keeps this rank's rows, so that the CFM
    noise, the crop offsets and the dropout masks do not depend on the world
    size;
  * `batch_sum(t)` sums a loss normaliser over the data group, so that each
    rank's loss is its share of the global loss and the gradients summed
    over the group are the global gradient.
Without `batch_rows` both are the identity on one rank's batch.
"""

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_mesh: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)
_rows: contextvars.ContextVar = contextvars.ContextVar("batch_rows", default=None)


def init_distributed(device=None) -> bool:
    """Join the process group the launcher describes; returns whether this
    call joined.

    The environment decides, never the device: `MASTER_ADDR` (with
    `MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, as torchrun exports
    them) or `MATCHA_DISTRIBUTED=1` (take them from the launcher) joins;
    neither is a single-process run and a no-op. The backend follows
    `device` (None is the card): NCCL on the card, whose rank then binds
    `cuda:LOCAL_RANK`, gloo on the CPU. Idempotent.
    """
    if dist.is_initialized():
        return False
    if not (os.environ.get("MASTER_ADDR") or os.environ.get("MATCHA_DISTRIBUTED")):
        return False
    cpu = torch.device("cuda" if device is None else device).type == "cpu"
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://")
    if not cpu:
        torch.cuda.set_device(local_rank())
    return True


def rank() -> int:
    """This process's rank (`jax.process_index`); 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The number of processes (`jax.process_count`); 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0: the process that writes checkpoints, metrics.jsonl and TensorBoard."""
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


class Mesh:
    """Named axes over ranks (a `DeviceMesh`) or over one process's devices.

    A rank mesh has a process group and a size per axis and this rank's
    coordinate on it (`group`, `size`, `index`), and `device`, this rank's
    device. A device mesh (`make_mesh(devices=...)`) has one `data` axis over
    `devices` and no groups: the serving engine replicates its weights over
    them. `with mesh:` makes it the ambient mesh (`current_mesh`).
    """

    def __init__(self, device_mesh=None, devices: Optional[Sequence] = None):
        if (device_mesh is None) == (devices is None):
            raise ValueError("a Mesh is over ranks (a DeviceMesh) or over devices, not both")
        self.device_mesh = device_mesh
        if device_mesh is not None:
            self.axes = tuple(device_mesh.mesh_dim_names)
            self._sizes = dict(zip(self.axes, device_mesh.mesh.shape))
            cuda = device_mesh.device_type == "cuda"
            self.devices = (torch.device("cuda", torch.cuda.current_device()) if cuda
                            else torch.device("cpu"),)
        else:
            self.axes = (DATA_AXIS,)
            self.devices = tuple(torch.device(d) for d in devices)
            self._sizes = {DATA_AXIS: len(self.devices)}
        self._token = []

    @property
    def shape(self) -> dict:
        return dict(self._sizes)

    @property
    def device(self) -> torch.device:
        """This rank's device (the first device of a device mesh)."""
        return self.devices[0]

    def size(self, axis: str) -> int:
        return self._sizes[axis]

    def group(self, axis: str):
        if self.device_mesh is None:
            raise ValueError("a mesh of devices has no process groups")
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return self.device_mesh.get_local_rank(axis)

    def rows(self) -> "BatchRows":
        """This rank's rows of a global batch: its block on the data axis."""
        return BatchRows(self.index(DATA_AXIS), self.size(DATA_AXIS), self.group(DATA_AXIS))

    def __enter__(self):
        self._token.append(_mesh.set(self))
        return self

    def __exit__(self, *exc):
        _mesh.reset(self._token.pop())


def make_mesh(data: Optional[int] = None, model: Optional[int] = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The (`data`, `model`) mesh over the process group's ranks, or, with
    `devices`, a `data` mesh over this process's devices (serving).

    `model=None` makes a mesh of the `data` axis alone: data parallelism
    without the tensor-parallel path, which a mesh with a `model` axis runs
    at any size, 1 included. Needs `torch.distributed` joined
    (`init_distributed`) unless `devices` is given.
    """
    if devices is not None:
        devices = list(devices)
        if model not in (None, 1) or (data is not None and data != len(devices)):
            raise ValueError(f"a device mesh is {len(devices)} x 1, asked for {data} x {model}")
        return Mesh(devices=devices)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh over ranks needs torch.distributed: run under torchrun "
                           "(init_distributed), or pass devices=")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    m = 1 if model is None else model
    if data is None:
        if n % m:
            raise ValueError(f"{n} ranks do not divide into model={m}")
        data = n // m
    if data * m != n:
        raise ValueError(f"mesh {data} x {m} != {n} ranks")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if model is None:
        return Mesh(init_device_mesh(kind, (data,), mesh_dim_names=(DATA_AXIS,)))
    return Mesh(init_device_mesh(kind, (data, m), mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `with mesh:`, or None."""
    return _mesh.get()


@torch.no_grad()
def replicated(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from the group's first rank
    (JAX's replicated placement); returns the module."""
    if dist.is_initialized():
        src = dist.get_global_rank(group, 0) if group is not None else 0
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


def put_global_batch(mesh: Optional[Mesh], batch: dict, device=None) -> dict:
    """This rank's local batch (the `[index::count]` cut of the data path,
    padded to the global batch's shapes) as tensors on its device: the
    mesh's, or `device` without a mesh."""
    dev = mesh.device if mesh is not None else torch.device(device or "cuda")
    return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}


# ----------------------------------------------------- global-batch semantics
@dataclass(frozen=True)
class BatchRows:
    """This rank's block of a global batch: block `index` of `count` equal
    blocks, over the data `group`."""

    index: int
    count: int
    group: object = None


@contextlib.contextmanager
def batch_rows(rows: Optional[BatchRows]):
    """Draw and normalise over the global batch that `rows` cuts (see the module)."""
    token = _rows.set(rows)
    try:
        yield
    finally:
        _rows.reset(token)


def draw_rows(draw: Callable, shape, split: Optional[tuple] = None) -> torch.Tensor:
    """`draw(global shape)` cut to this rank's part of dim 0 (its rows, under
    `batch_rows`) and, with `split` = (dim, index, count), to block `index` of
    `count` of dim `dim` (a tensor-parallel shard). Without either it is
    `draw(shape)`."""
    rows = _rows.get()
    full = list(shape)
    if rows is not None:
        full[0] *= rows.count
    if split is not None:
        full[split[0]] *= split[2]
    out = draw(tuple(full))
    if rows is not None:
        out = out.narrow(0, rows.index * shape[0], shape[0])
    if split is not None:
        dim, index, _ = split
        out = out.narrow(dim, index * shape[dim], shape[dim])
    return out


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the data group under `batch_rows` (a new tensor; not
    differentiated: it is for loss normalisers); `t` itself otherwise."""
    rows = _rows.get()
    if rows is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=rows.group)
    return t


def all_reduce_flat(tensors: Sequence[torch.Tensor], group, scale: Optional[float] = None):
    """Sum `tensors` over `group` in one collective a dtype (flattened into one
    buffer and back), times `scale` when given; returns new tensors."""
    tensors = list(tensors)
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        if scale is not None:
            flat.mul_(scale)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out
