"""Distributed layer on torch.distributed: the mesh, global-batch semantics,
tensor-parallel rules and ring attention."""

from matcha_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    BatchRows,
    Mesh,
    batch_rows,
    batch_sum,
    current_mesh,
    draw_rows,
    init_distributed,
    is_main,
    make_mesh,
    put_global_batch,
    rank,
    replicated,
    world,
)
from matcha_tpu_torch.parallel.sharding import TensorParallel, param_spec

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "BatchRows",
    "Mesh",
    "TensorParallel",
    "batch_rows",
    "batch_sum",
    "current_mesh",
    "draw_rows",
    "init_distributed",
    "is_main",
    "make_mesh",
    "param_spec",
    "put_global_batch",
    "rank",
    "replicated",
    "world",
]
