"""The C++/OpenMP CPU MAS (`csrc/mas_cpu.cpp`), a host reference on numpy arrays.

The port's copy of `matcha_tpu/ops/mas_cpp`, with the same API:
`maximum_path_cpp(value, mask)` and the raw batched DP `mas_batch_cpp`. Tests
and `cli/bench_mas.py` hold the plain version and the CUDA kernel against it;
no training route runs it (`TrainConfig.mas_impl` does not select it). The
library is built by `ops/_build.py` with g++ at first use, never at import,
into `build/matcha_tpu_torch/` with the source's digest in its name.
"""

import ctypes
import functools

import numpy as np

from matcha_tpu_torch.ops import _build

_INT_P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("mas_cpu").mas_batch
    fn.argtypes = [ctypes.POINTER(ctypes.c_float), _INT_P, _INT_P, _INT_P,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = None
    return fn


def mas_batch_cpp(score: np.ndarray, t_x: np.ndarray, t_y: np.ndarray) -> np.ndarray:
    """Raw batched DP: (B, Tx, Ty) float32 scores -> (B, Tx, Ty) int32 path."""
    score = np.ascontiguousarray(score, dtype=np.float32)
    b, tx, ty = score.shape
    t_x = np.ascontiguousarray(t_x, dtype=np.int32)
    t_y = np.ascontiguousarray(t_y, dtype=np.int32)
    if t_x.shape != (b,) or t_y.shape != (b,):
        raise ValueError(f"lengths {t_x.shape}, {t_y.shape} for a batch of {b}")
    if (t_x > tx).any() or (t_y > ty).any():
        raise ValueError(f"lengths past the score's ({tx}, {ty})")
    path = np.zeros((b, tx, ty), dtype=np.int32)
    _entry()(score.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), path.ctypes.data_as(_INT_P),
             t_x.ctypes.data_as(_INT_P), t_y.ctypes.data_as(_INT_P), b, tx, ty)
    return path


def maximum_path_cpp(value: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The reference wrapper's semantics (`monotonic_align/__init__.py:40`),
    numpy in and out: lengths from the mask's first column and row."""
    value = np.asarray(value, dtype=np.float32) * np.asarray(mask, dtype=np.float32)
    mask = np.asarray(mask)
    t_x = mask[:, :, 0].sum(axis=1).astype(np.int32)
    t_y = mask[:, 0, :].sum(axis=1).astype(np.int32)
    return mas_batch_cpp(value, t_x, t_y).astype(np.float32)
