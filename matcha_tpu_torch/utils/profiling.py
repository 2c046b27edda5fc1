"""Profiling and timing: torch.profiler traces, a step timer that waits for
the device, the real-time factor, and a count of a function's products.

The port of `matcha_tpu/utils/profiling.py`. A trace is a Chrome trace
(`trace_<pid>_<ms>.json`, open in Perfetto or chrome://tracing) of the host
and, on a CUDA device, of every kernel the card ran, the kernels inside
CUDA graph replays included.
"""

import contextlib
import os
import time
from pathlib import Path

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def synchronize(tree):
    """Wait until the device work that produces the tensors of `tree` is done."""
    for dev in {t.device for t in _leaves(tree) if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def start_trace(device=None, record_shapes: bool = False, warmup=None) -> torch.profiler.profile:
    """Start a torch.profiler trace of the host, and of the card when `device`
    is a CUDA device; `record_shapes`: each op's input shapes too. The tracer
    starts in a warm-up step whose events are discarded, where `warmup` (a
    callable) runs and the device is waited for: a trace started on a busy
    process can lose its first kernels (12 of 4 x 36 K2 launches of a
    generator graph on the H100), and the warm-up keeps that out of the record."""
    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities, record_shapes=record_shapes,
                                  schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
    prof.start()
    if warmup is not None:
        warmup()
    if cuda:
        torch.cuda.synchronize(device)
    prof.step()  # record from here
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir, device=None) -> Path:
    """Wait for the device, stop `prof` and write its Chrome trace into `log_dir`."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(log_dir, device=None, record_shapes: bool = False, warmup=None):
    """Trace the block into a Chrome trace in `log_dir` (`start_trace`'s
    arguments):

        with trace("/tmp/trace", device="cuda"):
            run_step(...)
    """
    prof = start_trace(device, record_shapes, warmup)
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir, device)


class StepTimer:
    """Wall-clock timer of steps that waits for the device's work: put the
    step's output tensors in `out["result"]`."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            synchronize(out["result"])
        self.times.append(time.perf_counter() - t0)

    @property
    def median(self):
        s = sorted(self.times)
        return s[len(s) // 2] if s else float("nan")


def rtf(wall_seconds: float, mel_frames: int, hop: int = 256, sr: int = 22050) -> float:
    """Real-time factor: wall time over the duration of the audio produced."""
    return wall_seconds * sr / (mel_frames * hop)


# what `product_flops` counts, for the records that carry its numbers
FLOP_COUNTER = ("products only: matmul, convolution, attention (torch.utils.flop_counter; "
                "elementwise work, normalisation and reductions not counted); not XLA's "
                "cost_analysis")


def product_flops(fn, *args, **kwargs) -> int:
    """Floating-point operations of the products that one call of `fn` runs:
    matrix products, convolutions and attention, forward and any backward run
    inside the call (`torch.utils.flop_counter.FlopCounterMode`). Elementwise
    work, normalisation and reductions are not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())
