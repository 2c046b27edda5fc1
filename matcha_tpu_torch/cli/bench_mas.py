"""MAS benchmark: the fused CUDA kernel against the plain version and the C++ CPU MAS.

    python -m matcha_tpu_torch.cli.bench_mas [--device cuda|cpu]

The port of `matcha_tpu/cli/bench_mas.py`, on the CUDA card unless `--device`
says otherwise. At the reference's benchmark shapes it asserts that the paths
agree bit for bit, then times each over RUNS calls. On the card: the fused
MAS kernel through `ops/mas.py`'s wrapper (`kernel_ms`), the plain PyTorch
version on the card (`plain_ms`), both timed with CUDA events around the runs,
and the C++/OpenMP CPU MAS (`cpp_ms`, host clock). On the CPU: the plain
version against the C++ MAS.
"""

import argparse
import time

import numpy as np

# the reference's shapes (`test_monotonic_align_speed.py:126-130`)
SHAPES = [(8, 50, 200), (16, 100, 500), (32, 150, 800)]
RUNS = 20


def make_problem(b, tx, ty, seed=0):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((b, tx, ty)).astype(np.float32)
    t_x = rng.integers(max(tx // 2, 1), tx + 1, size=b)
    t_y = np.maximum(rng.integers(max(ty // 2, 1), ty + 1, size=b), t_x)
    x_mask = (np.arange(tx)[None] < t_x[:, None]).astype(np.float32)
    y_mask = (np.arange(ty)[None] < t_y[:, None]).astype(np.float32)
    return value, x_mask[:, :, None] * y_mask[:, None, :]


def host_ms(fn):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(RUNS):
        fn()
    return (time.perf_counter() - t0) / RUNS * 1e3


def device_ms(fn):
    """ms a call of RUNS calls between two CUDA events (one sync, after the last)."""
    import torch

    fn()  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RUNS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / RUNS


def main(argv=None):
    ap = argparse.ArgumentParser(description="MAS benchmark (PyTorch/CUDA port)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' times the plain "
                         "version against the C++ MAS)")
    args = ap.parse_args(argv)

    import torch

    from matcha_tpu_torch import resolve_device
    from matcha_tpu_torch.ops import mas
    from matcha_tpu_torch.ops.mas_cpp import maximum_path_cpp

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device: {name}, {RUNS} runs per shape")
    if on_card:
        print(f"{'shape':>18} {'kernel_ms':>10} {'plain_ms':>10} {'cpp_ms':>10} "
              f"{'kernel_vs_cpp':>14}")
    else:
        print(f"{'shape':>18} {'plain_ms':>10} {'cpp_ms':>10} {'plain_vs_cpp':>14}")
    for b, tx, ty in SHAPES:
        value, mask = make_problem(b, tx, ty)
        tv, tm = torch.from_numpy(value).to(device), torch.from_numpy(mask).to(device)
        t_x, t_y = mas.lengths_from_mask(tm)

        c = maximum_path_cpp(value, mask)
        r = mas.maximum_path_plain(tv, tm, t_x, t_y).cpu().numpy()
        np.testing.assert_array_equal(r, c)
        t_cpp = host_ms(lambda: maximum_path_cpp(value, mask))
        if on_card:
            p = mas.maximum_path(tv, tm, t_x, t_y).cpu().numpy()
            np.testing.assert_array_equal(p, c)
            t_ker = device_ms(lambda: mas.maximum_path(tv, tm, t_x, t_y))
            t_plain = device_ms(lambda: mas.maximum_path_plain(tv, tm, t_x, t_y))
            print(f"{(b, tx, ty)!s:>18} {t_ker:>10.4f} {t_plain:>10.4f} {t_cpp:>10.4f} "
                  f"{t_cpp / t_ker:>13.2f}x")
        else:
            t_plain = host_ms(lambda: mas.maximum_path_plain(tv, tm, t_x, t_y))
            print(f"{(b, tx, ty)!s:>18} {t_plain:>10.4f} {t_cpp:>10.4f} "
                  f"{t_cpp / t_plain:>13.2f}x")


if __name__ == "__main__":
    main()
