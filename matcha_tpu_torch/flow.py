"""Conditional flow matching: fixed-step ODE samplers for inference.

z ~ N(0, 1) * temperature, then n estimator evaluations over
t-span = linspace(0, 1, n + 1). Time values stay float32 whatever the
activation dtype: bf16 time (~1/256 steps) would corrupt the scale-1000
sinusoidal time embedding.
"""

from typing import Callable, Optional

import torch


def _t_span(n_timesteps: int, device) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, n_timesteps + 1, dtype=torch.float32, device=device)


def solve_euler(estimator: Callable, x, mask, mu, n_timesteps: int):
    """x <- x + dt * v(x, t | mu), n steps."""
    t_span = _t_span(n_timesteps, x.device)
    dts = torch.diff(t_span)
    for i in range(n_timesteps):
        t = t_span[i].expand(x.shape[0])
        v = estimator(x, mask, mu, t)
        x = (x + dts[i].to(x.dtype) * v).to(x.dtype)
    return x


def solve_midpoint(estimator: Callable, x, mask, mu, n_timesteps: int):
    """Explicit midpoint (RK2): two estimator calls per step."""
    t_span = _t_span(n_timesteps, x.device)
    dts = torch.diff(t_span)
    for i in range(n_timesteps):
        t, dt = t_span[i], dts[i]
        dt_x = dt.to(x.dtype)
        v1 = estimator(x, mask, mu, t.expand(x.shape[0]))
        xm = (x + 0.5 * dt_x * v1).to(x.dtype)
        v2 = estimator(xm, mask, mu, (t + 0.5 * dt).expand(x.shape[0]))
        x = (x + dt_x * v2).to(x.dtype)
    return x


SOLVERS = {"euler": solve_euler, "midpoint": solve_midpoint}


def sample_cfm(estimator: Callable, mu: torch.Tensor, mask: torch.Tensor,
               n_timesteps: int, temperature: float = 1.0, solver: str = "euler",
               z: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """Generate from noise given the aligned condition `mu` (any layout).

    `z` injects the pre-temperature standard-normal noise (shape of `mu`);
    otherwise it is drawn from `generator`.
    """
    if z is None:
        z = torch.randn(mu.shape, generator=generator, device=mu.device,
                        dtype=torch.float32)
    z = z * temperature
    return SOLVERS[solver](estimator, z.to(mu.dtype), mask, mu, n_timesteps)
