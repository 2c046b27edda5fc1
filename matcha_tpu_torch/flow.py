"""Conditional flow matching: the training loss and fixed-step ODE samplers.

Training (`cfm_loss`): t ~ U[0, 1] per sample, phi_t = (1 - (1 - sigma_min) t) z
+ t x1, target u = x1 - (1 - sigma_min) z, MSE masked inside the sum (as the JAX
package does) over sum(mask) * n_feats. Inference: z ~ N(0, 1) * temperature,
then n estimator evaluations over
t-span = linspace(0, 1, n + 1). Time values stay float32 whatever the
activation dtype: bf16 time (~1/256 steps) would corrupt the scale-1000
sinusoidal time embedding.
"""

from typing import Callable, Optional

import torch

SIGMA_MIN = 1e-4


def cfm_loss(estimator: Callable, x1: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor,
             sigma_min: float = SIGMA_MIN, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
    """Conditional flow-matching loss, (B, T, C) layout as the JAX package's.

    estimator: (x, mask, mu, t) -> velocity with x, mu (B, T, C), mask (B, T, 1)
    and t (B,). `t` (B,) and `z` (shape of x1) are injected, or drawn from
    `generator`: t first, then z. Returns (loss, phi_t).
    """
    b = x1.shape[0]
    if t is None:
        t = torch.rand((b,), generator=generator, device=x1.device, dtype=x1.dtype)
    if z is None:
        z = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
    t = t.to(device=x1.device, dtype=x1.dtype).reshape(b, 1, 1)
    phi_t = (1 - (1 - sigma_min) * t) * z + t * x1
    u_target = x1 - (1 - sigma_min) * z
    u_pred = estimator(phi_t, mask, mu, t[:, 0, 0])
    loss = torch.sum((u_pred - u_target) ** 2 * mask) / (torch.sum(mask) * x1.shape[-1])
    return loss, phi_t


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
