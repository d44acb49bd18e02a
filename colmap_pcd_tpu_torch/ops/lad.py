"""Least absolute deviations (L1) fitting by ADMM.

Port of colmap_pcd_tpu/ops/lad.py (optim/least_absolute_deviations.{h,cc},
SolveLeastAbsoluteDeviations): min ||Ax - b||_1 by ADMM (Boyd et al.),
  x   <- (A^T A)^-1 A^T (b + z - u)
  z   <- shrink(A x_hat - b + u, 1/rho)
  u   <- u + A x_hat - b - z
with over-relaxation x_hat = alpha*Ax + (1-alpha)*(z_old + b), over one
dense Cholesky factor of A^T A.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import device as device_mod

Tensor = torch.Tensor


class LADOptions(NamedTuple):
    rho: float = 1.0            # augmented Lagrangian parameter
    alpha: float = 1.0          # over-relaxation (1.0 .. 1.8)
    max_num_iterations: int = 1000
    absolute_tolerance: float = 1e-4
    relative_tolerance: float = 1e-2


def _shrinkage(v: Tensor, kappa: float) -> Tensor:
    return torch.clamp(v - kappa, min=0.0) - torch.clamp(-v - kappa, min=0.0)


def solve_least_absolute_deviations(
    A, b, x0=None, opts: LADOptions = LADOptions(), device=None
) -> Tensor:
    """min_x ||Ax - b||_1 for dense A [M,N] (M >= N, full column rank), on
    A's device when A is a tensor, else on `device` (None: CUDA)."""
    dev = A.device if torch.is_tensor(A) else device_mod.resolve(device)
    A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    M, N = A.shape
    x = torch.zeros(N, device=dev) if x0 is None else torch.as_tensor(x0, dtype=torch.float32, device=dev)

    L = torch.linalg.cholesky(A.T @ A + 1e-9 * torch.eye(N, device=dev))

    def x_update(rhs):
        y = torch.linalg.solve_triangular(L, (A.T @ rhs)[:, None], upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]

    sqrt_m = float(M) ** 0.5
    z = torch.zeros(M, device=dev)
    u = torch.zeros(M, device=dev)
    # The system is small (3m x 12 in model_aligner), so the stop test is
    # read on the host every iteration: one sync per step, at most
    # max_num_iterations.
    for _ in range(opts.max_num_iterations):
        x = x_update(b + z - u)
        Ax = A @ x
        Ax_hat = opts.alpha * Ax + (1.0 - opts.alpha) * (z + b)
        z_old = z
        z = _shrinkage(Ax_hat - b + u, 1.0 / opts.rho)
        u = u + Ax_hat - b - z
        r_norm = torch.linalg.norm(Ax - z - b)
        s_norm = torch.linalg.norm(-opts.rho * A.T @ (z - z_old))
        eps_pri = sqrt_m * opts.absolute_tolerance + opts.relative_tolerance * torch.maximum(
            torch.linalg.norm(Ax), torch.maximum(torch.linalg.norm(-z), torch.linalg.norm(b))
        )
        eps_dual = sqrt_m * opts.absolute_tolerance + opts.relative_tolerance * torch.linalg.norm(
            opts.rho * A.T @ u
        )
        if bool((r_norm < eps_pri) & (s_norm < eps_dual)):
            break
    return x
