"""Linear-algebra utilities for the adaptive random walk.

Counterpart of ``bipymc_tpu/ops/linalg.py``, in plain torch and batched
over a leading chain axis: the O(d²) rank-1 Cholesky update that
``adapt_interval=1`` uses in place of a refactorisation, and the solve
against a Cholesky factor.
"""

import math

import torch


def chol_rank1_update(L: torch.Tensor, x: torch.Tensor,
                      alpha=1.0) -> torch.Tensor:
    """chol(L Lᵀ + α x xᵀ) for α > 0, per chain: L [n, d, d], x [n, d].

    The JAX package's column sweep (Golub & Van Loan §6.5.4 form), op for
    op, with only rows ≥ k of column k and of x changed at step k.
    """
    d = L.shape[-1]
    x = math.sqrt(float(alpha)) * x
    L = L.clone()
    rows = torch.arange(d, device=L.device)
    for k in range(d):
        lkk = L[:, k, k][:, None]
        xk = x[:, k][:, None]
        r = torch.sqrt(lkk * lkk + xk * xk)
        c = r / lkk
        s = xk / lkk
        col = L[:, :, k]
        new_col = (col + s * x) / c
        new_x = c * x - s * new_col
        below = rows >= k
        L[:, :, k] = torch.where(below, new_col, col)
        x = torch.where(below, new_x, x)
    return L


def solve_chol(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = b given lower Cholesky L (two triangular solves)."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
