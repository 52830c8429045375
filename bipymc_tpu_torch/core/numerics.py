"""Shared scalar numerics used by more than one engine.

Counterpart of ``bipymc_tpu/core/numerics.py``. The per-step and fused
random-walk engines evaluate the Green–Mira acceptance with this one
:func:`log1mexp`, so a numerical change reaches both at once; the CUDA
kernel ``csrc/fused_rw_chunk.cu`` repeats the same formula in device
code (same series, same branch point, no ``expm1``).
"""

import torch

# p(x) = (e^x - 1)/x - 1 = Σ_{k>=1} x^k/(k+1)!, Horner coefficients
# through x^10/11!, as in the JAX package
_EXPM1_COEFS = tuple(
    1.0 / f for f in (
        2.0, 6.0, 24.0, 120.0, 720.0, 5040.0, 40320.0,
        362880.0, 3628800.0, 39916800.0))


def log1mexp(log_a: torch.Tensor) -> torch.Tensor:
    """log(1 − exp(log_a)) for log_a ≤ 0, numerically stable.

    Mächler (2012)'s two branches, with the near-zero branch's
    ``log(−expm1(x))`` written as ``log(−x) + log1p(p(x))`` through the
    Taylor series of (e^x − 1)/x; branch point −0.2. NaN propagates.
    """
    x = torch.clamp_max(log_a, -1e-30)
    p = torch.zeros_like(x)
    for c in reversed(_EXPM1_COEFS):
        p = x * (c + p)
    series = torch.log(-x) + torch.log1p(p)
    direct = torch.log1p(-torch.exp(x))
    return torch.where(x > -0.2, series, direct)
