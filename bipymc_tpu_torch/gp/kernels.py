"""GP covariance kernels.

Counterpart of ``bipymc_tpu/gp/kernels.py``: pure functions
``k(params, X, X2) -> K`` over one pairwise-squared-distance primitive,
:func:`bipymc_tpu_torch.ops.pallas_kernels.pairwise_sqdist` (kernel B5
on the card). The scaling by the length-scales, the ``exp`` and σ_f² are
torch glue, as they are XLA glue around the reference's Pallas kernel.

``params`` is a dict of tensors, ``log_lengthscale`` [..., d] and
``log_sigma_f`` [...]. A leading chain axis on the params (e.g.
``log_lengthscale`` [C, d], ``log_sigma_f`` [C]) gives one Gram matrix
per chain, [C, n, m]: the port's form of the reference's ``vmap`` over
chains. X and X2 are [n, d] (shared by the chains) or [..., n, d].
"""

import math

import torch

from bipymc_tpu_torch.ops.pallas_kernels import pairwise_sqdist


def _scaled(params, X, X2):
    ls = torch.exp(params["log_lengthscale"])[..., None, :]
    Xs = X / ls
    return Xs, (Xs if X2 is None else X2 / ls)


def _sf2(params):
    return torch.exp(2.0 * params["log_sigma_f"])[..., None, None]


def _stationary_diag(params, X):
    """k(x, x) = σ_f² for stationary kernels, [..., n]: attached as
    ``kernel.diag`` so the predictive variance uses the true prior
    diagonal."""
    sf2 = torch.exp(2.0 * params["log_sigma_f"])[..., None]
    return torch.ones(X.shape[-2], dtype=X.dtype, device=X.device) * sf2


def squared_exp(params, X, X2=None):
    """SE-ARD: k(x, x′) = σ_f² exp(−½ Σ_d (x_d − x′_d)²/ℓ_d²)."""
    Xs, X2s = _scaled(params, X, X2)
    return _sf2(params) * torch.exp(-0.5 * pairwise_sqdist(Xs, X2s))


def matern32(params, X, X2=None):
    """Matérn-3/2 with ARD length-scales."""
    Xs, X2s = _scaled(params, X, X2)
    r = torch.sqrt(torch.clamp_min(pairwise_sqdist(Xs, X2s), 1e-30))
    a = math.sqrt(3.0) * r
    return _sf2(params) * (1.0 + a) * torch.exp(-a)


def matern52(params, X, X2=None):
    """Matérn-5/2 with ARD length-scales."""
    Xs, X2s = _scaled(params, X, X2)
    r2 = torch.clamp_min(pairwise_sqdist(Xs, X2s), 1e-30)
    a = torch.sqrt(5.0 * r2)
    return _sf2(params) * (1.0 + a + 5.0 * r2 / 3.0) * torch.exp(-a)


squared_exp.diag = _stationary_diag
matern32.diag = _stationary_diag
matern52.diag = _stationary_diag
