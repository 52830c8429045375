"""Analytic targets for the DREAM-zs slice (BASELINE config 3).

Counterpart of ``bipymc_tpu/models/targets.py``. A target here is a
**batched** callable, ``log_prob(x[n, d]) -> [n]``: the JAX package
writes a per-row density and maps it over chains with ``vmap``; the
batch dimension written out is the PyTorch form of that map.
"""

import numpy as np
import torch

from bipymc_tpu_torch.utils.init import var_ball


def baseline_config3_means(d=100, n_modes=4, spread=5.0, seed=1234):
    """Mode centres of BASELINE config 3: the JAX package's NumPy draw,
    copied so the port needs nothing of that package."""
    rng = np.random.default_rng(seed)
    return (spread * rng.standard_normal((n_modes, d))).astype(np.float32)


def stratified_mode_init(gen, means, n, var=4.0, dtype=torch.float32,
                         device="cuda"):
    """Start points spread over all modes: chain ``i`` starts in a
    ``var_ball`` of per-dimension variance ``var`` around mode ``i % k``.
    means: [k, d]. Returns [n, d] on ``device``."""
    means = torch.as_tensor(np.asarray(means), dtype=dtype, device=device)
    k, d = means.shape
    centers = means[torch.arange(n, device=device) % k]
    noise = var_ball(gen, torch.full((d,), var, dtype=dtype), n,
                     dtype=dtype, device=device)
    return centers + noise


def gaussian_mixture(means, sigma=1.0, weights=None):
    """Isotropic Gaussian mixture in d dims (BASELINE config 3 posterior).

    means: [k, d] centres (NumPy); sigma: shared std; weights: [k].
    Returns a batched ``log_prob(x[n, d]) -> [n]`` with the JAX package's
    ``log_w`` and ``norm`` constants and its term order, summed over modes
    by ``logsumexp``. The constants move to a device once per
    (device, dtype) and are then reused.
    """
    means = np.asarray(means)
    if not np.issubdtype(means.dtype, np.floating):
        means = means.astype(np.float32)
    k, d = means.shape
    if weights is None:
        log_w = np.full((k,), -np.log(k), dtype=means.dtype)
    else:
        w = np.asarray(weights)
        log_w = np.log(w / np.sum(w))
    norm = -0.5 * d * float(np.log(2.0 * np.pi * sigma ** 2))
    consts = {}

    def log_prob(x):
        key = (x.device, x.dtype)
        if key not in consts:
            consts[key] = (torch.as_tensor(means, dtype=x.dtype,
                                           device=x.device),
                           torch.as_tensor(log_w, dtype=x.dtype,
                                           device=x.device))
        mu, lw = consts[key]
        sq = torch.sum((x[:, None, :] - mu) ** 2, dim=-1)         # [n, k]
        return torch.logsumexp(lw + norm - 0.5 * sq / sigma ** 2, dim=-1)

    return log_prob
