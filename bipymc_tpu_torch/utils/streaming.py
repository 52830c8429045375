"""Streaming Gelman-Rubin for R̂-based early stopping.

Counterpart of ``bipymc_tpu/utils/streaming.py`` on one device:
per-chain Welford moments (count, mean, M2 per dimension) stay on the
device and fold in one population snapshot per generation; R̂ is
computed from them once per chunk. ``n`` is a host float: every chain
folds the same number of snapshots. ``rhat_update_block`` folds a fused
chunk's whole history; ``rhat_merge`` joins the fused chunks' moments to
the per-generation engine's (``ChainPool.run_until``).
"""

from typing import NamedTuple

import numpy as np
import torch


class RhatCarry(NamedTuple):
    n: float              # snapshots folded in per chain
    mean: torch.Tensor    # [n_chains, d] per-chain running mean
    m2: torch.Tensor      # [n_chains, d] per-chain running Σ(x−μ)²


def rhat_init(n_chains, d, dtype=torch.float32, device="cuda") -> RhatCarry:
    zeros = torch.zeros((n_chains, d), dtype=dtype, device=device)
    return RhatCarry(n=0.0, mean=zeros, m2=zeros.clone())


def rhat_update(carry: RhatCarry, x: torch.Tensor) -> RhatCarry:
    """Fold one population snapshot x [n_chains, d] into the moments."""
    n = carry.n + 1.0
    delta = x - carry.mean
    mean = carry.mean + delta / n
    m2 = carry.m2 + delta * (x - mean)
    return RhatCarry(n=n, mean=mean, m2=m2)


def rhat_update_block(carry: RhatCarry, xs: torch.Tensor) -> RhatCarry:
    """Fold a block xs [T, n_chains, d] into the moments at once (Chan et
    al. pairwise merge; equal to T :func:`rhat_update` calls up to float
    re-association). The fused chunks fold their history with it. The
    count fractions are rounded in float32, as the JAX package's are."""
    t = float(xs.shape[0])
    bmean = torch.mean(xs, dim=0)
    bm2 = torch.sum((xs - bmean[None]) ** 2, dim=0)
    n = carry.n + t
    delta = bmean - carry.mean
    # carry.n == 0 (a fresh window) reduces to the block's own moments
    frac = float(np.float32(t) / np.float32(n))
    wgt = float(np.float32(carry.n) * np.float32(t) / np.float32(n))
    mean = carry.mean + delta * frac
    m2 = carry.m2 + bm2 + delta ** 2 * wgt
    return RhatCarry(n=n, mean=mean, m2=m2)


def rhat_merge(a: RhatCarry, b: RhatCarry) -> RhatCarry:
    """Merge two moment carries (Chan et al. pairwise combine): equal to
    folding b's snapshots into a, up to float re-association. The count
    fractions are rounded in float32, as the JAX package's are."""
    n = a.n + b.n
    delta = b.mean - a.mean
    frac = (float(np.float32(b.n) / np.float32(max(n, 1.0))) if n > 0
            else 0.0)
    wgt = float(np.float32(a.n) * np.float32(frac))
    mean = a.mean + delta * frac
    m2 = a.m2 + b.m2 + delta ** 2 * wgt
    return RhatCarry(n=n, mean=mean, m2=m2)


def rhat_compute(carry: RhatCarry, n_chains: int) -> torch.Tensor:
    """Classic (non-split) R̂ per dimension [d] from the moments."""
    n = max(carry.n, 2.0)
    m = float(n_chains)
    w = torch.sum(carry.m2, dim=0) / (m * (n - 1.0))
    gmean = torch.sum(carry.mean, dim=0) / m
    b_over_n = torch.sum((carry.mean - gmean) ** 2, dim=0) / (m - 1.0)
    v_hat = (n - 1.0) / n * w + b_over_n
    return torch.sqrt(v_hat / torch.clamp_min(w, 1e-30))
