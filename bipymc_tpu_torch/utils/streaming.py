"""Streaming Gelman-Rubin for R̂-based early stopping.

Counterpart of ``bipymc_tpu/utils/streaming.py`` on one device:
per-chain Welford moments (count, mean, M2 per dimension) stay on the
device and fold in one population snapshot per generation; R̂ is
computed from them once per chunk. ``n`` is a host float: every chain
folds the same number of snapshots. The block fold and the merge
(``rhat_update_block``, ``rhat_merge``) come with the fused engine.
"""

from typing import NamedTuple

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


def rhat_compute(carry: RhatCarry, n_chains: int) -> torch.Tensor:
    """Classic (non-split) R̂ per dimension [d] from the moments."""
    n = max(carry.n, 2.0)
    m = float(n_chains)
    w = torch.sum(carry.m2, dim=0) / (m * (n - 1.0))
    gmean = torch.sum(carry.mean, dim=0) / m
    b_over_n = torch.sum((carry.mean - gmean) ** 2, dim=0) / (m - 1.0)
    v_hat = (n - 1.0) / n * w + b_over_n
    return torch.sqrt(v_hat / torch.clamp_min(w, 1e-30))
