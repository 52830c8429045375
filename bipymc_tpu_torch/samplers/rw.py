"""Random-walk sampler family: MH → AM → DR → DRAM, one batched step.

Counterpart of ``bipymc_tpu/samplers/rw.py``. DRAM is the general case
and MH / AM / DR are restrictions of its config, so the family is ONE
step over a batch of chains, each chain with its own adaptation state:

- Metropolis: Gaussian random walk y₁ = θ + L z₁.
- Haario AM: Welford mean / scatter every step, the Cholesky of
  ``sd·(scatter/(n−1) + ε I)`` refreshed every ``adapt_interval`` steps
  from step ``t0`` on, or with ``adapt_interval=1`` the O(d²) rank-1
  update of the scatter's factor every step.
- Green–Mira DR: a second stage y₂ = θ + (L/√κ) z₂ on a stage-1
  rejection, its q₁ ratio in whitened coordinates (the residuals are the
  draws themselves: no triangular solves), with ``core/numerics.log1mexp``.

The step takes its randomness as an argument: one ``[n, 2d+2]`` block of
int32 words a step, laid out per chain ``[z1(d) | z2(d) | u1 | u2]`` as
the JAX package's ``_default_draws``. ``draws_fn`` overrides the word →
number conversion, so tests can hand both packages the same z and u. The
step counter ``t`` is a host int, so the AM refresh gate is decided on the
host. The acceptance is ``ops/fused_rw_chunk.rw_select``, shared with the
plain version of kernel B4, and the proposal prep is :func:`proposals`,
shared with the fused engine (``samplers/rw_fused.py``).
"""

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from bipymc_tpu_torch.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu_torch.ops.fused_rw_chunk import rw_select
from bipymc_tpu_torch.ops.linalg import chol_rank1_update


class RwConfig(NamedTuple):
    """Static configuration; the JAX package's fields and defaults.

    adapt: Haario AM on/off. delayed: the DR second stage on/off.
    t0: first step whose refresh may use the adapted covariance.
    adapt_interval: Cholesky refresh period; 1 switches to the rank-1
    update, and ``m2`` then carries chol(scatter + ε I). eps: the ε
    regularisation. kappa: C₂ = C₁/κ. sd: proposal scale, None → 2.38²/d.
    """

    adapt: bool = False
    delayed: bool = False
    t0: int = 200
    adapt_interval: int = 50
    eps: float = 1e-8
    kappa: float = 5.0
    sd: float | None = None


class RwState(NamedTuple):
    theta: torch.Tensor      # [n, d] current positions
    logp: torch.Tensor       # [n]
    mean: torch.Tensor       # [n, d] running mean of visited states (AM)
    m2: torch.Tensor         # [n, d, d] running scatter (AM)
    count: int               # states folded into mean / m2 (every chain)
    chol: torch.Tensor       # [n, d, d] stage-1 proposal Cholesky


class RwInfo(NamedTuple):
    accepted: torch.Tensor   # [n] bool
    stage: torch.Tensor      # [n] int32: 0 reject, 1 stage 1, 2 stage 2
    logp: torch.Tensor       # [n]


def n_words(d: int) -> int:
    """Random words per chain per step."""
    return 2 * d + 2


def proposal_scale(cfg: RwConfig, d: int) -> float:
    return cfg.sd if cfg.sd is not None else 2.38 ** 2 / d


def inv_sqrt_kappa(cfg: RwConfig) -> float:
    """1/√κ rounded as the JAX package rounds it, in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(cfg.kappa)))


def init(theta0: torch.Tensor, log_prob: Callable,
         cov0: torch.Tensor) -> RwState:
    """theta0 [n, d]; cov0 [d, d] or [d] (diagonal), the stage-1
    proposal covariance of every chain."""
    n, d = theta0.shape
    cov0 = torch.as_tensor(cov0, dtype=theta0.dtype, device=theta0.device)
    if cov0.dim() == 1:
        cov0 = torch.diag(cov0)
    chol = torch.linalg.cholesky(cov0).expand(n, d, d).contiguous()
    return RwState(theta=theta0, logp=log_prob(theta0), mean=theta0.clone(),
                   m2=torch.zeros((n, d, d), dtype=theta0.dtype,
                                  device=theta0.device),
                   count=1, chol=chol)


def default_draws(words, ts, d, dtype):
    """Words [K, n, 2d+2] → (z1 [K, n, d], z2 [K, n, d], u1 [K, n],
    u2 [K, n]); ``ts`` (the K global steps) is unused here and lets an
    override key its draws by step."""
    u = bits_to_uniform(words, dtype)
    return (uniform_to_normal(u[..., 0:d]),
            uniform_to_normal(u[..., d:2 * d]),
            u[..., 2 * d], u[..., 2 * d + 1])


def proposals(cfg: RwConfig, chol, z1, z2):
    """The displacements and whitened norms of K steps against one factor:
    chol [n, d, d], z1 / z2 [K, n, d] → (dy1 = L z₁, dy2 = (1/√κ)(L z₂),
    ‖z₁‖², ‖z₁ − z₂/√κ‖²); the last three are None without DR."""
    dy1 = torch.einsum("nij,knj->kni", chol, z1)
    if not cfg.delayed:
        return dy1, None, None, None
    isk = inv_sqrt_kappa(cfg)
    dy2 = isk * torch.einsum("nij,knj->kni", chol, z2)
    w = z1 - isk * z2
    return dy1, dy2, torch.sum(z1 * z1, -1), torch.sum(w * w, -1)


def welford(mean, m2, count, x):
    """Fold positions x [n, d] into every chain's (mean, scatter, count)."""
    n = count + 1
    delta = x - mean
    mean_new = mean + delta / float(n)
    delta2 = x - mean_new
    return mean_new, m2 + delta[:, :, None] * delta2[:, None, :], n


def refresh(cfg: RwConfig, sd, m2, count, chol):
    """The AM Cholesky refresh; a chain whose adapted covariance is not
    (yet) SPD keeps its old factor."""
    d = m2.shape[-1]
    eye = torch.eye(d, dtype=m2.dtype, device=m2.device)
    cov = sd * (m2 / float(count - 1) + cfg.eps * eye)
    # jnp.linalg.cholesky factors the symmetrised input (a + aᴴ)/2
    cov = (cov + cov.transpose(-1, -2)) / 2
    c, info = torch.linalg.cholesky_ex(cov)
    ok = (info == 0) & torch.all(torch.isfinite(c), dim=(-2, -1))
    return torch.where(ok[:, None, None], c, chol)


def adapt_update(cfg: RwConfig, sd, mean, m2, count, chol, theta_new, t):
    """Haario AM update of (mean, m2, count, chol) after step ``t``;
    identity when ``cfg.adapt`` is off."""
    if not cfg.adapt:
        return mean, m2, count, chol
    if cfg.adapt_interval == 1:
        n = count + 1
        delta = theta_new - mean
        mean_new = mean + delta / float(n)
        d = theta_new.shape[-1]
        if count == 1:      # the scatter starts at ε·I
            m2 = math.sqrt(float(np.float32(cfg.eps))) * torch.eye(
                d, dtype=mean.dtype, device=mean.device).expand_as(m2)
        alpha = float(np.float32(n - 1) / np.float32(n))
        m2_new = chol_rank1_update(m2, delta, alpha)
        if t >= cfg.t0:
            scale = float(np.sqrt(np.float32(sd) / np.float32(n - 1)))
            chol = scale * m2_new
        return mean_new, m2_new, n, chol
    mean_new, m2_new, n = welford(mean, m2, count, theta_new)
    if t >= cfg.t0 and (t + 1) % cfg.adapt_interval == 0:
        chol = refresh(cfg, sd, m2_new, n, chol)
    return mean_new, m2_new, n, chol


def make_step(log_prob: Callable, cfg: RwConfig,
              draws_fn: Callable | None = None) -> Callable:
    """Build ``step(state, words, t) -> (state, info)`` for a batch of
    chains. log_prob: batched target, [n, d] → [n]. words: the step's
    [n, 2d+2] int32 block (None when ``draws_fn`` ignores it).
    draws_fn: ``(words [1, n, 2d+2], ts, d, dtype) -> (z1, z2, u1, u2)``
    with a leading axis of one step, as :func:`default_draws`.
    """
    draws = draws_fn or default_draws

    def step(state: RwState, words, t: int):
        theta = state.theta
        d = theta.shape[-1]
        sd = proposal_scale(cfg, d)
        z1, z2, uu1, uu2 = draws(None if words is None else words[None],
                                 [t], d, theta.dtype)
        dy1, dy2, sz1, sw = proposals(cfg, state.chol, z1, z2)
        y1 = theta + dy1[0]
        l1 = log_prob(y1)
        if cfg.delayed:
            y2 = theta + dy2[0]
            theta_new, logp_new, acc, stage = rw_select(
                theta, state.logp, y1, l1, torch.log(uu1[0]), y2,
                log_prob(y2), torch.log(uu2[0]), sz1[0], sw[0])
        else:
            theta_new, logp_new, acc, stage = rw_select(
                theta, state.logp, y1, l1, torch.log(uu1[0]))
        mean, m2, count, chol = adapt_update(
            cfg, sd, state.mean, state.m2, state.count, state.chol,
            theta_new, t)
        return (RwState(theta_new, logp_new, mean, m2, count, chol),
                RwInfo(accepted=acc, stage=stage, logp=logp_new))

    return step


# Named configs matching the reference sampler zoo ---------------------------

def metropolis_config(**kw) -> RwConfig:
    return RwConfig(adapt=False, delayed=False, **kw)


def adaptive_metropolis_config(**kw) -> RwConfig:
    return RwConfig(adapt=True, delayed=False, **kw)


def dr_metropolis_config(**kw) -> RwConfig:
    return RwConfig(adapt=False, delayed=True, **kw)


def dram_config(**kw) -> RwConfig:
    return RwConfig(adapt=True, delayed=True, **kw)
