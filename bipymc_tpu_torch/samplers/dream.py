"""DE-MC-z and DREAM-zs on the per-generation engine.

Counterpart of ``bipymc_tpu/samplers/dream.py`` on one device. A
generation is one step over the population: archive difference vectors,
snooker moves with their Jacobian, crossover subspace sampling with
burn-in adaptation of the CR probabilities, the burn-in IQR outlier
reset, γ = 1 jump generations, and the thinned archive append.

The step takes the generation's random words as an argument, laid out
per chain as in the JAX package: ``[u_scal(3) | u_cr | u_acc |
row_bits(n_rows) | u_ue(2d) | eps(d)]``. Production draws them from a
generator (``parallel/pool.py``); the tests feed the JAX package's words,
so both packages run the same generation.

The generation counter is a host int, so the schedule (jump, burn-in,
outlier check, archive append) is decided on the host and no generation
reads a device scalar. The kernels of the step, B3 (row indices), B2
(proposal), B11 (the archive rows, with ``gather_kernel=True``) and B10
(the accept and state update, with ``pallas_accept=True``), go through
their dispatchers: on the card they launch the CUDA kernels, on
the CPU they run the plain versions. The
fused engine (``samplers/dream_fused.py``) runs the same generation,
``archive_thin`` at a time after burn-in.
"""

from typing import Callable, NamedTuple

import torch

from bipymc_tpu_torch.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu_torch.ensemble.archive import (
    Archive, archive_append, archive_init)
from bipymc_tpu_torch.ops.accept_select import (
    accept_select, accept_select_reference)
from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
from bipymc_tpu_torch.ops.dream_proposal import dream_propose
from bipymc_tpu_torch.ops.gather_rows import gather_rows

_MESH_ITEM = "ROADMAP Queue A item 15 (multi-GPU)"


class DreamConfig(NamedTuple):
    """Static configuration; the JAX package's fields and defaults
    (Vrugt et al. 2011). Use :func:`demcz_config` for DE-MC-z."""

    n_chains: int
    delta_max: int = 3          # multi-pair differences, δ ~ U{1..δ_max}
    n_cr: int = 3               # crossover values CR_m = m/n_cr
    p_snooker: float = 0.1
    b: float = 1e-4             # e_j ~ U(−b, b), multiplicative (1+e)
    b_star: float = 1e-6        # ε_j ~ N(0, b*²) additive jitter
    jump_interval: int = 5      # γ := 1 every 5th generation
    archive_thin: int = 10      # append population to Z every K gens
    adapt_cr: bool = True       # CR probability adaptation (burn-in)
    outlier_detect: bool = True # IQR outlier-chain reset (burn-in)
    outlier_interval: int = 10
    burnin_gens: int = 500      # adaptation window; frozen afterwards
    snooker_lo: float = 1.2     # γ_s ~ U(lo, hi)
    snooker_hi: float = 2.2
    use_archive: bool = True    # False → population-DREAM (Vrugt 2009)
    pallas_proposal: bool | None = None  # kept for parity with the JAX
                                         # config: B2/B3 run as kernels on
                                         # CUDA and as their plain versions
                                         # on the CPU; False on CUDA raises.
    pallas_accept: bool = False  # the accept and state update through
                                 # kernel B10 (ops/accept_select.py)
                                 # instead of torch ops; bit-equal
    jump_full_cr: bool = False   # CR=1 on γ=1 jump generations
    shard_archive: bool = False  # mesh-only — not ported yet
    gather_kernel: bool = False  # the archive rows through kernel B11
                                 # (ops/gather_rows.py) instead of
                                 # torch indexing; the same rows


def demcz_config(n_chains: int, **kw) -> DreamConfig:
    """DE-MC-z (ter Braak & Vrugt 2008): single pair, full-dim crossover,
    no CR adaptation, γ-jump every 10th generation."""
    defaults = dict(delta_max=1, n_cr=1, adapt_cr=False,
                    outlier_detect=False, jump_interval=10)
    defaults.update(kw)
    return DreamConfig(n_chains=n_chains, **defaults)


def dream_config(n_chains: int, **kw) -> DreamConfig:
    """Population-DREAM (Vrugt et al. 2009): differences from the current
    population, CR adaptation, no snooker, no archive sampling."""
    defaults = dict(use_archive=False, p_snooker=0.0)
    defaults.update(kw)
    return DreamConfig(n_chains=n_chains, **defaults)


def check_config(cfg: DreamConfig, device=None) -> None:
    """Raise ``NotImplementedError`` for the field the port lacks
    (``shard_archive``), and ``ValueError`` for ``pallas_proposal=False``
    on a CUDA ``device`` and for ``gather_kernel=True`` without an
    archive. ``pallas_accept=True`` is taken (kernel B10)."""
    if (cfg.pallas_proposal is False and device is not None
            and torch.device(device).type == "cuda"):
        raise ValueError(
            "pallas_proposal=False asks for the per-op proposal path, "
            "which the card does not have: B2/B3 run as CUDA kernels")
    if cfg.shard_archive:
        raise NotImplementedError(
            f"shard_archive=True is mesh-only: {_MESH_ITEM}")
    if cfg.gather_kernel and not cfg.use_archive:
        # bipymc_tpu/samplers/dream.py:181-186
        raise ValueError(
            "gather_kernel=True routes the ARCHIVE row gather through "
            "the DMA kernel; this configuration samples the live "
            "population (use_archive=False), which has no capacity "
            "pathology to fix — drop gather_kernel")


class DreamState(NamedTuple):
    x: torch.Tensor          # [n, d] population
    logp: torch.Tensor       # [n]
    archive: Archive
    cr_p: torch.Tensor       # [n_cr] CR selection probabilities
    cr_cum: torch.Tensor     # [n_cr] normalised CDF of cr_p
    cr_jump: torch.Tensor    # [n_cr] accumulated normalised sq jumps Δ_m
    cr_count: torch.Tensor   # [n_cr] times CR_m was tried, L_m
    logp_sum: torch.Tensor   # [n] running Σ logp (outlier statistic)
    gen: int                 # generations taken


class DreamInfo(NamedTuple):
    accepted: torch.Tensor   # [n] bool
    snooker: torch.Tensor    # [n] bool — the proposal was a snooker move
    logp: torch.Tensor       # [n]


def n_rows(cfg: DreamConfig) -> int:
    """Archive rows drawn per chain: the parallel move needs 2·δ_max, the
    snooker move 3, and one draw serves both."""
    return max(2 * cfg.delta_max, 3)


def n_words(cfg: DreamConfig, d: int, kernel_rng: bool = False) -> int:
    """Random words per chain per generation: the scalars' 5 and the
    rows' n_rows, then the 3d of u_mask, u_e and eps, which kernel B1's
    kernel-RNG mode draws itself (``bipymc_tpu/samplers/dream_fused.py:
    277-278``)."""
    return 5 + n_rows(cfg) + (0 if kernel_rng else 3 * d)


def archive_init_checked(z0, capacity, cfg: DreamConfig) -> Archive:
    need = n_rows(cfg)
    if z0.shape[0] < need:
        raise ValueError(
            f"initial archive needs ≥ {need} rows for δ_max={cfg.delta_max}"
            f" / snooker draws; got {z0.shape[0]}")
    return archive_init(z0, capacity)


def init(x0: torch.Tensor, log_prob: Callable, cfg: DreamConfig,
         archive_capacity: int, z0: torch.Tensor) -> DreamState:
    """x0: [n, d] initial population; z0: [k, d] initial archive rows
    (k ≥ max(2·δ_max, 3)); log_prob is batched, [n, d] → [n]."""
    logp = log_prob(x0)
    cr_p = torch.full((cfg.n_cr,), 1.0 / cfg.n_cr, dtype=x0.dtype,
                      device=x0.device)
    zeros = torch.zeros((cfg.n_cr,), dtype=x0.dtype, device=x0.device)
    return DreamState(
        x=x0, logp=logp,
        archive=archive_init_checked(z0, archive_capacity, cfg),
        cr_p=cr_p, cr_cum=torch.cumsum(cr_p / torch.sum(cr_p), 0),
        cr_jump=zeros, cr_count=zeros.clone(),
        logp_sum=torch.zeros_like(logp), gen=0)


def make_step(log_prob: Callable, cfg: DreamConfig) -> Callable:
    """Build ``step(state, words, t) -> (state, info)``.

    log_prob: batched target, [n, d] → [n]. words: the generation's
    [n, n_words(cfg, d)] int32 word block. ``t`` is the global step
    index, kept for the JAX package's signature; the schedule follows
    ``state.gen``.
    """
    check_config(cfg)
    n_pairs = cfg.delta_max
    k_rows = n_rows(cfg)
    # kernel B10 or its plain version: the same exact ops, bit-equal
    accept = accept_select if cfg.pallas_accept else accept_select_reference

    def step(state: DreamState, words: torch.Tensor, t: int):
        x = state.x
        n, d = x.shape
        dtype, device = x.dtype, x.device
        if cfg.pallas_proposal is False:
            check_config(cfg, device)
        gen = state.gen
        gamma_jump = gen % cfg.jump_interval == cfg.jump_interval - 1
        in_burnin = gen < cfg.burnin_gens

        # one word→uniform pass over the whole block; slices are views
        u_all = bits_to_uniform(words, dtype)
        u_scal = u_all[:, 0:3]
        u_cr = u_all[:, 3]
        u_acc = u_all[:, 4]
        off_w = 5 + k_rows
        u_mask = u_all[:, off_w:off_w + d]
        u_e = u_all[:, off_w + d:off_w + 2 * d]
        eps_n = uniform_to_normal(u_all[:, off_w + 2 * d:])
        row_bits = words[:, 5:off_w]

        if cfg.use_archive:
            row_idx = distinct_idx(row_bits, k_rows, state.archive.fill)
            if cfg.gather_kernel:
                rows = gather_rows(state.archive.buf, row_idx)
            else:
                rows = state.archive.buf[row_idx]           # [n, k, d]
        else:
            # population-DREAM: rows from the generation-start population,
            # all distinct and ≠ the chain itself
            gid = torch.arange(n, dtype=torch.int32, device=device)
            row_idx = distinct_idx(row_bits, k_rows, cfg.n_chains,
                                   exclude=gid)
            rows = x[row_idx]
        # CR index by inverse CDF over the selection probabilities
        cr_idx = torch.clamp_max(
            torch.sum(u_cr[:, None] >= state.cr_cum[None, :], dim=1),
            cfg.n_cr - 1)

        # packed per-chain scalars (delta, cr, gamma_s, is_snk, gamma_jump)
        delta = torch.clamp_max(
            1.0 + torch.floor(u_scal[:, 1] * n_pairs), float(n_pairs))
        cr = (cr_idx + 1).to(dtype) / cfg.n_cr
        gamma_s = cfg.snooker_lo + \
            (cfg.snooker_hi - cfg.snooker_lo) * u_scal[:, 2]
        # u ∈ [0, 1), so p_snooker ≤ 0 gives no snooker move
        is_snk = u_scal[:, 0] < cfg.p_snooker
        gj = torch.full_like(delta, float(gamma_jump))
        if cfg.jump_full_cr and gamma_jump:
            cr = torch.ones_like(cr)
        scal = torch.stack([delta, cr, gamma_s, is_snk.to(dtype), gj], dim=1)
        x_star, log_jac = dream_propose(
            x, rows, u_mask, u_e, eps_n, scal, n_pairs=n_pairs, d_true=d,
            b=cfg.b, b_star=cfg.b_star)

        # Metropolis accept with the snooker Jacobian; non-finite → reject
        logp_star = log_prob(x_star)
        log_u = torch.log(u_acc)
        x_new, logp_new, logp_sum, acc = accept(
            x, x_star, state.logp, logp_star, log_jac, log_u, state.logp_sum)

        cr_p, cr_cum = state.cr_p, state.cr_cum
        cr_jump, cr_count = state.cr_jump, state.cr_count
        if cfg.adapt_cr and in_burnin:
            # normalised squared jumping distance per CR value (§4.7),
            # population variance from the generation-start positions
            s1 = torch.sum(x, dim=0)
            s2 = torch.sum(x ** 2, dim=0)
            var = torch.clamp_min(s2 / n - (s1 / n) ** 2, 1e-30)
            jump2 = torch.sum((x_new - x) ** 2 / var, dim=1)
            # credit the CR the move actually used (CR=1 on jump_full_cr
            # jump generations)
            cr_used = cr_idx
            if cfg.jump_full_cr and gamma_jump:
                cr_used = torch.full_like(cr_idx, cfg.n_cr - 1)
            onehot = torch.nn.functional.one_hot(
                cr_used, cfg.n_cr).to(dtype)                    # [n, n_cr]
            cr_jump = cr_jump + onehot.T @ jump2
            cr_count = cr_count + torch.sum(onehot, dim=0)
            rate = cr_jump / torch.clamp_min(cr_count, 1.0)
            cr_p_new = rate / torch.clamp_min(torch.sum(rate), 1e-30)
            # adapt once every CR value has some mass (and a jump moved)
            use_new = ((torch.amin(cr_count) > 4.0)
                       & torch.all(torch.isfinite(cr_p_new))
                       & (torch.sum(rate) > 0))
            cr_p = torch.where(use_new, cr_p_new, cr_p)
            cr_cum = torch.cumsum(cr_p / torch.sum(cr_p), 0)

        if (cfg.outlier_detect and in_burnin and gen > 0
                and gen % cfg.outlier_interval == cfg.outlier_interval - 1):
            # reset chains whose mean logp falls below Q1 − 2·IQR to the
            # current best chain
            mean_lp = logp_sum / float(gen + 1)
            q1 = torch.quantile(mean_lp, 0.25)      # "linear", as jnp's
            q3 = torch.quantile(mean_lp, 0.75)
            lo = q1 - 2.0 * (q3 - q1)
            is_outlier = mean_lp < lo
            # a [1] index, not a 0-d one: indexing by a 0-d tensor reads
            # it back to the host
            best = torch.argmax(logp_new).reshape(1)
            x_new = torch.where(is_outlier[:, None], x_new[best], x_new)
            logp_sum = torch.where(is_outlier, logp_sum[best], logp_sum)
            logp_new = torch.where(is_outlier, logp_new[best], logp_new)

        archive = state.archive
        if gen % cfg.archive_thin == cfg.archive_thin - 1:
            archive = archive_append(archive, x_new)

        new_state = DreamState(
            x=x_new, logp=logp_new, archive=archive, cr_p=cr_p,
            cr_cum=cr_cum, cr_jump=cr_jump, cr_count=cr_count,
            logp_sum=logp_sum, gen=gen + 1)
        return new_state, DreamInfo(accepted=acc, snooker=is_snk,
                                    logp=logp_new)

    return step
