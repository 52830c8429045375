"""Fused multi-step engine for the random-walk family (MH / DR / DRAM).

Counterpart of ``bipymc_tpu/samplers/rw_fused.py``: a host loop over
K-step chunks, each ONE launch of kernel B4 (``ops/fused_rw_chunk.py``),
with the AM adaptation replayed outside the kernel from the chunk's
history. The trajectory depends on (θ, logp, chol) only, and chol changes
only at refresh points ``(t+1) % adapt_interval == 0``, so with
K = ``adapt_interval`` and chunk starts aligned to K the kernel never
sees a stale factor.

Exactness contract: the chunk takes step t's words from the same source
as the per-step engine (``core/rng.StepWords``: the words of (t, chain i)
depend on t alone), converts them with the same ``draws_fn``, builds the
displacements with the same :func:`~bipymc_tpu_torch.samplers.rw.
proposals`, replays the same Welford formula in the same order and
applies the same refresh gate, so accept decisions match the per-step
engine and positions match to float re-association.
"""

from typing import Callable

import torch

from bipymc_tpu_torch.ops.fused_rw_chunk import fused_rw_chunk
from bipymc_tpu_torch.samplers.rw import (RwConfig, RwState, default_draws,
                                          n_words, proposal_scale,
                                          proposals, refresh, welford)


def check_rw_fusable(cfg: RwConfig) -> None:
    """Raise unless the config's trajectory is chunk-fusable."""
    if cfg.adapt and cfg.adapt_interval == 1:
        raise ValueError(
            "fused RW engine requires adapt_interval > 1: the rank-1 "
            "every-step Cholesky mode changes the proposal factor inside "
            "any chunk (use the per-step engine)")


def make_rw_chunk_runner(log_prob: Callable, cfg: RwConfig, n_chains: int,
                         chunk_steps: int | None = None,
                         draws_fn: Callable | None = None) -> Callable:
    """Build ``run(state, words, n_steps, t0) -> (state, history)``.

    state: the batched ``RwState``. words: a word source with
    ``block(t0, K, n, n_words, device)`` (``core/rng.StepWords``), or
    None when ``draws_fn`` ignores the words. n_steps must be a multiple
    of the chunk length K (= ``adapt_interval`` with ``cfg.adapt``, else
    ``chunk_steps``, default 100); with ``cfg.adapt``, ``t0`` must be a
    multiple of K. draws_fn: as ``samplers/rw.make_step``'s, called once
    a chunk with the chunk's K steps. history is
    ``{"x": [n_steps, n, d], "logp": [n_steps, n], "accepted": ...}``.
    """
    check_rw_fusable(cfg)
    K = int(cfg.adapt_interval) if cfg.adapt else int(chunk_steps or 100)
    draws = draws_fn or default_draws

    def runner(state: RwState, words, n_steps: int, t0: int):
        n, d = state.theta.shape
        dtype, device = state.theta.dtype, state.theta.device
        if n != n_chains:
            raise ValueError(f"state has {n} chains, runner built for "
                             f"{n_chains}")
        if n_steps % K != 0:
            raise ValueError(f"n_steps={n_steps} not a multiple of the "
                             f"chunk length K={K}")
        if cfg.adapt and t0 % K != 0:
            raise ValueError(f"t0={t0} not aligned to adapt_interval={K}")
        sd = proposal_scale(cfg, d)
        st = state
        xs, lps, accs = [], [], []
        for c0 in range(t0, t0 + n_steps, K):
            ts = list(range(c0, c0 + K))
            blk = (None if words is None
                   else words.block(c0, K, n, n_words(d), device))
            z1, z2, uu1, uu2 = draws(blk, ts, d, dtype)
            dy1, dy2, sz1, sw = proposals(cfg, st.chol, z1, z2)
            if cfg.delayed:
                scal = torch.stack([sz1, sw, torch.log(uu1),
                                    torch.log(uu2)], dim=-1)
            else:
                # MH / AM: the kernel reads only the log u₁ lane
                zk = torch.zeros_like(uu1)
                scal = torch.stack([zk, zk, torch.log(uu1), zk], dim=-1)
            xh, lph, acc, _ = fused_rw_chunk(
                st.theta, st.logp, dy1.contiguous(),
                None if dy2 is None else dy2.contiguous(),
                scal.contiguous(), log_prob, delayed=cfg.delayed)
            mean, m2, count, chol = st.mean, st.m2, st.count, st.chol
            if cfg.adapt:
                # the per-step updates the kernel skipped: they never feed
                # back within a chunk
                for k in range(K):
                    mean, m2, count = welford(mean, m2, count, xh[k])
                if ts[-1] >= cfg.t0:
                    chol = refresh(cfg, sd, m2, count, chol)
            st = RwState(theta=xh[-1], logp=lph[-1], mean=mean, m2=m2,
                         count=count, chol=chol)
            xs.append(xh)
            lps.append(lph)
            accs.append(acc)
        hist = {"x": torch.cat(xs), "logp": torch.cat(lps),
                "accepted": torch.cat(accs)}
        return st, hist

    # the contract ChainPool.run_until checks at its entry: chunk lengths
    # are K-multiples; chunk starts are K-aligned when AM refresh points
    # must land on chunk boundaries; the history records state.theta
    runner.chunk_multiple = K
    runner.align = K if cfg.adapt else 1
    runner.position_field = "theta"
    return runner
