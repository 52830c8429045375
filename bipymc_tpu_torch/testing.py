"""Helpers that hold kernel B1 against its plain version.

Used by ``chip_smoke.py`` and the tests; no sampler path calls them.
A float32 kernel and its plain version may round a Metropolis decision
differently where log u lies within rounding of log α, so the checks
read the plain version's log α (:func:`plain_log_alpha`) and excuse only
such near ties (:func:`match_decisions`).
"""

import torch

from bipymc_tpu_torch.ops.dream_proposal import propose_plain
from bipymc_tpu_torch.ops.fused_chunk import S_LOGU, metropolis_select


def plain_log_alpha(x0, logp0, rows, u_mask, u_e, eps, scal, log_prob, *,
                    n_pairs, d_true, b, b_star):
    """Each decision's log α [G, n] along ``fused_chunk_plain``'s
    trajectory on the same arguments."""
    G = scal.shape[0]
    x, lp = x0, logp0
    out = []
    for g in range(G):
        x_star, log_jac = propose_plain(
            x, rows[g], u_mask[g], u_e[g], eps[g], scal[g], n_pairs, d_true,
            b, b_star)
        x, lp, _, la = metropolis_select(x, lp, x_star, log_prob(x_star),
                                         log_jac, scal[g][:, S_LOGU])
        out.append(la)
    return torch.stack(out)


def match_decisions(acc, ref_acc, ref_margin, tol=1e-4):
    """Hold accept bits [G, n] against a reference's (the plain version's
    on the same operands). A bit may differ only where the reference's
    |log u − log α| (``ref_margin``) is below ``tol``, where float
    rounding decides it; that chain's later generations then follow
    another trajectory and are left out. Returns (kept [G, n] bool, the
    entries whose values are comparable, and the number of excused
    bits); raises ``AssertionError`` for a bit that differs unexcused."""
    diff = acc != ref_acc
    G = acc.shape[0]
    gen = torch.arange(G, device=acc.device)[:, None]
    # each chain's first differing generation (G where none differs)
    first = torch.where(diff.any(0), diff.to(torch.uint8).argmax(0), G)
    bad = diff & (gen == first) & ~(ref_margin < tol)
    if bool(bad.any()):
        g, i = (int(v) for v in torch.nonzero(bad)[0])
        raise AssertionError(
            f"accept bit (generation {g}, chain {i}) differs from the "
            f"reference's with |log u - log alpha| = "
            f"{float(ref_margin[g, i]):.3g} >= {tol}")
    return gen < first, int((first < G).sum())
