"""Helpers that hold kernels B1, B9 and B10 against their plain versions.

Used by ``chip_smoke.py`` and the tests; no sampler path calls them.
A float32 kernel and its plain version may round a Metropolis decision
differently where log u lies within rounding of log α, so the checks
read the plain version's log α (:func:`plain_log_alpha`,
:func:`stretch_log_alpha`) and excuse only such near ties
(:func:`match_decisions`, :func:`match_stretch_decisions`). B10's ops are
exact, so its checks excuse nothing; they run on
:func:`accept_operands`, random operands with the edge rows of
:data:`ACCEPT_EDGE_ROWS` written in.
"""

import numpy as np
import torch

from bipymc_tpu_torch.ops.dream_proposal import propose_plain
from bipymc_tpu_torch.ops.fused_chunk import S_LOGU, metropolis_select
from bipymc_tpu_torch.ops.fused_stretch import stretch_generation


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


def stretch_log_alpha(x0, logp0, j, z, log_u, log_prob):
    """Each decision's log α [G, n] along ``fused_stretch_plain``'s
    trajectory on the same arguments (the per-generation engine's too)."""
    x, lp = x0, logp0
    out = []
    for g in range(j.shape[0]):
        x, lp, _, la = stretch_generation(x, lp, j[g], z[g], log_u[g],
                                          log_prob)
        out.append(la)
    return torch.stack(out)


def match_stretch_decisions(acc, ref_acc, ref_margin, tol=1e-4):
    """:func:`match_decisions` for the stretch move, whose walkers
    interact: a walker's position feeds the other half's proposals, so
    from the first generation in which a bit differs nothing further is
    comparable. In that generation each differing bit of the first half
    must lie within ``tol`` of its threshold (``ref_margin``), and so must
    each of the second half unless the first half already differed.
    Returns (kept [G, n] bool: the generations before, the number of
    differing bits excused); raises ``AssertionError`` otherwise."""
    diff = acc != ref_acc
    G, n = acc.shape
    half = n // 2
    gen = torch.arange(G, device=acc.device)[:, None].expand(G, n)
    rows = diff.any(1)
    if not bool(rows.any()):
        return torch.ones_like(acc, dtype=torch.bool), 0
    g0 = int(rows.to(torch.uint8).argmax())
    bad = diff[g0] & ~(ref_margin[g0] < tol)
    if bool(diff[g0, :half].any()):
        bad[half:] = False
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        raise AssertionError(
            f"accept bit (generation {g0}, walker {i}) differs from the "
            f"reference's with |log u - log alpha| = "
            f"{float(ref_margin[g0, i]):.3g} >= {tol}")
    return gen < g0, int(diff[g0].sum())


# B10's edge rows: the operand values that make each row, and whether the
# row must be accepted (a logp* that is not finite rejects; a NaN log α,
# from a NaN current logp or log Jacobian, rejects; logp = −inf gives
# log α = 0)
ACCEPT_FIELDS = ("x", "x_star", "logp", "logp_star", "log_jac", "log_u",
                 "logp_sum")
ACCEPT_EDGE_ROWS = (
    ({"logp_star": np.nan}, False),
    ({"logp_star": np.inf}, False),
    ({"logp_star": -np.inf}, False),
    ({"logp": np.nan}, False),
    ({"logp": -np.inf}, True),
    ({"logp": np.inf}, False),
    ({"log_jac": np.nan}, False),
    ({"log_u": -np.inf}, True),
    ({"logp_star": "logp", "log_jac": 0.0}, True),
)


def accept_operands(n, d, seed, edges=ACCEPT_EDGE_ROWS, dtype=np.float32):
    """B10's operands as NumPy arrays of ``dtype``, by
    :data:`ACCEPT_FIELDS`, made from ``seed``: x, x* [n, d] ~ N(0, 1);
    logp, logp* ~ N(0, 10²); log_jac ~ N(0, 0.1²); log u of U[0, 1);
    logp_sum ~ N(0, 1); ``edges`` (rows of :data:`ACCEPT_EDGE_ROWS`)
    written into rows 0, 1, … (n ≥ len(edges))."""
    rng = np.random.default_rng(seed)
    ops = {"x": rng.standard_normal((n, d)),
           "x_star": rng.standard_normal((n, d)),
           "logp": 10.0 * rng.standard_normal(n),
           "logp_star": 10.0 * rng.standard_normal(n),
           "log_jac": 0.1 * rng.standard_normal(n),
           "log_u": np.log(rng.random(n)),
           "logp_sum": rng.standard_normal(n)}
    for row, (edge, _) in enumerate(edges):
        for field, value in edge.items():
            ops[field][row] = (ops[value][row] if isinstance(value, str)
                               else value)
    return {k: v.astype(dtype) for k, v in ops.items()}


def accept_edge_groups(n):
    """:data:`ACCEPT_EDGE_ROWS` cut into groups of at most n rows, one
    operand set a group, so that every shape meets every edge row."""
    return [ACCEPT_EDGE_ROWS[i:i + n]
            for i in range(0, len(ACCEPT_EDGE_ROWS), n)]


def check_accept_edges(accepted, edges):
    """Raise if an edge row's accept bit is not the one it must be."""
    for row, (edge, want) in enumerate(edges):
        if bool(accepted[row]) != want:
            raise AssertionError(f"B10 edge row {edge}: accepted "
                                 f"{bool(accepted[row])}, want {want}")


def bit_equal(a, b):
    """Whether tensors a and b hold the same bits, NaN payloads included
    (``torch.equal`` fails on NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[a.element_size()]
    return torch.equal(a.view(as_int), b.view(as_int))
