"""Port ↔ JAX: kernel B1's plain version against ``fused_chunk_pallas``
in interpret mode, on the same NumPy ``x0, logp0, rows, u_mask, u_e,
eps, scal``.

The JAX kernel evaluates ``block_logp_from_scalar`` of the JAX target,
the port's plain version the batched target of the same name. The
operands cover snooker and parallel moves in one generation, δ ∈ {1, 2,
3}, the three CR values and one γ = 1 jump generation. Accept decisions
must be identical. Positions and logp are held within rtol 1e-5 /
atol 1e-5: the packages sum over d and over the modes in different
orders, the snooker log Jacobian (|log_jac| reaches ~10 at d = 8) carries
that rounding into log α, and a chain's x carries it over the G
generations. On the CPU the dispatcher takes the plain version; the
kernel's wrapper raises for what it does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.models import targets as jtargets
from bipymc_tpu.ops.fused_chunk import (block_logp_from_scalar,
                                        fused_chunk_pallas)
from bipymc_tpu_torch.models import targets
from bipymc_tpu_torch.ops.fused_chunk import (fused_chunk,
                                              fused_chunk_plain,
                                              run_fused_chunk)
from bipymc_tpu_torch.testing import match_decisions, plain_log_alpha

torch.set_num_threads(2)

KW = dict(n_pairs=3, b=1e-4, b_star=1e-6)
RTOL = ATOL = 1e-5


def _targets(kind, d):
    rng = np.random.default_rng(d)
    if kind == "mixture":
        means = 2.0 * rng.standard_normal((4, d))
        return (jtargets.gaussian_mixture(means),
                targets.gaussian_mixture(means))
    a = rng.standard_normal((d, d))
    mean, cov = rng.standard_normal(d), a @ a.T / d + np.eye(d)
    return (jtargets.correlated_gaussian(mean, cov),
            targets.correlated_gaussian(mean, cov))


def _operands(G, n, d, seed, jump_gen=3, p_snooker=0.3):
    """x0, rows, u_mask, u_e, eps, scal as the fused runner builds them:
    rows near the chains, δ ~ U{1..3}, CR ∈ {1/3, 2/3, 1}, γ_s ~ U(1.2,
    2.2), snooker with probability ``p_snooker``, γ = 1 at generation
    ``jump_gen``, log u of a uniform."""
    rng = np.random.default_rng(seed)
    x0 = 2.0 * rng.standard_normal((n, d))
    rows = x0[None, :, None, :] + 2.0 * rng.standard_normal((G, n, 6, d))
    u_mask = rng.random((G, n, d))
    u_e = rng.random((G, n, d))
    eps = rng.standard_normal((G, n, d))
    jump = np.zeros((G, n))
    if 0 <= jump_gen < G:
        jump[jump_gen] = 1.0
    scal = np.stack([
        np.minimum(1 + np.floor(rng.random((G, n)) * 3), 3),
        rng.integers(1, 4, (G, n)) / 3.0, 1.2 + rng.random((G, n)),
        (rng.random((G, n)) < p_snooker) * 1.0, jump,
        np.log(rng.uniform(1e-7, 1.0, (G, n)))], -1)
    f32 = lambda v: np.ascontiguousarray(v, dtype=np.float32)
    return [f32(a) for a in (x0, rows, u_mask, u_e, eps, scal)]


def _both(kind, G, n, d, seed, **op_kw):
    jlp, lp = _targets(kind, d)
    x0, rows, u_mask, u_e, eps, scal = _operands(G, n, d, seed, **op_kw)
    lp0 = lp(torch.from_numpy(x0)).numpy()
    jout = fused_chunk_pallas(
        *(jnp.asarray(a) for a in (x0, lp0, rows, u_mask, u_e, eps, scal)),
        block_logp_from_scalar(jlp, d), d_true=d, interpret=True, **KW)
    t = [torch.from_numpy(a) for a in (x0, lp0, rows, u_mask, u_e, eps,
                                      scal)]
    out = run_fused_chunk(*t, lp, d_true=d, **KW)
    return [np.asarray(a) for a in jout], [a.numpy() for a in out], scal


@pytest.mark.parametrize("kind,G,n,d,seed", [
    ("mixture", 10, 16, 8, 0), ("mixture", 10, 16, 8, 1),
    ("gaussian", 10, 16, 8, 2), ("mixture", 1, 7, 3, 3),
    ("gaussian", 4, 9, 129, 4)])
def test_plain_matches_pallas_interpret(kind, G, n, d, seed):
    (jx, jl, ja), (x, l, acc), scal = _both(kind, G, n, d, seed)
    assert x.shape == (G, n, d) and acc.dtype == np.bool_
    np.testing.assert_array_equal(acc, ja)
    np.testing.assert_allclose(x, jx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l, jl, rtol=RTOL, atol=ATOL)
    # the mix the docstring promises: snooker and parallel moves, accepted
    # and rejected, in one launch
    snk = scal[..., 3] > 0.5
    assert 0 < acc.sum() < acc.size
    if G > 1:
        assert snk.any() and (~snk).any()


def test_all_snooker_and_jump_generations_match():
    """Every move a snooker (its log Jacobian decides the accepts) and a
    jump generation in the middle of the chunk."""
    (jx, jl, ja), (x, l, acc), _ = _both("mixture", 6, 12, 8, 5,
                                         jump_gen=2, p_snooker=1.0)
    np.testing.assert_array_equal(acc, ja)
    np.testing.assert_allclose(x, jx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l, jl, rtol=RTOL, atol=ATOL)


def test_nonfinite_proposal_is_rejected_like_the_reference():
    """An archive row of +inf makes that chain's proposal non-finite in
    one generation: both packages reject it and keep the chain."""
    G, n, d = 5, 8, 4
    jlp, lp = _targets("mixture", d)
    x0, rows, u_mask, u_e, eps, scal = _operands(G, n, d, 6, jump_gen=-1)
    rows[2, 3] = np.inf
    lp0 = lp(torch.from_numpy(x0)).numpy()
    jout = fused_chunk_pallas(
        *(jnp.asarray(a) for a in (x0, lp0, rows, u_mask, u_e, eps, scal)),
        block_logp_from_scalar(jlp, d), d_true=d, interpret=True, **KW)
    ops = [torch.from_numpy(a) for a in (x0, lp0, rows, u_mask, u_e, eps,
                                         scal)]
    x, l, acc = fused_chunk_plain(*ops, lp, d_true=d, **KW)
    la = plain_log_alpha(*ops, lp, d_true=d, **KW)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jout[2]))
    assert not bool(acc[2, 3]) and float(la[2, 3]) == -np.inf
    assert np.all(np.isfinite(x.numpy()))
    np.testing.assert_allclose(x.numpy(), np.asarray(jout[0]), rtol=RTOL,
                               atol=ATOL)


def test_plain_log_alpha_decides_the_accepts():
    x0, rows, u_mask, u_e, eps, scal = [
        torch.from_numpy(a) for a in _operands(10, 16, 8, 7)]
    lp = _targets("mixture", 8)[1]
    args = (x0, lp(x0), rows, u_mask, u_e, eps, scal, lp)
    acc = fused_chunk_plain(*args, d_true=8, **KW)[2]
    la = plain_log_alpha(*args, d_true=8, **KW)
    assert torch.equal(acc, scal[..., 5] < la)
    assert 0 < int(acc.sum()) < acc.numel()


def test_wrapper_raises_for_what_the_kernel_does_not_take():
    G, n, d = 3, 4, 2
    ops = [torch.from_numpy(a) for a in _operands(G, n, d, 8)]
    x0, rows, u_mask, u_e, eps, scal = ops
    lp = _targets("mixture", d)[1]
    lp0 = lp(x0)
    args = (x0, lp0, rows, u_mask, u_e, eps, scal)
    # the kernel's wrapper never takes the plain version
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fused_chunk(*args, lp, d_true=d, **KW)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_chunk(*meta, lp, d_true=d, **KW)
    with pytest.raises(ValueError, match="kernel form"):
        fused_chunk(*meta, lambda x: -torch.sum(x ** 2, -1), d_true=d, **KW)
    with pytest.raises(ValueError, match="at most 16 modes"):
        fused_chunk(*meta, targets.gaussian_mixture(np.zeros((17, d))),
                    d_true=d, **KW)
    with pytest.raises(ValueError, match="float32"):
        fused_chunk(*[a.double() for a in meta], lp, d_true=d, **KW)
    with pytest.raises(ValueError, match="3-d"):
        fused_chunk(*meta, _targets("mixture", 3)[1], d_true=d, **KW)
    # shapes, on every device
    with pytest.raises(ValueError, match="scal"):
        run_fused_chunk(*args[:-1], scal[..., :5], lp, d_true=d, **KW)
    with pytest.raises(ValueError, match="archive rows"):
        run_fused_chunk(x0, lp0, rows[:, :, :5], u_mask, u_e, eps, scal, lp,
                        d_true=d, **KW)
    with pytest.raises(ValueError, match="u_e"):
        run_fused_chunk(x0, lp0, rows, u_mask, u_e[:2], eps, scal, lp,
                        d_true=d, **KW)


def test_match_decisions_excuses_only_near_ties():
    """The card checks' rule: a differing bit is excused only where the
    reference's |log u − log α| < 1e-4, and that chain's later
    generations are then left out of the value comparison."""
    ref = torch.tensor([[1, 0, 1], [0, 0, 1], [1, 1, 0]], dtype=torch.bool)
    margin = torch.ones((3, 3))
    kept, n = match_decisions(ref.clone(), ref, margin)
    assert bool(kept.all()) and n == 0
    acc = ref.clone()
    acc[1, 1] = True
    margin[1, 1] = 5e-5
    kept, n = match_decisions(acc, ref, margin)
    assert n == 1 and kept[:, 1].tolist() == [True, False, False]
    assert bool(kept[:, [0, 2]].all())
    margin[1, 1] = 1e-3
    with pytest.raises(AssertionError, match="generation 1, chain 1"):
        match_decisions(acc, ref, margin)
