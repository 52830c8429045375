"""Port ↔ JAX: kernel B2 (the DREAM-zs proposal).

The port's plain version (``ops/dream_proposal.py::propose_block`` via the
dispatcher on CPU tensors) is held against
``dream_propose_pallas(..., interpret=True)`` on the same operands:
x_star within rtol 1e-5 / atol 1e-6 (float re-association of the sums
over d and the pairs). log_jac = (d−1)/2·(log num − log den) within
atol 1e-4 plus rtol 1e-5: at d = 100 it reaches |log_jac| ≈ 170, where
one float32 ulp is 1.5e-5, and the sums over d behind num and den differ
by a few ulps in association, which (d−1)/2 multiplies — more than an
atol of 1e-4 alone allows there. The CUDA kernel is held against the plain version
on the card with the same tolerances in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.ops.dream_proposal import dream_propose_pallas
from bipymc_tpu_torch.ops.dream_proposal import dream_propose

torch.set_num_threads(2)

N_PAIRS, B, B_STAR = 3, 1e-4, 1e-6


def make_operands(n, d, snooker, jump, ties, seed=0):
    """NumPy operands as the DREAM step builds them."""
    rng = np.random.default_rng(seed)
    k = max(2 * N_PAIRS, 3)
    x = rng.normal(size=(n, d)).astype(np.float32)
    rows = (x[:, None, :] + 2.0 * rng.normal(size=(n, k, d))).astype(
        np.float32)
    u_mask = rng.random((n, d)).astype(np.float32)
    if ties:
        # the minimum value repeated in several lanes: the FIRST one wins
        u_mask[:, ::2] = np.float32(0.0625)
        u_mask[:, 1::2] = np.maximum(u_mask[:, 1::2], np.float32(0.5))
    u_e = rng.random((n, d)).astype(np.float32)
    eps = rng.normal(size=(n, d)).astype(np.float32)
    delta = np.minimum(1 + np.floor(rng.random(n) * N_PAIRS), N_PAIRS)
    cr = rng.integers(1, 4, n) / 3.0
    gamma_s = 1.2 + rng.random(n)
    is_snk = {"all": np.ones(n), "none": np.zeros(n),
              "mixed": (rng.random(n) < 0.5).astype(float)}[snooker]
    gj = np.full(n, float(jump))
    scal = np.stack([delta, cr, gamma_s, is_snk, gj], 1).astype(np.float32)
    return x, rows, u_mask, u_e, eps, scal


def _pallas(ops, d):
    out = dream_propose_pallas(*map(jnp.asarray, ops), n_pairs=N_PAIRS,
                               d_true=d, b=B, b_star=B_STAR, interpret=True)
    return [np.asarray(a) for a in out]


def _close(x_star, log_jac, ref_x, ref_j):
    np.testing.assert_allclose(x_star, ref_x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(log_jac, ref_j, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("jump", [False, True])
@pytest.mark.parametrize("snooker", ["all", "none", "mixed"])
@pytest.mark.parametrize("n,d", [(5, 1), (32, 3), (5, 8), (32, 100),
                                 (5, 129)])
def test_plain_matches_pallas(n, d, snooker, jump, ties):
    ops = make_operands(n, d, snooker, jump, ties, seed=n * 1000 + d)
    ref_x, ref_j = _pallas(ops, d)
    x_star, log_jac = dream_propose(*map(torch.from_numpy, ops),
                                    n_pairs=N_PAIRS, d_true=d, b=B,
                                    b_star=B_STAR)
    _close(x_star.numpy(), log_jac.numpy(), ref_x, ref_j)


# float32's unit roundoff: the log Jacobian's own rounding is measured in it
EPS32 = float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("d", [300, 500])
def test_log_jac_at_large_d_is_float32_rounding(d):
    """At d = d_true = 300 and 500, every chain a snooker move, the
    reference's kernel (interpret mode) and the port's plain version each
    stand within (d_true − 1)/2 · 16 ε of the plain version run in float64
    on the same operands: the log Jacobian is (d_true − 1)/2 times a
    difference of logs of two float32 sums over d, so each float32 route
    carries (d_true − 1)/2 times the sums' relative rounding (~5 ε in
    these runs: 1.4e-4 and 1.6e-4 at d = 500), whatever its summation
    order. At d = 500 that exceeds the atol of 1e-4 the smaller d keep; the
    card's d = 500 case (tests/test_torch_cuda.py) takes its bound from
    this comparison."""
    for seed in range(2):
        ops = make_operands(32, d, "all", False, False, seed=d + seed)
        _, ref_j = _pallas(ops, d)
        _, j32 = dream_propose(*map(torch.from_numpy, ops), n_pairs=N_PAIRS,
                               d_true=d, b=B, b_star=B_STAR)
        _, j64 = dream_propose(*[torch.from_numpy(o).double() for o in ops],
                               n_pairs=N_PAIRS, d_true=d, b=B, b_star=B_STAR)
        bound = (d - 1) / 2 * 16 * EPS32
        assert np.abs(ref_j - j64.numpy()).max() <= bound
        assert np.abs(j32.numpy() - j64.numpy()).max() <= bound

def test_ties_take_the_first_minimum():
    """One chain, all u equal and ≥ cr: only lane 0 crosses over."""
    x, rows, u_mask, u_e, eps, scal = make_operands(1, 6, "none", False,
                                                    False)
    u_mask[:] = 0.9
    scal[0, 1] = 1 / 3                                 # cr < every u
    x_star, _ = dream_propose(*map(torch.from_numpy,
                                   (x, rows, u_mask, u_e, eps, scal)),
                              n_pairs=N_PAIRS, d_true=6, b=B, b_star=B_STAR)
    moved = (x_star.numpy() != x)[0]
    assert moved.tolist() == [True] + [False] * 5


def test_dispatcher_validates_shapes():
    ops = [torch.from_numpy(a) for a in
           make_operands(4, 3, "mixed", False, False)]
    with pytest.raises(ValueError):
        dream_propose(ops[0], ops[1][:, :2], *ops[2:], n_pairs=N_PAIRS,
                      d_true=3, b=B, b_star=B_STAR)
    with pytest.raises(ValueError):
        dream_propose(*ops[:5], ops[5][:, :4], n_pairs=N_PAIRS, d_true=3,
                      b=B, b_star=B_STAR)
