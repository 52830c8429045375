"""Port ↔ JAX: kernels B7 (Cholesky) and B8 (triangular solves), and the
gradients of B5, B6, B7 and B8, on the CPU with the same NumPy inputs.

On the CPU each wrapper takes its plain forward through the same
``torch.autograd.Function`` the card uses, so the backward tested here is
the card's. The JAX side runs its Pallas kernels in interpret mode, as
its own tests do (tests/test_pallas_chol.py, tests/test_pallas_solve.py,
tests/test_pallas_bchol.py), or its plain references where named.

Tolerances: forward values within rtol/atol 2e-5 × scale (B7) and 2e-4
(B8), the reference tests' own bounds for its kernels against XLA (two
float32 factorisations, or substitutions, summing in other orders);
adjoints on the same (L, L̄) within rtol 1e-4 (the same formula, two
libraries' triangular solves); θ-gradients through a GP-shaped loss
within rtol 2e-3 / atol 2e-4, the bound of tests/test_pallas_chol.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.ops import pallas_bchol as jbchol
from bipymc_tpu.ops import pallas_chol as jchol
from bipymc_tpu.ops import pallas_kernels as jkern
from bipymc_tpu.ops import pallas_solve as jsolve
from bipymc_tpu_torch.ops import pallas_bchol, pallas_chol, pallas_solve
from bipymc_tpu_torch.ops.pallas_kernels import sqdist

torch.set_num_threads(2)


def _spd(n, seed=0):
    """tests/test_pallas_chol.py's SPD matrices: a aᵀ + n I."""
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    return a @ a.T + n * np.eye(n, dtype=np.float32)


def _chol(n, seed=0):
    """tests/test_pallas_solve.py's factors: chol(a aᵀ/n + I)."""
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32) / np.sqrt(n)
    return np.linalg.cholesky(a @ a.T + np.eye(n)).astype(np.float32)


# ---------------------------------------------------------------- B7
@pytest.mark.parametrize("n", [4, 100, 200])
def test_b7_matches_pallas_interpret(n):
    k = _spd(n, seed=n)
    ref = np.asarray(jchol.cholesky_pallas(jnp.asarray(k), interpret=True))
    out = pallas_chol.cholesky_pallas(torch.from_numpy(k)).numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5 * scale)
    assert not np.any(np.triu(out, 1))
    # a batch, the reference's vmap, factors each matrix alike
    batch = np.stack([k, _spd(n, seed=n + 1)])
    outs = pallas_chol.cholesky_pallas(torch.from_numpy(batch)).numpy()
    np.testing.assert_array_equal(outs[0], out)


def test_b7_adjoint_matches_reference():
    rng = np.random.default_rng(3)
    L = np.linalg.cholesky(_spd(24, seed=2)).astype(np.float32)
    Lbar = rng.standard_normal((3, 24, 24)).astype(np.float32)
    for i in range(3):
        ref = np.asarray(jchol._chol_bwd_impl(jnp.asarray(L),
                                              jnp.asarray(Lbar[i])))
        out = pallas_chol.chol_adjoint(torch.from_numpy(L),
                                       torch.from_numpy(Lbar[i])).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    # batched over a leading axis: the reference's _bchol_bwd_impl
    Ls = np.stack([L, L, L])
    ref = np.asarray(jbchol._bchol_bwd_impl(jnp.asarray(Ls),
                                            jnp.asarray(Lbar)))
    out = pallas_chol.chol_adjoint(torch.from_numpy(Ls),
                                   torch.from_numpy(Lbar)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _gp_loss_inputs():
    """tests/test_pallas_chol.py::test_gradient_matches_jnp's data."""
    rng = np.random.default_rng(5)
    return (rng.standard_normal((96, 3)).astype(np.float32),
            rng.standard_normal((96,)).astype(np.float32),
            np.array([0.3, -0.2, 0.1], np.float32))


def test_b7_and_b8_theta_gradients_match_jax_grad():
    """The GP-shaped loss of tests/test_pallas_chol.py:38-60, through B7
    and B8 here and through ``jnp.linalg.cholesky`` and XLA's solves
    there."""
    x, y, theta = _gp_loss_inputs()
    n = len(y)

    def jloss(t):
        xj, yj = jnp.asarray(x), jnp.asarray(y)
        sq = jnp.sum((xj[:, None, :] - xj[None, :, :]) ** 2, -1)
        k = jnp.exp(t[1]) * jnp.exp(-0.5 * sq / jnp.exp(t[0]) ** 2) \
            + (0.1 + t[2] ** 2) * jnp.eye(n)
        l = jnp.linalg.cholesky(k)
        alpha = jax.scipy.linalg.cho_solve((l, True), yj)
        return -0.5 * yj @ alpha - jnp.sum(jnp.log(jnp.diag(l)))

    def loss(t):
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        sq = torch.sum((xt[:, None, :] - xt[None, :, :]) ** 2, -1)
        k = torch.exp(t[1]) * torch.exp(-0.5 * sq / torch.exp(t[0]) ** 2) \
            + (0.1 + t[2] ** 2) * torch.eye(n)
        l = pallas_chol.cholesky_pallas(k)
        alpha = pallas_solve.solve_chol(l, yt)
        return -0.5 * yt @ alpha - torch.sum(torch.log(torch.diagonal(l)))

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(theta)))
    t = torch.tensor(theta, requires_grad=True)
    loss(t).backward()
    np.testing.assert_allclose(t.grad.numpy(), g_ref, rtol=2e-3, atol=2e-4)


def test_b7_non_pd_is_nan():
    k = _spd(40, seed=1)
    k[20, 20] = -5.0
    batch = np.stack([k, _spd(40, seed=2)])
    out = pallas_chol.cholesky_pallas(torch.from_numpy(batch)).numpy()
    assert np.all(np.isnan(out[0]))
    assert np.all(np.isfinite(out[1]))


# ---------------------------------------------------------------- B8
@pytest.mark.parametrize("n,m,block", [(64, 1, 32), (200, 5, 64),
                                       (100, 130, 32)])
def test_b8_matches_pallas_interpret(n, m, block):
    """n not a multiple of the block, and m = 130, a partial second RHS
    tile (the reference's test_partial_rhs_tile_covered case)."""
    L = _chol(n)
    b = np.random.default_rng(1).standard_normal((n, m)).astype(np.float32)
    if m == 1:
        b = b[:, 0]
    Lj, bj = jnp.asarray(L), jnp.asarray(b)
    Lt, bt = torch.from_numpy(L), torch.from_numpy(b)
    for jfn, fn in ((jsolve.tri_solve, pallas_solve.tri_solve),
                    (jsolve.tri_solve_t, pallas_solve.tri_solve_t),
                    (jsolve.solve_chol, pallas_solve.solve_chol)):
        ref = np.asarray(jfn(Lj, bj, block, True))
        out = fn(Lt, bt).numpy()
        assert out.shape == ref.shape and np.all(np.isfinite(out))
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m", [None, 3])
def test_b8_gradients_match_jax_grad(m):
    """Gradients w.r.t. L and b of a scalar of each direction, against
    ``jax.grad`` through the reference's custom VJPs (interpret mode)."""
    n = 40
    rng = np.random.default_rng(4)
    L = _chol(n, seed=2)
    b = rng.standard_normal((n,) if m is None else (n, m)).astype(
        np.float32)
    w = rng.standard_normal(b.shape).astype(np.float32)
    for jfn, fn in ((jsolve.tri_solve, pallas_solve.tri_solve),
                    (jsolve.tri_solve_t, pallas_solve.tri_solve_t)):
        gl, gb = jax.grad(lambda l, v: jnp.sum(
            jnp.asarray(w) * jfn(l, v, 32, True) ** 2), argnums=(0, 1))(
                jnp.asarray(L), jnp.asarray(b))
        Lt = torch.tensor(L, requires_grad=True)
        bt = torch.tensor(b, requires_grad=True)
        torch.sum(torch.from_numpy(w) * fn(Lt, bt) ** 2).backward()
        np.testing.assert_allclose(Lt.grad.numpy(), np.asarray(gl),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb),
                                   rtol=1e-4, atol=1e-4)


def test_b8_batched_forms_match_one_at_a_time():
    Ls = np.stack([_chol(33, seed=s) for s in range(3)])
    b = np.random.default_rng(2).standard_normal((3, 33, 4)).astype(
        np.float32)
    Lt, bt = torch.from_numpy(Ls), torch.from_numpy(b)
    out = pallas_solve.tri_solve(Lt, bt)
    vec = pallas_solve.tri_solve_t(Lt, bt[..., 0])
    shared = pallas_solve.tri_solve(Lt[1], bt)
    for i in range(3):
        np.testing.assert_allclose(
            out[i].numpy(), pallas_solve.tri_solve(Lt[i], bt[i]).numpy(),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            vec[i].numpy(),
            pallas_solve.tri_solve_t(Lt[i], bt[i, :, 0]).numpy(),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            shared[i].numpy(),
            pallas_solve.tri_solve(Lt[1], bt[i]).numpy(),
            rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="B8 takes"):
        pallas_solve.tri_solve(Lt, bt[0])


# ---------------------------------------------------------------- B5
def test_b5_vjp_matches_jax_grad():
    """The gradient of B5's Function against ``jax.grad`` of the
    reference's custom-VJP ``_sqdist_pallas`` (its forward on the TPU
    interpreter), unbatched and batched."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(6)
    A = rng.standard_normal((130, 3)).astype(np.float32)
    B = rng.standard_normal((140, 3)).astype(np.float32)
    g = rng.standard_normal((130, 140)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ga, gb = jax.grad(lambda a, b: jnp.sum(
            jnp.asarray(g) * jkern._sqdist_pallas(a, b)), argnums=(0, 1))(
                jnp.asarray(A), jnp.asarray(B))
    At = torch.tensor(A, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    torch.sum(torch.from_numpy(g) * sqdist(At, Bt)).backward()
    np.testing.assert_allclose(At.grad.numpy(), np.asarray(ga), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(gb), rtol=1e-4,
                               atol=1e-3)
    # a leading chain axis: each chain's gradient is its own
    A2 = torch.tensor(np.stack([A, 2 * A]), requires_grad=True)
    B2 = torch.tensor(np.stack([B, B]), requires_grad=True)
    torch.sum(torch.from_numpy(g) * sqdist(A2, B2)).backward()
    np.testing.assert_allclose(A2.grad[0].numpy(), At.grad.numpy(),
                               rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------- B6
def test_b6_vjp_matches_jax_vjp():
    """Both of B6's entry points under autograd, against ``jax.vjp`` of
    ``cholesky_solve_batched_pallas`` / ``cholesky_batched_pallas`` in
    interpret mode, at b = 3, n = 20."""
    rng = np.random.default_rng(8)
    a = np.stack([_spd(20, seed=s) / 20 for s in range(3)])
    y = rng.standard_normal((3, 20)).astype(np.float32)
    lbar = rng.standard_normal((3, 20, 20)).astype(np.float32)
    zbar = rng.standard_normal((3, 20)).astype(np.float32)
    (l, z), vjp = jax.vjp(
        lambda aa, yy: jbchol.cholesky_solve_batched_pallas(aa, yy, True),
        jnp.asarray(a), jnp.asarray(y))
    abar_ref, ybar_ref = vjp((jnp.asarray(lbar), jnp.asarray(zbar)))
    at = torch.tensor(a, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    L, Z = pallas_bchol.cholesky_solve_batched(at, yt)
    np.testing.assert_allclose(L.detach().numpy(), np.asarray(l),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Z.detach().numpy(), np.asarray(z),
                               rtol=1e-5, atol=1e-5)
    torch.autograd.backward([L, Z], [torch.from_numpy(lbar),
                                     torch.from_numpy(zbar)])
    scale = float(np.abs(np.asarray(abar_ref)).max())
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(abar_ref),
                               rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(ybar_ref),
                               rtol=1e-4, atol=1e-4)

    _, vjp_l = jax.vjp(lambda aa: jbchol.cholesky_batched_pallas(aa, True),
                       jnp.asarray(a))
    (abar_l,) = vjp_l(jnp.asarray(lbar))
    at2 = torch.tensor(a, requires_grad=True)
    pallas_bchol.cholesky_batched(at2).backward(torch.from_numpy(lbar))
    np.testing.assert_allclose(at2.grad.numpy(), np.asarray(abar_l),
                               rtol=1e-4, atol=1e-4 * scale)
