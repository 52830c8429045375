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

The kernels' launch plans (``pallas_chol.plan``, ``pallas_solve.plan``)
are pure functions of the shapes: they are checked here for every n the
wrappers take against the card's limits (232,448 bytes of shared memory
a block, 8 CTAs a portable cluster). B8's arithmetic (per-tile sums, the
diagonal blocks' inverses and one refinement step) is emulated in
float32 here, each FMA rounded once, and held on config 5's factors to
the float64 rule of chip_smoke.py's phase 2d: within 1.5 x the plain
version's distance from a float64 solve, plus 1e-6.
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


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("lo", range(1, 1025, 128))
def test_b7_plan_fits_the_card(lo):
    """Every n the wrapper takes: the cluster route up to n = 480 with a
    portable cluster of min(nb, 8) CTAs, the rows dealt so that each CTA
    holds its plan's tiles at most, within a block's shared memory; the
    cooperative route above."""
    for n in range(lo, lo + 128):
        p = pallas_chol.plan(n)
        nb = -(-n // 32)
        assert p.smem <= pallas_chol.SMEM_PER_BLOCK
        assert 1 <= p.cluster <= 16
        if n > pallas_chol.CLUSTER_MAX_N:
            assert p == pallas_chol.Plan("cooperative", 1, 0,
                                         pallas_chol.COOP_SMEM)
            continue
        assert p.route == "cluster" and p.cluster == min(nb, 8)
        rows = [[i for i in range(nb) if pallas_chol.owner(i, p.cluster) == c]
                for c in range(p.cluster)]
        assert sorted(sum(rows, [])) == list(range(nb))
        tiles = [sum(i + 1 for i in r) for r in rows]
        assert max(tiles) == p.own_tiles and min(tiles) >= 1
        # own rows, two panel slots a block row, L_kk^T twice, 1/diag twice
        assert p.smem == ((p.own_tiles + 2 * nb + 2) * pallas_chol.TILE_BYTES
                          + 2 * 32 * 4)
    # one past the cluster route would not fit
    nb, c = 16, 8
    own = max(sum(i + 1 for i in range(nb) if pallas_chol.owner(i, c) == r)
              for r in range(c))
    assert ((own + 2 * nb + 2) * pallas_chol.TILE_BYTES + 256
            > pallas_chol.SMEM_PER_BLOCK)


@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 1024])
def test_b8_plan_fits_the_card(m):
    """For n up to 4096: a block takes 1 column at m = 1, else 8 (the
    kernel's two instances), enough blocks cover m, its shared memory
    fits, all of L's off-diagonal tiles stay in it up to n = 256, and
    above a ring of at least 2 is refilled half at a time."""
    for n in list(range(1, 600)) + list(range(600, 4097, 37)) + [4096]:
        p = pallas_solve.plan(n, m)
        nb = -(-n // 32)
        tiles = nb * (nb - 1) // 2
        assert p.cols == (1 if m == 1 else 8) and \
            p.blocks == -(-m // p.cols)
        assert p.smem <= pallas_solve.SMEM_PER_BLOCK
        assert p.smem == ((p.ring + 1) // 2 * 16
                          + p.ring * pallas_solve.TILE_BYTES
                          + 2 * 8 * pallas_solve.TILE_BYTES
                          + nb * 32 * p.cols * 4 + 8 * p.cols * 32 * 4)
        if n <= 256:
            assert p.ring == tiles and p.chunk >= nb - 1
        else:
            assert 2 <= p.ring < tiles and 1 <= p.chunk <= p.ring // 2


# ------------------------------------------- B8's arithmetic, emulated
def _fma(a, b, c):
    """fmaf in float32: the product and sum exact in float64, rounded
    once (a float32 product has 48 bits)."""
    return (a.double() * b.double() + c.double()).float()


def _diag_inverse(d):
    """csrc/trisolve.cu::invert_diag on [k, 32, 32] lower blocks: y = I,
    then for each q, row q scaled by the IEEE reciprocal of the pivot and
    subtracted from the rows below it, one FMA each."""
    y = torch.eye(32).repeat(d.shape[0], 1, 1)
    rinv = 1.0 / torch.diagonal(d, dim1=-2, dim2=-1)
    for q in range(32):
        y[:, q] = y[:, q] * rinv[:, q, None]
        for r in range(q + 1, 32):
            y[:, r] = _fma(-d[:, r, q, None], y[:, q], y[:, r])
    return y


def _matvec(m, v):
    """csrc/trisolve.cu::matvec: sum_q m[:, q] v[q] in four sums by q mod
    4, added pairwise."""
    y = torch.zeros(4, 32, v.shape[1])
    for q in range(32):
        y[q % 4] = _fma(m[:, q, None], v[q][None, :], y[q % 4])
    return (y[0] + y[1]) + (y[2] + y[3])


def _b8_emulated(L, b, transposed):
    """B8's float32 arithmetic for L [n, n] (n a multiple of 32 here) and
    b [n, m]: step i sums each tile of its block row (or column) over its
    32 columns in order, warp w taking the tiles w, w + 8, ..., the block
    then subtracts the eight warps' sums in order, and x_i = D⁻¹ r_i is
    refined once, x_i += D⁻¹(r_i − D x_i)."""
    nb = L.shape[0] // 32
    X = b.clone()

    def tile(i, j):
        return L[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32]

    dinv = _diag_inverse(torch.stack([tile(i, i) for i in range(nb)]))
    for i in (range(nb - 1, -1, -1) if transposed else range(nb)):
        part = torch.zeros(8, 32, X.shape[1])
        js = range(i + 1, nb) if transposed else range(i)
        for u, j in enumerate(js):
            t = tile(j, i).T if transposed else tile(i, j)
            acc = torch.zeros(32, X.shape[1])
            for q in range(32):
                acc = _fma(t[:, q, None], X[j * 32 + q][None, :], acc)
            part[u % 8] = part[u % 8] + acc
        r = X[i * 32:(i + 1) * 32].clone()
        for w in range(8):
            r = r - part[w]
        d, di = tile(i, i), dinv[i]
        if transposed:
            d, di = d.T, di.T
        x = _matvec(di, r)
        x = x + _matvec(di, r - _matvec(d, x))
        X[i * 32:(i + 1) * 32] = x
    return X


def _config5_factors():
    """Config 5's Gram matrices along optimize's trajectory (after 0, 10,
    30, 100 and 300 Adam steps), as chip_smoke.py's phase 2d makes them
    on the card, here on the CPU; their float32 factors and the
    standardised scores."""
    import bipymc_tpu_torch as bt

    rng = np.random.default_rng(11)
    t_grid = np.linspace(0, 1, 8)

    def fwd(th):
        return th[0] * np.exp(-2 * t_grid) + th[1] * t_grid ** 2

    y_obs = fwd(np.array([1.2, -0.7], np.float32)) + rng.normal(0, 0.05, 8)
    x = rng.uniform(-2, 2, (256, 2)).astype(np.float32)
    y = np.array([-0.5 * float((fwd(t) - y_obs) @ (fwd(t) - y_obs)) / 0.05 ** 2
                  for t in x], dtype=np.float32)
    gp = bt.GpRegressor(normalize_y=True, device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    grams = [gp._gram(bt.gp.default_params(2, device="cpu") if k == 0 else
                      gp.optimize(x, y, steps=k)[0], xt)
             for k in (0, 10, 30, 100, 300)]
    return torch.linalg.cholesky(torch.stack(grams)), gp._normalize(yt)[0]


@pytest.mark.parametrize("transposed", [False, True])
def test_b8_arithmetic_meets_the_float64_rule(transposed):
    # a solve: on a well-conditioned factor within the card test's bound
    # of the plain version
    Lw = torch.from_numpy(_chol(256, seed=3))
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (256, 3)).astype(np.float32))
    ref = (pallas_solve.tri_solve_t if transposed else
           pallas_solve.tri_solve)(Lw, b)
    np.testing.assert_allclose(_b8_emulated(Lw, b, transposed).numpy(),
                               ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    # config 5's factors (cond up to 8.3e5): no further from float64 than
    # the rule lets the kernel stand
    L, y = _config5_factors()
    worst_k = worst_p = 0.0
    for Lk in L:
        M = Lk.T if transposed else Lk
        x64 = torch.linalg.solve_triangular(M.double(), y.double()[:, None],
                                            upper=transposed)[:, 0]
        xk = _b8_emulated(Lk, y[:, None], transposed)[:, 0]
        xp = torch.linalg.solve_triangular(M, y[:, None],
                                           upper=transposed)[:, 0]
        scale = float(x64.abs().max())
        worst_k = max(worst_k, float((xk.double() - x64).abs().max()) / scale)
        worst_p = max(worst_p, float((xp.double() - x64).abs().max()) / scale)
    assert worst_k <= 1.5 * worst_p + 1e-6, (worst_k, worst_p)
