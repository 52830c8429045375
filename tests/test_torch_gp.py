"""Port ↔ JAX: the GP regressor, and DRAM over a GP log-ML (the shape of
BASELINE config 4), on the CPU with the same NumPy inputs.

``fit``, ``predict`` and ``log_marginal_likelihood`` of the port's
``GpRegressor`` against the JAX package's, on params moved by
``convert.gp_params``, within rtol 1e-5 (both factor the same float32
Gram matrix with LAPACK-style Choleskys that round differently; σ_n =
0.37 keeps the 64-point Gram's condition number near 10³, where float32
round-off stays below that bound); the batched log-ML over 8 param
sets, the port's form of the reference's ``vmap(_lml_impl)``, within the
same rtol.

Then the slice: ``Dram`` over ``log_post(θ) = lml(θ) − ½‖θ/2‖²`` on 64
training points, 8 chains, 100 steps, with one table of standard normals
and uniforms handed to both packages' ``draws_fn`` (as
tests/test_torch_rw.py does), so both steps see the same numbers. Accept
decisions and stages must be identical at every step, positions within
rtol 1e-5 / atol 1e-5 and logp within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.gp import kernels as jkernels
from bipymc_tpu.gp.regressor import GpRegressor as JGpRegressor
from bipymc_tpu.samplers import rw as jrw
import bipymc_tpu_torch as bt
from bipymc_tpu_torch import convert
from bipymc_tpu_torch.gp import kernels
from bipymc_tpu_torch.samplers import rw

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n=64, seed=7):
    """Config 4's data (benchmarks/run_all.py:298-303) at n points."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
         + rng.normal(0, 0.2, n)).astype(np.float32)
    return x, y


def _params(theta):
    """θ [..., 4] → the GP's params dict, as config 4 splits it."""
    return {"log_lengthscale": theta[..., 0:2],
            "log_sigma_f": theta[..., 2], "log_sigma_n": theta[..., 3]}


THETA = np.array([-0.3, 0.2, -0.1, -1.0], np.float32)


@pytest.mark.parametrize("kernel", ["squared_exp", "matern32", "matern52"])
@pytest.mark.parametrize("normalize_y", [False, True])
def test_fit_predict_lml_match_jax(kernel, normalize_y):
    x, y = _data()
    xs = np.random.default_rng(1).uniform(-4, 4, (9, 2)).astype(np.float32)
    jgp = JGpRegressor(kernel=getattr(jkernels, kernel),
                       normalize_y=normalize_y)
    gp = bt.GpRegressor(kernel=getattr(kernels, kernel),
                        normalize_y=normalize_y, device="cpu")
    jp = _params(jnp.asarray(THETA))
    p = convert.gp_params(_params(THETA), "cpu")
    jfit = jgp.fit(jnp.asarray(x), jnp.asarray(y), jp)
    fit = gp.fit(x, y, p)
    np.testing.assert_allclose(fit.chol.numpy(), np.asarray(jfit.chol),
                               **TOL)
    for out, ref in zip(gp.predict(fit, xs), jgp.predict(jfit,
                                                         jnp.asarray(xs))):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        float(gp.log_marginal_likelihood(p, x, y)),
        float(jgp.log_marginal_likelihood(jp, jnp.asarray(x),
                                          jnp.asarray(y))), rtol=1e-5)
    # a JAX fit moved by convert.gp_fit predicts as the port's own fit
    moved = convert.gp_fit(jfit, "cpu")
    for out, ref in zip(gp.predict(moved, xs), gp.predict(fit, xs)):
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_batched_lml_matches_vmapped_jax():
    x, y = _data()
    thetas = (THETA + np.random.default_rng(3).normal(0, 0.3, (8, 4))
              ).astype(np.float32)
    jgp, gp = JGpRegressor(), bt.GpRegressor(device="cpu")
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda t: jgp._lml_impl(_params(t), xj, yj)))(jnp.asarray(thetas)))
    out = gp._lml_impl(convert.gp_params(_params(thetas), "cpu"),
                       torch.from_numpy(x), torch.from_numpy(y))
    assert out.shape == (8,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    # one at a time, the same values
    for i in (0, 7):
        one = gp.log_marginal_likelihood(
            convert.gp_params(_params(thetas[i]), "cpu"), x, y)
        np.testing.assert_allclose(float(one), float(out[i]), rtol=1e-6)


def test_gram_floor_and_non_pd_give_nan_lml():
    x, y = _data(16)
    gp = bt.GpRegressor(device="cpu")
    p = convert.gp_params(_params(THETA), "cpu")
    # the jitter floor 4·n·ε(float32) on σ_f², as the reference floors it
    shift = gp._diag_shift(p, 16)
    want = np.exp(2 * THETA[3]) + max(1e-5, 64 * 2.0 ** -23) * np.exp(
        2 * THETA[2])
    np.testing.assert_allclose(float(shift), want, rtol=1e-6)
    # a negative-variance Gram (σ_f² scaled by −1 through a custom kernel)
    # is not positive definite: NaN, not an exception
    neg = bt.GpRegressor(kernel=lambda pp, a, b=None: -kernels.squared_exp(
        pp, a, b), device="cpu")
    assert np.isnan(float(neg.log_marginal_likelihood(p, x, y)))


def test_parts_not_ported_raise():
    """The kernel flags, once refused, now build and route: with
    ``pallas_chol`` and ``pallas_solve`` the factor goes through B7's and
    the solves through B8's autograd Functions (plain forwards on the
    CPU), and fit, predict and the log-ML give the default path's
    numbers."""
    x, y = _data()
    xs = np.random.default_rng(1).uniform(-4, 4, (9, 2)).astype(np.float32)
    p = convert.gp_params(_params(THETA), "cpu")
    plain = bt.GpRegressor(device="cpu")
    flags = bt.GpRegressor(pallas_chol=True, pallas_solve=True, device="cpu")
    fit, ref = flags.fit(x, y, p), plain.fit(x, y, p)
    for name in ("chol", "alpha"):
        np.testing.assert_allclose(getattr(fit, name).numpy(),
                                   getattr(ref, name).numpy(), rtol=1e-6,
                                   atol=1e-6)
    for out, want in zip(flags.predict(fit, xs), plain.predict(ref, xs)):
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(float(flags.log_marginal_likelihood(p, x, y)),
                               float(plain.log_marginal_likelihood(p, x, y)),
                               rtol=1e-6)
    # the routes: B7's and B8's Functions on the flagged regressor only
    leaf = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    kmat = flags._gram(leaf, torch.from_numpy(x))
    chol = flags._cholesky(kmat)
    assert type(chol.grad_fn).__name__ == "CholeskyBackward"
    assert type(flags._solve_lower(chol, torch.from_numpy(y)).grad_fn
                ).__name__ == "_TriSolveBackward"
    assert type(plain._cholesky(kmat).grad_fn).__name__ != \
        "CholeskyBackward"


N, D, T = 8, 4, 100


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((T, N, D)).astype(np.float32)
    z2 = rng.standard_normal((T, N, D)).astype(np.float32)
    u = rng.uniform(1e-7, 1.0, (2, T, N)).astype(np.float32)
    return z1, z2, u[0], u[1]


def test_dram_over_gp_matches_jax_with_injected_draws():
    x, y = _data()
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    jgp, gp = JGpRegressor(), bt.GpRegressor(device="cpu")

    def jlog_post(theta):                    # one chain, as run_all.py
        return (jgp._lml_impl(_params(theta), xj, yj)
                - 0.5 * jnp.sum((theta / 2.0) ** 2))

    def log_post(theta):                     # a batch of chains
        return (gp.log_marginal_likelihood(_params(theta), xt, yt)
                - 0.5 * torch.sum((theta / 2.0) ** 2, dim=-1))

    kw = dict(t0=40, adapt_interval=20)
    jcfg, cfg = jrw.dram_config(**kw), rw.dram_config(**kw)
    tables = _tables()
    jz = [jnp.asarray(a) for a in tables]
    tz = [torch.from_numpy(a) for a in tables]
    jstep = jax.jit(jax.vmap(jrw.make_step(
        jlog_post, jcfg, draws_fn=lambda i, t, d, dt: tuple(
            a[t, i] for a in jz)), in_axes=(0, 0, None)))
    step = rw.make_step(log_post, cfg, draws_fn=lambda w, ts, d, dt: tuple(
        a[ts] for a in tz))
    theta0 = (0.1 * np.random.default_rng(1).standard_normal((N, D))
              ).astype(np.float32)
    jstate = jax.vmap(lambda th: jrw.init(th, jlog_post, jnp.eye(D) * 0.05))(
        jnp.asarray(theta0))
    state = convert.rw_state_from_numpy(
        {k: np.asarray(getattr(jstate, k)) for k in
         ("theta", "logp", "mean", "m2", "count", "chol")}, "cpu")
    stages = np.zeros(3, int)
    for t in range(T):
        jstate, jinfo = jstep(jstate, jnp.arange(N), jnp.int32(t))
        state, info = step(state, None, t)
        np.testing.assert_array_equal(info.accepted.numpy(),
                                      np.asarray(jinfo.accepted),
                                      err_msg=f"accepts at step {t}")
        np.testing.assert_array_equal(info.stage.numpy(),
                                      np.asarray(jinfo.stage),
                                      err_msg=f"stages at step {t}")
        np.testing.assert_allclose(state.theta.numpy(),
                                   np.asarray(jstate.theta), **TOL,
                                   err_msg=f"theta after step {t}")
        np.testing.assert_allclose(state.logp.numpy(),
                                   np.asarray(jstate.logp), rtol=1e-5,
                                   err_msg=f"logp after step {t}")
        stages += np.bincount(info.stage.numpy(), minlength=3)
    # the run covered rejections and accepts at both stages, and adapted
    assert stages.min() > 0
    assert not np.allclose(state.chol.numpy(), np.linalg.cholesky(
        np.eye(D) * 0.05))
