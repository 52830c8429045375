"""Port ↔ JAX: the random-walk family's per-step engine, 200 steps in
lockstep, with the same z and u handed to both packages.

n = 4 chains in d = 2 on a correlated Gaussian. Each package's
``draws_fn`` reads one table of standard normals and uniforms made with
NumPy, so both steps see the same numbers (the packages' inverse-erf
differ by up to 5e-5, tests/test_torch_rng.py, so words alone would not
do). MH, DR, DRAM (t0 = 60, adapt_interval = 20: three refreshes) and AM
in its rank-1 mode (adapt_interval = 1). Accept decisions and stages must
be identical at every step. Positions, logp, the Cholesky factor and the
scatter are held within rtol 1e-5 / atol 1e-5: the packages sum the
2-d quadratic form and the proposal's matrix product in different
orders, and the scatter grows to ~10² over 200 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.core import numerics as jnumerics
from bipymc_tpu.models import targets as jtargets
from bipymc_tpu.ops import linalg as jlinalg
from bipymc_tpu.samplers import rw as jrw
from bipymc_tpu_torch import convert
from bipymc_tpu_torch.core.numerics import log1mexp
from bipymc_tpu_torch.models import targets
from bipymc_tpu_torch.ops import linalg
from bipymc_tpu_torch.samplers import rw

torch.set_num_threads(2)

MEAN = np.array([1.0, -2.0])
COV = np.array([[2.0, 0.9], [0.9, 1.0]])
N, D, T = 4, 2, 200
TOL = dict(rtol=1e-5, atol=1e-5)


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((T, N, D)).astype(np.float32)
    z2 = rng.standard_normal((T, N, D)).astype(np.float32)
    # uniforms on (0, 1), away from 0 so log u is finite
    u = rng.uniform(1e-7, 1.0, (2, T, N)).astype(np.float32)
    return z1, z2, u[0], u[1]


def _jax_fields(state):
    return {name: np.asarray(getattr(state, name)) for name in
            ("theta", "logp", "mean", "m2", "count", "chol")}


@pytest.mark.parametrize("name,build,kw", [
    ("mh", "metropolis_config", {}),
    ("dr", "dr_metropolis_config", {}),
    ("dram", "dram_config", dict(t0=60, adapt_interval=20)),
    ("am_rank1", "adaptive_metropolis_config", dict(t0=60,
                                                    adapt_interval=1)),
])
def test_step_matches_jax_with_injected_draws(name, build, kw):
    jcfg = getattr(jrw, build)(**kw)
    cfg = getattr(rw, build)(**kw)
    assert cfg._asdict() == jcfg._asdict()
    z1, z2, u1, u2 = _tables()
    jz = [jnp.asarray(a) for a in (z1, z2, u1, u2)]
    tz = [torch.from_numpy(a) for a in (z1, z2, u1, u2)]

    # the JAX step is vmapped over chains with the chain index in place of
    # its key, so its draws_fn can read the table row of (t, chain)
    jlp = jtargets.correlated_gaussian(MEAN, COV)
    jstep = jrw.make_step(jlp, jcfg, draws_fn=lambda i, t, d, dt: (
        jz[0][t, i], jz[1][t, i], jz[2][t, i], jz[3][t, i]))
    jbatched = jax.jit(jax.vmap(jstep, in_axes=(0, 0, None)))
    theta0 = np.random.default_rng(1).standard_normal((N, D)).astype(
        np.float32)
    jstate = jax.vmap(lambda th: jrw.init(th, jlp, jnp.eye(D) * 0.5))(
        jnp.asarray(theta0))

    step = rw.make_step(targets.correlated_gaussian(MEAN, COV), cfg,
                        draws_fn=lambda w, ts, d, dt: tuple(a[ts]
                                                            for a in tz))
    state = convert.rw_state_from_numpy(_jax_fields(jstate), "cpu")
    stages = np.zeros(3, int)
    for t in range(T):
        jstate, jinfo = jbatched(jstate, jnp.arange(N), jnp.int32(t))
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
        stages += np.bincount(info.stage.numpy(), minlength=3)
    out = convert.rw_state_to_numpy(state)
    for field in ("logp", "mean", "m2", "chol", "count"):
        np.testing.assert_allclose(out[field], np.asarray(
            getattr(jstate, field)), **TOL, err_msg=field)
    # the run covered what it claims: rejections, stage-1 accepts, and
    # stage-2 accepts exactly where DR is on
    assert stages[0] > 0 and stages[1] > 0
    assert (stages[2] > 0) == cfg.delayed
    if cfg.adapt:
        assert not np.allclose(out["chol"], np.asarray(
            np.linalg.cholesky(np.eye(D) * 0.5)))


def test_log1mexp_matches_jax():
    # both branches and the branch point −0.2, from −50 to −1e-30
    x = -np.concatenate([np.logspace(-30, np.log10(50.0), 4000),
                         [0.2, np.nextafter(np.float32(0.2), 1),
                          np.nextafter(np.float32(0.2), 0)]]).astype(
        np.float32)
    ref = np.asarray(jnumerics.log1mexp(jnp.asarray(x)))
    out = log1mexp(torch.from_numpy(x)).numpy()
    # float32 log / log1p / exp of the two libraries: a few ulps
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=0)
    assert np.all(np.isfinite(out))


def test_correlated_gaussian_matches_jax():
    rng = np.random.default_rng(2)
    for d in (2, 5, 100):
        a = rng.standard_normal((d, d))
        cov = a @ a.T / d + np.eye(d)
        mean = rng.standard_normal(d)
        x = (mean + rng.standard_normal((16, d))).astype(np.float32)
        ref = np.asarray(jax.vmap(jtargets.correlated_gaussian(mean, cov))(
            jnp.asarray(x)))
        lp = targets.correlated_gaussian(mean, cov)
        np.testing.assert_allclose(lp(torch.from_numpy(x)).numpy(), ref,
                                   rtol=1e-5, atol=1e-4)
        form = lp.kernel_form
        assert form.name == "correlated_gaussian"
        np.testing.assert_allclose(form.arrays["inv"], np.linalg.inv(cov),
                                   rtol=1e-6, atol=1e-6)


def test_chol_rank1_update_and_solve_match_jax():
    rng = np.random.default_rng(3)
    n, d = 3, 5
    a = rng.standard_normal((n, d, d))
    L = np.linalg.cholesky(a @ a.transpose(0, 2, 1) + np.eye(d)).astype(
        np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ref = np.stack([np.asarray(jlinalg.chol_rank1_update(
        jnp.asarray(L[i]), jnp.asarray(x[i]), alpha=0.7)) for i in range(n)])
    out = linalg.chol_rank1_update(torch.from_numpy(L), torch.from_numpy(x),
                                   alpha=0.7).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    b = rng.standard_normal((n, d, 1)).astype(np.float32)
    ref = np.stack([np.asarray(jlinalg.solve_chol(jnp.asarray(L[i]),
                                                  jnp.asarray(b[i])))
                    for i in range(n)])
    out = linalg.solve_chol(torch.from_numpy(L), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
