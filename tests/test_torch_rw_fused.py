"""The fused random-walk engine: the port's chunk runner against the JAX
package's, and against the port's own per-step engine.

The runner test hands the port the numbers the JAX runner computes from
its own words inside (``step_key`` on the global step, ``fold_in`` on the
chain, one [2d+2]-word block, the JAX word → number conversion), so both
runners take identical z and u; over 200 steps the accept decisions must
be identical, positions and logp within rtol 1e-5 / atol 1e-6, and the
replayed scatter and refreshed factor within 1e-5. Then
``Dram(fused=True)`` against ``Dram(fused=False)`` in the port: both read
the same step-keyed words, so accept decisions must be identical through
an unaligned continuation and through ``run_mcmc_until``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.core.rng import bits_to_uniform as jbits_to_uniform
from bipymc_tpu.core.rng import step_key
from bipymc_tpu.core.rng import uniform_to_normal as juniform_to_normal
from bipymc_tpu.models import targets as jtargets
from bipymc_tpu.samplers import rw as jrw
from bipymc_tpu.samplers.rw_fused import make_rw_chunk_runner as jrunner
from bipymc_tpu.utils import streaming as jstream
import bipymc_tpu_torch as bt
from bipymc_tpu_torch import convert
from bipymc_tpu_torch.core.rng import StepWords
from bipymc_tpu_torch.parallel.pool import ChainPool
from bipymc_tpu_torch.samplers import rw
from bipymc_tpu_torch.samplers.rw_fused import (check_rw_fusable,
                                                make_rw_chunk_runner)
from bipymc_tpu_torch.utils import streaming

torch.set_num_threads(2)

MEAN = np.array([1.0, -2.0])
COV = np.array([[2.0, 0.9], [0.9, 1.0]])


def _lp():
    return bt.correlated_gaussian(MEAN, COV)


def _jax_draws(key, n, d, T):
    """The numbers the JAX runner's prep derives for steps 0..T-1."""
    @jax.jit
    def one(t):
        kt = step_key(key, t)
        blk = jax.vmap(lambda i: jax.random.bits(
            jax.random.fold_in(kt, i), (2 * d + 2,), jnp.uint32))(
                jnp.arange(n, dtype=jnp.int32))
        u = jbits_to_uniform(blk, jnp.float32)
        return (juniform_to_normal(u[:, :d]),
                juniform_to_normal(u[:, d:2 * d]), u[:, 2 * d],
                u[:, 2 * d + 1])

    rows = [one(jnp.int32(t)) for t in range(T)]
    return [torch.from_numpy(np.stack([np.asarray(r[j]) for r in rows]))
            for j in range(4)]


@pytest.mark.parametrize("name,cfg_kw,K", [
    ("mh", dict(adapt=False, delayed=False), 50),
    ("dr", dict(adapt=False, delayed=True), 50),
    ("dram", dict(adapt=True, delayed=True, t0=60, adapt_interval=20), 20),
])
def test_runner_matches_jax_runner(name, cfg_kw, K):
    n, d, T = 4, 2, 200
    jcfg, cfg = jrw.RwConfig(**cfg_kw), rw.RwConfig(**cfg_kw)
    jlp = jtargets.correlated_gaussian(MEAN, COV)
    theta0 = np.random.default_rng(0).standard_normal((n, d)).astype(
        np.float32)
    jstate = jax.vmap(lambda t: jrw.init(t, jlp, jnp.eye(d) * 0.5))(
        jnp.asarray(theta0))
    key = jax.random.key(3)
    j_final, j_hist = jrunner(jlp, jcfg, n, chunk_steps=K)(jstate, key, T, 0)

    table = _jax_draws(key, n, d, T)
    runner = make_rw_chunk_runner(
        _lp(), cfg, n, chunk_steps=K,
        draws_fn=lambda w, ts, d_, dt: tuple(a[ts] for a in table))
    state = convert.rw_state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in jstate._fields}, "cpu")
    final, hist = runner(state, None, T, 0)

    np.testing.assert_array_equal(hist["accepted"].numpy(),
                                  np.asarray(j_hist["accepted"]))
    np.testing.assert_allclose(hist["x"].numpy(), np.asarray(j_hist["x"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hist["logp"].numpy(),
                               np.asarray(j_hist["logp"]),
                               rtol=1e-5, atol=1e-6)
    out = convert.rw_state_to_numpy(final)
    for field in ("chol", "m2", "mean", "count"):
        np.testing.assert_allclose(out[field],
                                   np.asarray(getattr(j_final, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    acc = hist["accepted"].numpy()
    assert 0 < acc.mean() < 1


def test_fused_api_run_and_unaligned_continuation():
    """130 steps (chunks at 0..119, a per-step remainder), then 130 more
    from step 130: a per-step head to 140, chunks, a remainder."""
    kw = dict(seed=0, n_chains=4, t0=60, adapt_interval=20, device="cpu")
    a = bt.Dram(_lp(), **kw)
    b = bt.Dram(_lp(), fused=True, **kw)
    for s in (a, b):
        s.run_mcmc(130, np.zeros(2), cov_est=np.eye(2) * 0.5)
        s.run_mcmc(130)
    np.testing.assert_array_equal(a.acceptance_fraction,
                                  b.acceptance_fraction)
    np.testing.assert_array_equal(a._history["accepted"],
                                  b._history["accepted"])
    np.testing.assert_allclose(a.get_chain(), b.get_chain(), rtol=1e-4,
                               atol=1e-5)
    assert b.get_chain().shape == (4, 260, 2)
    assert a.final_state.count == b.final_state.count == 261


def test_fused_api_run_until_matches_per_step():
    kw = dict(seed=1, n_chains=4, t0=60, adapt_interval=20, device="cpu")
    until_kw = dict(rhat_tol=1.1, chunk=40, max_chunks=50, warmup_chunks=2)
    ra = bt.Dram(_lp(), **kw).run_mcmc_until(
        np.zeros(2), cov_est=np.eye(2) * 0.5, **until_kw)
    rb = bt.Dram(_lp(), fused=True, **kw).run_mcmc_until(
        np.zeros(2), cov_est=np.eye(2) * 0.5, **until_kw)
    assert int(ra["steps"]) == int(rb["steps"])
    assert float(np.max(rb["rhat"])) < 1.1
    np.testing.assert_allclose(ra["rhat"], rb["rhat"], rtol=1e-3)


@pytest.mark.parametrize("cls", [bt.Metropolis, bt.AdaptiveMetropolis,
                                 bt.DrMetropolis, bt.Dram])
def test_family_recovers_the_posterior(cls):
    s = cls(_lp(), seed=2, n_chains=8, fused=True, device="cpu")
    s.run_mcmc(1500, np.zeros(2), cov_est=np.eye(2))
    draws = s.get_chain(discard=500, flat=True)
    assert np.all(np.abs(draws.mean(0) - MEAN) < 0.25)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.4)
    s.reset().run_mcmc(1500, np.zeros(2), cov_est=np.eye(2))
    np.testing.assert_array_equal(s.get_chain(discard=500, flat=True), draws)


def test_construction_errors():
    with pytest.raises(ValueError, match="adapt_interval"):
        check_rw_fusable(rw.dram_config(adapt_interval=1))
    with pytest.raises(ValueError, match="adapt_interval"):
        bt.Dram(_lp(), fused=True, adapt_interval=1)
    with pytest.raises(ValueError, match="float32"):
        bt.Dram(_lp(), fused=True, dtype=torch.float64)
    with pytest.raises(ValueError, match="correlated_gaussian"):
        bt.Dram(lambda x: -0.5 * torch.sum(x ** 2, -1), fused=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bt.Dram(_lp(), log_prob_block=lambda x: x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bt.Dram(_lp(), device="cpu").run_mcmc(5, np.zeros(2),
                                              progress_every=1)
    with pytest.raises(ValueError, match="n_chains"):
        bt.Dram(_lp(), device="cpu").run_mcmc_until(np.zeros(2))
    # the per-step engine takes any target, and float64
    s = bt.Dram(lambda x: -0.5 * torch.sum(x ** 2, -1), n_chains=2,
                dtype=torch.float64, device="cpu")
    assert s.run_mcmc(5, np.zeros(2)).get_chain().dtype == np.float64
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s.run_mcmc(5, np.zeros(2), cov_est=np.eye(2))
    assert any("cov_est" in str(x.message) for x in w)


def test_runner_and_pool_validate_the_contract():
    cfg = rw.dram_config(adapt_interval=20)
    runner = make_rw_chunk_runner(_lp(), cfg, 2)
    state = rw.init(torch.zeros((2, 2)), _lp(), torch.eye(2))
    words = StepWords(0)
    with pytest.raises(ValueError, match="multiple"):
        runner(state, words, 30, 0)
    with pytest.raises(ValueError, match="aligned"):
        runner(state, words, 20, 10)
    pool = ChainPool(rw.make_step(_lp(), cfg), rw.n_words)
    with pytest.raises(ValueError, match="position"):
        pool.run_until(state, words, chunk=20, chunk_runner=runner,
                       position_fn=lambda s: s.theta + 0)
    with pytest.raises(ValueError, match="multiple"):
        pool.run_until(state, words, chunk=30, chunk_runner=runner,
                       position_fn=lambda s: s.theta)
    with pytest.raises(ValueError, match="aligned"):
        pool.run_until(state, words, chunk=20, chunk_runner=runner,
                       position_fn=lambda s: s.theta, t0=10)


def test_step_words_do_not_depend_on_the_split():
    words = StepWords(12345)
    blk = words.block(7, 5, 3, 6, "cpu")
    for k in range(5):
        assert torch.equal(blk[k], words(7 + k, 3, 6, "cpu"))
    assert not torch.equal(blk[0], blk[1])
    assert not torch.equal(blk[0], StepWords(12346)(7, 3, 6, "cpu"))


def test_rhat_update_block_matches_jax():
    rng = np.random.default_rng(4)
    head = rng.standard_normal((30, 5, 3)).astype(np.float32)
    xs = (rng.standard_normal((40, 5, 3)) + 0.5).astype(np.float32)
    jc = jstream.rhat_init(5, 3)
    tc = streaming.rhat_init(5, 3, device="cpu")
    for blk in (head, xs):       # from a fresh carry, then onto a full one
        jc = jstream.rhat_update_block(jc, jnp.asarray(blk))
        tc = streaming.rhat_update_block(tc, torch.from_numpy(blk))
        np.testing.assert_allclose(tc.mean.numpy(), np.asarray(jc.mean),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tc.m2.numpy(), np.asarray(jc.m2),
                                   rtol=1e-5, atol=1e-5)
    assert tc.n == float(jc.n) == 70.0
    # and equal, up to float re-association, to one snapshot at a time
    sc = streaming.rhat_init(5, 3, device="cpu")
    for x in np.concatenate([head, xs]):
        sc = streaming.rhat_update(sc, torch.from_numpy(x))
    np.testing.assert_allclose(tc.m2.numpy(), sc.m2.numpy(), rtol=1e-4)
