"""Port ↔ JAX: GP hyperparameter training (``GpRegressor.optimize``), the
GP surrogate (``surrogate_log_like``) and a small BASELINE config-5
slice, on the CPU with the same NumPy inputs.

The JAX package's ``optimize`` is a jitted ``lax.scan`` of optax's Adam
over ``jax.value_and_grad``; the port's is a host loop of the same Adam
over autograd. With the kernel flags off the port differentiates
``cholesky_ex`` and ``solve_triangular`` with PyTorch's own rules; with
them on, through the Functions of B7 and B8 (plain forwards on the CPU,
the card's backwards). The JAX package's flags only route on a TPU, so
its run is the same either way.

Tolerances, from the readings on this data:
- n = 64, 50 steps (config 4's data): the params within atol 1e-4
  (readings ≤ 3e-6) and the log-ML within rtol 1e-5 (readings ≤ 5e-6);
- config 5's full width (``benchmarks/run_all.py:439-452``: 256 points,
  ``normalize_y``, 300 steps): σ_n runs down to the jitter floor, where
  the float32 Gram is ill-conditioned and the two packages' rounding
  steers Adam apart by up to 3.3e-3 in a log length-scale or log σ_f
  (readings); the params within atol 1e-2 and the log-ML within rtol
  3e-5 (readings ≤ 7e-6).
The surrogate at one fit: "mean" within rtol 1e-4 (atol 1e-4 × the
largest value) of the reference's ``vmap``ped surrogate (a GP mean of
targets spanning 10⁴, from an ill-conditioned fit); "lcb" within the same
plus the float32 rounding of its variance term (test body); and, on the
JAX fit's own arrays, "mean" no further from a float64 evaluation than
1.5 × the JAX package's surrogate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.core.rng import step_key
from bipymc_tpu.gp.regressor import GpRegressor as JGpRegressor
from bipymc_tpu.samplers import dream as jdream
import bipymc_tpu_torch as bt
from bipymc_tpu_torch import convert
from bipymc_tpu_torch.samplers import dream

torch.set_num_threads(2)

TRUE_THETA = np.array([1.2, -0.7], np.float32)


def config5_data(n_design=256):
    """Config 5's design and scores (``benchmarks/run_all.py:439-452``);
    the first ``n_design`` of its 256 design points."""
    rng = np.random.default_rng(11)
    t_grid = np.linspace(0, 1, 8)

    def fwd(th):
        return th[0] * np.exp(-2 * t_grid) + th[1] * t_grid ** 2

    y_obs = fwd(TRUE_THETA) + rng.normal(0, 0.05, 8)
    design = rng.uniform(-2, 2, (256, 2)).astype(np.float32)[:n_design]
    scores = np.array([
        -0.5 * float((fwd(t) - y_obs) @ (fwd(t) - y_obs)) / 0.05 ** 2
        for t in design], dtype=np.float32)
    return design, scores


def config4_data(n=64):
    rng = np.random.default_rng(7)
    x = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
         + rng.normal(0, 0.2, n)).astype(np.float32)
    return x, y


@functools.cache
def jax_optimize(which, steps):
    x, y = config5_data() if which == "config5" else config4_data()
    jgp = JGpRegressor(normalize_y=which == "config5")
    p, lml = jgp.optimize(jnp.asarray(x), jnp.asarray(y), steps=steps,
                          lr=0.05)
    return convert.gp_params_to_numpy(p), float(lml)


@pytest.mark.parametrize("which,steps,p_atol,l_rtol", [
    ("config4", 50, 1e-4, 1e-5), ("config5", 300, 1e-2, 3e-5)])
@pytest.mark.parametrize("flags", [False, True])
def test_optimize_matches_jax(which, steps, p_atol, l_rtol, flags):
    x, y = config5_data() if which == "config5" else config4_data()
    gp = bt.GpRegressor(normalize_y=which == "config5", pallas_chol=flags,
                        pallas_solve=flags, device="cpu")
    p, lml = gp.optimize(x, y, steps=steps, lr=0.05)
    ref_p, ref_l = jax_optimize(which, steps)
    got = convert.gp_params_to_numpy(p)
    assert sorted(got) == sorted(ref_p)
    for name in ref_p:
        np.testing.assert_allclose(got[name], ref_p[name], rtol=0,
                                   atol=p_atol, err_msg=name)
    np.testing.assert_allclose(float(lml), ref_l, rtol=l_rtol)
    # the log-ML returned is the one at the params returned
    np.testing.assert_allclose(
        float(gp.log_marginal_likelihood(p, x, y)), float(lml), rtol=1e-6)


def test_optimize_non_finite_data_raises_as_jax_does():
    x, y = config4_data(16)
    y[3] = np.nan
    with pytest.raises(ValueError, match="non-finite for every restart"):
        JGpRegressor().optimize(jnp.asarray(x), jnp.asarray(y), steps=5)
    for flags in (False, True):
        gp = bt.GpRegressor(pallas_chol=flags, pallas_solve=flags,
                            device="cpu")
        with pytest.raises(ValueError, match="non-finite for every restart"):
            gp.optimize(x, y, steps=5)


def test_optimize_restarts_keep_the_best_and_repeat_with_the_key():
    x, y = config4_data(32)
    gp = bt.GpRegressor(device="cpu")
    start = {"log_lengthscale": np.array([1.5, -1.5], np.float32),
             "log_sigma_f": np.float32(1.0), "log_sigma_n": np.float32(0.5)}
    one, l1 = gp.optimize(x, y, params=start, steps=20)
    best, lb = gp.optimize(x, y, params=start, steps=20, n_restarts=4,
                           key=3)
    again, la = gp.optimize(x, y, params=start, steps=20, n_restarts=4,
                            key=3)
    assert float(lb) >= float(l1)
    assert float(la) == float(lb)
    for name in best:
        assert torch.equal(best[name], again[name])


@pytest.mark.parametrize("kind", ["mean", "lcb"])
@pytest.mark.parametrize("flags", [False, True])
def test_surrogate_matches_vmapped_jax(kind, flags):
    x, y = config5_data()
    params, _ = jax_optimize("config5", 300)
    jgp = JGpRegressor(normalize_y=True)
    jfit = jgp.fit(jnp.asarray(x), jnp.asarray(y),
                   {k: jnp.asarray(v) for k, v in params.items()})
    gp = bt.GpRegressor(normalize_y=True, pallas_chol=flags,
                        pallas_solve=flags, device="cpu")
    fit = gp.fit(x, y, convert.gp_params(params, "cpu"))
    theta = np.random.default_rng(2).uniform(-2.5, 2.5, (33, 2)).astype(
        np.float32)
    ref = np.asarray(jax.vmap(jgp.surrogate_log_like(jfit, kind))(
        jnp.asarray(theta)))
    out = gp.surrogate_log_like(fit, kind)(torch.from_numpy(theta))
    assert out.shape == (33,)
    # "lcb"'s variance, σ_f² − ‖L⁻¹k*‖², cancels in float32: its rounding
    # is ~n·ε·σ_f², which ½·y_std² scales into the target's units (~7)
    var_atol = (0.5 * float(np.std(y)) ** 2 * np.exp(
        2 * params["log_sigma_f"]) * len(y) * 2.0 ** -23
        if kind == "lcb" else 0.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max() + var_atol)
    if kind == "mean":
        # both against float64 arithmetic on the JAX fit's arrays: the
        # port's float32 rounding no worse than 1.5 × the JAX package's
        f = {k: np.asarray(getattr(jfit, k), np.float64)
             for k in ("x", "alpha", "y_mean", "y_std")}
        ls = np.exp(params["log_lengthscale"].astype(np.float64))
        d2 = (((f["x"][:, None, :] - theta[None].astype(np.float64)) / ls)
              ** 2).sum(-1)
        ks = np.exp(2.0 * float(params["log_sigma_f"])) * np.exp(-0.5 * d2)
        exact = f["y_mean"] + f["y_std"] * (ks.T @ f["alpha"])
        port = gp.surrogate_log_like(convert.gp_fit(jfit, "cpu"))(
            torch.from_numpy(theta)).numpy()
        assert np.abs(port - exact).max() <= \
            1.5 * np.abs(ref - exact).max() + 1e-3
    # one θ, unbatched, is the batch's row
    one = gp.surrogate_log_like(fit, kind)(torch.from_numpy(theta[5]))
    np.testing.assert_allclose(float(one), float(out[5]), rtol=1e-5,
                               atol=var_atol)


N, D, CAP, GENS = 32, 2, 256, 40
SLICE_STEPS = 10


def _slice_fits():
    """Config 5 small: 64 design points and 10 Adam steps in both
    packages; each package's own fit, and the port's ``GpRegressor``."""
    x, y = config5_data(64)
    jgp = JGpRegressor(normalize_y=True)
    jp, jl = jgp.optimize(jnp.asarray(x), jnp.asarray(y), steps=SLICE_STEPS)
    gp = bt.GpRegressor(normalize_y=True, pallas_chol=True,
                        pallas_solve=True, device="cpu")
    p, lml = gp.optimize(x, y, steps=SLICE_STEPS)
    np.testing.assert_allclose(float(lml), float(jl), rtol=1e-5)
    for name, v in convert.gp_params_to_numpy(jp).items():
        np.testing.assert_allclose(p[name].numpy(), v, rtol=0, atol=1e-4)
    return x, y, jgp, jgp.fit(jnp.asarray(x), jnp.asarray(y), jp), gp, p


def _run_slice(jsur, sur):
    """DREAM-zs over each surrogate plus config 5's prior, 32 chains, 40
    generations, both packages fed the same words (the pattern of
    tests/test_torch_dream_slice.py). Accept and snooker decisions must
    be identical at every generation, positions within rtol/atol 1e-5."""
    def jlog_post(th):
        return jsur(th) - 0.5 * jnp.sum((th / 2.0) ** 4)

    def log_post(th):
        return sur(th) - 0.5 * torch.sum((th / 2.0) ** 4, dim=-1)

    rng = np.random.default_rng(5)
    x0 = rng.normal(0, 1, (N, D)).astype(np.float32)
    z0 = rng.normal(0, 1, (64, D)).astype(np.float32)
    jcfg = jdream.DreamConfig(n_chains=N, burnin_gens=20)
    cfg = dream.DreamConfig(n_chains=N, burnin_gens=20)
    jstate = jdream.init(jnp.asarray(x0), jlog_post, jcfg, CAP,
                         jnp.asarray(z0))
    jstep = jax.jit(jdream.make_step(jlog_post, jcfg))
    step = dream.make_step(log_post, cfg)
    fields = {name: np.asarray(getattr(jstate, name)) for name in
              ("x", "logp", "cr_p", "cr_cum", "cr_jump", "cr_count",
               "logp_sum", "gen")}
    for name in ("buf", "fill", "head"):
        fields[f"archive.{name}"] = np.asarray(getattr(jstate.archive, name))
    state = convert.dream_state_from_numpy(fields, "cpu")
    np.testing.assert_allclose(state.logp.numpy(), log_post(
        torch.from_numpy(x0)).numpy(), rtol=1e-4)
    n_words = dream.n_words(cfg, D)

    @jax.jit
    def words_of(key_t):
        return jax.vmap(lambda i: jax.random.bits(
            jax.random.fold_in(key_t, i), (n_words,), jnp.uint32))(
                jnp.arange(N, dtype=jnp.int32))

    base = jax.random.key(3)
    n_acc = 0
    for t in range(GENS):
        key_t = step_key(base, t)
        words = np.array(words_of(key_t)).view(np.int32)
        jstate, jinfo = jstep(jstate, key_t, jnp.int32(t))
        state, info = step(state, torch.from_numpy(words), t)
        np.testing.assert_array_equal(info.accepted.numpy(),
                                      np.asarray(jinfo.accepted),
                                      err_msg=f"accepts at generation {t}")
        np.testing.assert_array_equal(info.snooker.numpy(),
                                      np.asarray(jinfo.snooker),
                                      err_msg=f"snooker at generation {t}")
        np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"x after generation {t}")
        n_acc += int(np.asarray(jinfo.accepted).sum())
    assert 0 < n_acc < N * GENS


def test_config5_slice_dream_accepts_match_jax():
    """Config 5 small (:func:`_slice_fits`: the log-ML within rtol 1e-5
    and the params within atol 1e-4); the port's fit at the JAX package's
    params (carried by ``convert``) against the JAX fit; then
    :func:`_run_slice` over the surrogate of the JAX fit, carried by
    ``convert.gp_fit``, so that both samplers read the same L and α.

    Why 10 steps: Adam drives σ_n down, and the surrogate's float32
    rounding grows with the fit's α, in both packages alike. Against a
    float64 evaluation of the same fit at 256 θ, the largest errors were
    port 0.0068 / JAX 0.0075 after 10 steps, and port 0.16 / JAX 0.31
    after 50, where the two disagree by 0.28 and an accept decision near
    its threshold would be decided by rounding, not by the port.
    test_surrogate_matches_vmapped_jax holds the port's surrogate to a
    float64 one at config 5's full fit."""
    x, y, jgp, jfit, gp, _ = _slice_fits()
    params = convert.gp_params_to_numpy(jfit.params)
    fit = gp.fit(x, y, convert.gp_params(params, "cpu"))
    jsur = jgp.surrogate_log_like(jfit)
    # the surrogate agrees at the design points within 1e-4 of its range
    ref = np.asarray(jax.vmap(jsur)(jnp.asarray(x)))
    np.testing.assert_allclose(gp.surrogate_log_like(fit)(
        torch.from_numpy(x)).numpy(), ref, rtol=0,
        atol=1e-4 * np.abs(ref).max())
    _run_slice(jsur, gp.surrogate_log_like(convert.gp_fit(jfit, "cpu")))


def test_config5_slice_on_the_ports_own_fit():
    """The port's own chain from training to sampler: its ``optimize``
    (10 Adam steps, B7 and B8 through their Functions), its ``fit`` and
    its surrogate, against the JAX package's optimize, fit and surrogate,
    under :func:`_run_slice`: the same accept and snooker decisions at
    every generation."""
    x, y, jgp, jfit, gp, p = _slice_fits()
    _run_slice(jgp.surrogate_log_like(jfit),
               gp.surrogate_log_like(gp.fit(x, y, p)))
