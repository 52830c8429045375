"""Port ↔ JAX: the whole DREAM-zs generation, 60 generations in lockstep.

n = 32 chains, d = 8, a 4-mode ``gaussian_mixture``, archive capacity
256, burn-in 40: the run covers archive appends (every 10th generation),
γ = 1 jump generations (every 5th), snooker moves, CR adaptation and the
outlier resets (generations 9, 19, 29, 39). Both packages start from the
same NumPy x0 / z0, carried into the port through ``convert.py``. Each
generation's words are drawn as the JAX step draws them
(``fold_in(step_key(base, t), chain)`` then ``bits``) and fed to the
port's step, while the JAX step (Pallas proposal path, in interpret mode)
runs on the same key.

The same run is repeated for the two other configurations the module
builds, population-DREAM (``dream_config``: rows from the population,
each ≠ the chain itself, so B3's ``exclude`` path) and DE-MC-z
(``demcz_config``: one pair, one CR value, no adaptation), for
DREAM-zs with ``gather_kernel=True`` in both packages (the archive rows
through B11: ``gather_rows_pallas`` in interpret mode, the port's plain
version), and for DREAM-zs with ``pallas_accept=True`` in both packages
(the accept and state update through B10: ``accept_select_pallas`` in
interpret mode, the port's plain version, itself exact), which must take
the same decisions within the same tolerance.

Accept decisions and snooker flags must be identical at every
generation. The states are held within rtol 1e-5 / atol 1e-5: the two
packages sum over d and over the mixture's modes in different orders,
and those float32 differences carry from generation to generation
through x, logp and logp_sum (|logp_sum| reaches ~1e3, hence the rtol);
the archive rows are copies of x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.core.rng import step_key
from bipymc_tpu.models import targets as jtargets
from bipymc_tpu.samplers import dream as jdream
from bipymc_tpu_torch import convert
from bipymc_tpu_torch.models import targets
from bipymc_tpu_torch.samplers import dream

torch.set_num_threads(2)

N, D, CAP, BURNIN, GENS = 32, 8, 256, 40, 60
RTOL = ATOL = 1e-5


def _jax_fields(state):
    f = {name: np.asarray(getattr(state, name)) for name in
         ("x", "logp", "cr_p", "cr_cum", "cr_jump", "cr_count",
          "logp_sum", "gen")}
    for name in ("buf", "fill", "head"):
        f[f"archive.{name}"] = np.asarray(getattr(state.archive, name))
    return f


def _assert_state_close(port, jax_state, t):
    a, b = convert.dream_state_to_numpy(port), _jax_fields(jax_state)
    for name in ("archive.fill", "archive.head", "gen"):
        assert int(a[name]) == int(b[name]), (name, t)
    for name in ("x", "logp", "logp_sum", "cr_p", "cr_cum", "archive.buf"):
        np.testing.assert_allclose(a[name], b[name], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} after generation {t}")


@pytest.mark.parametrize("variant", ["dreamzs", "dream", "demcz",
                                     "dreamzs_gather", "dreamzs_accept"])
def test_sixty_generations_match_jax(variant):
    means = jtargets.baseline_config3_means(D)
    rng = np.random.default_rng(7)
    x0 = (means[np.arange(N) % 4]
          + 2.0 * rng.standard_normal((N, D))).astype(np.float32)
    z0 = (means[np.arange(64) % 4]
          + 2.0 * rng.standard_normal((64, D))).astype(np.float32)

    builders = {"dreamzs": (jdream.DreamConfig, dream.DreamConfig),
                "dream": (jdream.dream_config, dream.dream_config),
                "demcz": (jdream.demcz_config, dream.demcz_config),
                "dreamzs_gather": (jdream.DreamConfig, dream.DreamConfig),
                "dreamzs_accept": (jdream.DreamConfig, dream.DreamConfig)}
    jbuild, build = builders[variant]
    kw = {"dreamzs_gather": {"gather_kernel": True},
          "dreamzs_accept": {"pallas_accept": True}}.get(variant, {})
    jcfg = jbuild(n_chains=N, burnin_gens=BURNIN, pallas_proposal=True, **kw)
    cfg = build(n_chains=N, burnin_gens=BURNIN, **kw)
    assert cfg._asdict() == {**jcfg._asdict(), "pallas_proposal": None}
    jlp = jtargets.gaussian_mixture(means)
    jstate = jdream.init(jnp.asarray(x0), jlp, jcfg, CAP, jnp.asarray(z0))
    jstep = jax.jit(jdream.make_step(jlp, jcfg))

    step = dream.make_step(targets.gaussian_mixture(means), cfg)
    state = convert.dream_state_from_numpy(_jax_fields(jstate), "cpu")
    _assert_state_close(state, jstate, -1)

    n_words = dream.n_words(cfg, D)
    assert n_words == 5 + max(2 * jcfg.delta_max, 3) + 3 * D

    @jax.jit
    def words_of(key_t):
        return jax.vmap(lambda i: jax.random.bits(
            jax.random.fold_in(key_t, i), (n_words,), jnp.uint32))(
                jnp.arange(N, dtype=jnp.int32))

    base = jax.random.key(11)
    n_acc = n_snk = n_reset = 0
    for t in range(GENS):
        key_t = step_key(base, t)
        words = np.array(words_of(key_t)).view(np.int32)
        x_before = np.asarray(jstate.x)
        jstate, jinfo = jstep(jstate, key_t, jnp.int32(t))
        state, info = step(state, torch.from_numpy(words), t)

        np.testing.assert_array_equal(info.accepted.numpy(),
                                      np.asarray(jinfo.accepted),
                                      err_msg=f"accepts at generation {t}")
        np.testing.assert_array_equal(info.snooker.numpy(),
                                      np.asarray(jinfo.snooker),
                                      err_msg=f"snooker at generation {t}")
        _assert_state_close(state, jstate, t)
        acc = np.asarray(jinfo.accepted)
        n_acc += int(acc.sum())
        n_snk += int(np.asarray(jinfo.snooker).sum())
        # a reset chain lands on another chain's position without a move
        moved = np.any(np.asarray(jstate.x) != x_before, axis=1)
        n_reset += int(np.sum(moved & ~acc))

    # the run exercised what it claims to cover
    assert n_acc > 0
    assert (n_snk > 0) == (cfg.p_snooker > 0)
    assert n_reset == 0 or cfg.outlier_detect
    if variant.startswith("dreamzs"):    # this population has outliers
        assert n_reset > 0
    assert state.archive.fill == 64 + 6 * N
    assert np.allclose(state.cr_p.numpy(), 1 / cfg.n_cr) != cfg.adapt_cr


def test_config3_means_equal_jax():
    np.testing.assert_array_equal(targets.baseline_config3_means(100),
                                  jtargets.baseline_config3_means(100))


def test_gaussian_mixture_matches_jax():
    means = targets.baseline_config3_means(100)
    x = (means[np.arange(16) % 4] + np.random.default_rng(0).normal(
        size=(16, 100))).astype(np.float32)
    ref = np.asarray(jax.vmap(jtargets.gaussian_mixture(means))(
        jnp.asarray(x)))
    out = targets.gaussian_mixture(means)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
