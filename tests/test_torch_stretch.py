"""Port ↔ JAX: the stretch ensemble sampler (``EnsembleSampler``, stretch
move), per generation and fused over kernel B9's plain version.

- The port's step against ``bipymc_tpu.samplers.stretch.make_step``, fed
  the JAX step's own words (``fold_in(k1, i)`` for the first half's rows,
  ``fold_in(k2, i)`` for the second's, viewed as int32): the same accept
  decisions, x and logp within rtol 1e-6 / atol 1e-6 (the packages sum the
  target in different orders; logp passes near 0).
- B9's plain version against ``fused_stretch_pallas(..., interpret=True)``
  on the same per-walker (j, z, log u): the same decisions, x and logp
  within rtol 1e-5 / atol 1e-6 (B4's bound), a non-finite proposal
  rejected by both.
- The port's fused runner against its per-generation engine on the same
  ``StepWords``, with a remainder chunk; its ``collect="rhat"`` moments
  against the ``"all"`` history's.
- ``EnsembleSampler`` in both packages from the same start, the port
  reading the JAX run's words: the same decisions, chains within rtol
  1e-5, and for ``run_mcmc_until`` the same stopping generation.
- The moments of ``tests/test_stretch.py``, the refusals, and
  ``convert.py``'s round trip.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bipymc_tpu as bp
from bipymc_tpu.core.rng import step_key
from bipymc_tpu.models import targets as jtargets
from bipymc_tpu.ops.fused_chunk import block_logp_from_scalar
from bipymc_tpu.ops.fused_stretch import fused_stretch_pallas
from bipymc_tpu.samplers import stretch as jstretch
import bipymc_tpu_torch as bt
from bipymc_tpu_torch import convert
from bipymc_tpu_torch.core.rng import StepWords
from bipymc_tpu_torch.ops.fused_stretch import (CONSTS, MAX_SHARED_BYTES,
                                                MAX_WALKERS, ROUTES,
                                                fused_stretch,
                                                fused_stretch_plain, max_d,
                                                plan)
from bipymc_tpu_torch.samplers import api, stretch
from bipymc_tpu_torch.samplers.stretch_fused import make_chunk_runner
from bipymc_tpu_torch.testing import (match_stretch_decisions,
                                      stretch_log_alpha)

torch.set_num_threads(2)

CSRC = Path(bt.__file__).resolve().parent / "csrc"

MEAN = np.array([1.0, -1.0])
COV = np.array([[2.0, 0.8], [0.8, 1.0]])


def _targets(kind, d):
    """The same target in both packages: a correlated Gaussian or a
    three-mode mixture, from a seed."""
    rng = np.random.default_rng(10 + d)
    if kind == "gaussian":
        a = rng.standard_normal((d, d))
        mean, cov = rng.standard_normal(d), a @ a.T / d + np.eye(d)
        return (jtargets.correlated_gaussian(mean, cov),
                bt.correlated_gaussian(mean, cov))
    means = (1.5 * rng.standard_normal((3, d))).astype(np.float32)
    return jtargets.gaussian_mixture(means), bt.gaussian_mixture(means)


def _jax_words_fn(n):
    """Generation words as the JAX step draws them, [n, 3] uint32."""
    half = n // 2

    @jax.jit
    def words(key_t):
        k1, k2 = jax.random.split(key_t)

        def blk(k, i):
            return jax.random.bits(jax.random.fold_in(k, i), (3,),
                                   jnp.uint32)
        lo = jax.vmap(lambda i: blk(k1, i))(jnp.arange(half))
        hi = jax.vmap(lambda i: blk(k2, i))(jnp.arange(half, n))
        return jnp.concatenate([lo, hi])
    return words


class _JaxWords:
    """A word source for the port that returns the JAX sampler's words of
    generation t (its run key: the second half of ``split(key(seed))``,
    then ``step_key(k_run, t)``)."""

    def __init__(self, seed, n):
        self.k_run = jax.random.split(jax.random.key(seed))[1]
        self._words = _jax_words_fn(n)

    def __call__(self, t, n, n_words, device):
        w = np.array(self._words(step_key(self.k_run, t))).view(np.int32)
        return torch.from_numpy(w)

    def block(self, t0, n_steps, n, n_words, device):
        return torch.stack([self(t0 + k, n, n_words, device)
                            for k in range(n_steps)])


# ------------------------------------------------ the per-generation step
@pytest.mark.parametrize("kind", ["gaussian", "mixture"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("n", [2, 16, 18])
def test_step_matches_jax(n, d, kind):
    jlp, lp = _targets(kind, d)
    rng = np.random.default_rng(100 * n + d)
    x0 = (2.0 * rng.standard_normal((n, d))).astype(np.float32)
    jcfg = jstretch.StretchConfig(n_chains=n)
    cfg = stretch.StretchConfig(n_chains=n)
    assert cfg._asdict() == jcfg._asdict()
    jstate = jstretch.init(jnp.asarray(x0), jlp)
    jstep = jax.jit(jstretch.make_step(jlp, jcfg))
    state = stretch.init(torch.from_numpy(x0), lp)
    step = stretch.make_step(lp, cfg)
    words_of = _jax_words_fn(n)
    np.testing.assert_allclose(state.logp.numpy(), np.asarray(jstate.logp),
                               rtol=1e-6, atol=1e-6)
    base = jax.random.key(3)
    n_acc = 0
    for t in range(25):
        key_t = step_key(base, t)
        words = np.array(words_of(key_t)).view(np.int32)
        jstate, jinfo = jstep(jstate, key_t, jnp.int32(t))
        state, info = step(state, torch.from_numpy(words), t)
        np.testing.assert_array_equal(info.accepted.numpy(),
                                      np.asarray(jinfo.accepted),
                                      err_msg=f"accepts at generation {t}")
        np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(state.logp.numpy(),
                                   np.asarray(jstate.logp), rtol=1e-6,
                                   atol=1e-6)
        n_acc += int(np.asarray(jinfo.accepted).sum())
    assert state.gen == int(jstate.gen) == 25
    assert 0 < n_acc < 25 * n


# ------------------------------------------------ B9's plain version
def _b9_operands(G, n, d, seed):
    """x0 and per-walker (j, z, log u) [G, n] from random words, converted
    as the engines convert them."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (G, n, 3), dtype=np.uint64)
    words = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    j, z, log_u = stretch.convert_words(words, 2.0)
    x0 = (2.0 * rng.standard_normal((n, d))).astype(np.float32)
    return torch.from_numpy(x0), j, z, log_u


def _scal(j, z, log_u):
    """The JAX kernel's packed [G, n, 6] scalars: (j1, z1, log u1) on the
    first half's rows, (j2, z2, log u2) on the second's, zero elsewhere."""
    G, n = j.shape
    half = n // 2
    cols = [a.numpy().astype(np.float32) for a in (j, z, log_u)]
    scal = np.zeros((G, n, 6), np.float32)
    for c, v in enumerate(cols):
        scal[:, :half, c] = v[:, :half]
        scal[:, half:, 3 + c] = v[:, half:]
    return scal


# (1024, 100): the API's cap at config 3's width, which the CUDA kernel
# runs on its global route (plan); a smaller G keeps it fast
@pytest.mark.parametrize("kind", ["gaussian", "mixture", "nonfinite"])
@pytest.mark.parametrize("n,d", [(2, 1), (18, 3), (64, 16), (1024, 100)])
def test_plain_matches_pallas_interpret(n, d, kind):
    G = 5 if n <= 64 else 4
    jlp, lp = _targets("mixture" if kind == "mixture" else "gaussian", d)
    x0, j, z, log_u = _b9_operands(G, n, d, seed=n + d)
    if kind == "nonfinite":
        # an infinite stretch factor makes x* infinite: both must reject
        z[1, 0] = z[3, n - 1] = torch.inf
    lp0 = lp(x0)
    x, lph, acc = fused_stretch(x0, lp0, j, z, log_u, lp, n // 2)
    jx, jl, jacc = fused_stretch_pallas(
        jnp.asarray(x0.numpy()), jnp.asarray(lp0.numpy()),
        jnp.asarray(_scal(j, z, log_u)), block_logp_from_scalar(jlp, d),
        n_true=n, half=n // 2, d_true=d, interpret=True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lph.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    assert x.shape == (G, n, d) and acc.dtype == torch.bool
    if kind == "nonfinite":
        assert not bool(acc[1, 0]) and not bool(acc[3, n - 1])
    assert 0 < int(acc.sum()) and (n == 2 or int(acc.sum()) < G * n)


@pytest.mark.parametrize("n,d,route", [(256, 16, "shared"),
                                       (1024, 16, "shared"),
                                       (256, 100, "shared"),
                                       (1024, 100, "global")])
def test_b9_plan_fits_the_population_where_it_can(n, d, route):
    """B9's route on the correlated Gaussian: the population in shared
    memory where it fits the H100's 227 KB opt-in limit, with all of a
    half's walkers in one round (L lanes a walker, L × n/2 ≤ 1,024), else
    in global memory, with as many walkers at once as their residuals
    leave room for; a forced route that does not fit refused. The
    constants stay in shared memory at these shapes; past them (the
    Gaussian at d = 240) they are read from device memory."""
    chosen, consts, L, threads, smem = plan(n, d, 0)
    assert chosen == route and consts == "shared"
    assert smem <= MAX_SHARED_BYTES == 232_448
    assert L in (1, 2, 4, 8, 16, 32) and L * n // 2 <= 1024
    assert plan(n, d, 0, route="global")[0] == "global"
    if route == "global":
        assert plan(n, d, 0, route="shared") is None
        assert 32 <= threads < L * n // 2
        # the mixture needs no residual scratch: every walker in one round
        assert plan(n, d, 1, 4)[:4] == ("global", "shared", 2, 1024)
    else:
        assert threads == L * n // 2
        assert plan(n, d, 0, route="shared") == (chosen, consts, L, threads,
                                                 smem)
    # the Gaussian's constants alone past the limit: from device memory
    assert plan(8, 240, 0)[:4] == ("shared", "device", 32, 128)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, lp = _targets("gaussian", 2)
    x0, j, z, log_u = _b9_operands(3, 8, 2, seed=1)
    lp0 = lp(x0)
    with pytest.raises(ValueError, match="no kernel"):
        fused_stretch(x0.to("meta"), lp0.to("meta"), j.to("meta"),
                      z.to("meta"), log_u.to("meta"), lp, 4)
    with pytest.raises(ValueError, match="even"):
        fused_stretch(x0[:7], lp0[:7], j[:, :7], z[:, :7], log_u[:, :7],
                      lp, 3)
    big = MAX_WALKERS + 2
    with pytest.raises(ValueError, match="at most"):
        fused_stretch(torch.zeros(big, 2), torch.zeros(big),
                      torch.zeros(1, big, dtype=torch.int32),
                      torch.ones(1, big), torch.zeros(1, big), lp, big // 2)


def test_log_alpha_and_decision_matching():
    """``stretch_log_alpha`` gives the plain version's decisions, and
    ``match_stretch_decisions`` excuses a near tie but no other
    difference, comparing only the generations before the first."""
    _, lp = _targets("gaussian", 3)
    x0, j, z, log_u = _b9_operands(6, 8, 3, seed=4)
    lp0 = lp(x0)
    _, _, acc = fused_stretch_plain(x0, lp0, j, z, log_u, lp, 4)
    la = stretch_log_alpha(x0, lp0, j, z, log_u, lp)
    assert torch.equal(acc, log_u < la)
    margin = (log_u - la).abs()
    kept, excused = match_stretch_decisions(acc, acc, margin)
    assert bool(kept.all()) and excused == 0
    flipped = acc.clone()
    flipped[2, 1] = ~flipped[2, 1]            # a first-half bit
    flipped[2, 6] = ~flipped[2, 6]            # then any second-half bit
    near = margin.clone()
    near[2, 1] = 1e-6
    kept, excused = match_stretch_decisions(flipped, acc, near)
    assert excused == 2 and bool(kept[:2].all()) and not bool(kept[2:].any())
    with pytest.raises(AssertionError, match="generation 2, walker 1"):
        match_stretch_decisions(flipped, acc, margin.clamp_min(1.0))
    second = acc.clone()
    second[3, 5] = ~second[3, 5]              # a second-half bit alone
    with pytest.raises(AssertionError, match="generation 3, walker 5"):
        match_stretch_decisions(second, acc, margin.clamp_min(1.0))


# the correlated Gaussian past the shared-memory constants: on the card B9
# reads them from device memory there (plan's consts "device")
@pytest.mark.parametrize("n,d", [(16, 240), (8, 300)])
def test_plain_matches_pallas_interpret_past_shared_constants(n, d):
    G = 3
    jlp, lp = _targets("gaussian", d)
    assert plan(n, d, 0)[1] == "device"
    x0, j, z, log_u = _b9_operands(G, n, d, seed=n + d)
    lp0 = lp(x0)
    x, lph, acc = fused_stretch(x0, lp0, j, z, log_u, lp, n // 2)
    jx, jl, jacc = fused_stretch_pallas(
        jnp.asarray(x0.numpy()), jnp.asarray(lp0.numpy()),
        jnp.asarray(_scal(j, z, log_u)), block_logp_from_scalar(jlp, d),
        n_true=n, half=n // 2, d_true=d, interpret=True)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lph.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    assert 0 < int(acc.sum()) < G * n


def _c_plans(queries, tmp_path):
    """``csrc/fused_stretch_plan.cuh::fused_stretch_plan`` built with the
    host's C++ compiler, run on each (n, d, kind, n_modes, route, consts)
    (-1 unforced, else the index in ``ROUTES`` / ``CONSTS``) at the H100's
    shared memory: its plan as :func:`plan` writes it, or None."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the C plan with")
    src = tmp_path / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "fused_stretch_plan.cuh"\n'
        "int main() {\n  int q[7];\n"
        '  while (std::scanf("%d %d %d %d %d %d %d", q, q + 1, q + 2,'
        " q + 3, q + 4, q + 5, q + 6) == 7) {\n"
        "    b9plan::Plan p;\n"
        "    if (!b9plan::fused_stretch_plan(q[0], q[1], q[2], q[3], q[4],"
        " q[5], q[6], &p))\n"
        '      std::puts("None");\n'
        "    else\n"
        '      std::printf("%d %d %d %d %zu\\n", p.route, p.consts, p.L,'
        " p.threads, p.smem);\n  }\n}\n")
    exe = tmp_path / "plan"
    subprocess.run([cxx, "-std=c++17", "-O1", f"-I{CSRC}", str(src), "-o",
                    str(exe)], check=True, capture_output=True, timeout=120)
    text = "".join(f"{n} {d} {kind} {m} {MAX_SHARED_BYTES} {r} {c}\n"
                   for n, d, kind, m, r, c in queries)
    out = subprocess.run([str(exe)], input=text, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    plans = []
    for line in out.splitlines():
        if line == "None":
            plans.append(None)
            continue
        route, consts, L, threads, smem = map(int, line.split())
        plans.append((ROUTES[route], CONSTS[consts], L, threads, smem))
    return plans


def test_plan_matches_the_c_plan(tmp_path):
    """``plan`` mirrors the C plan the launch makes, over a grid that
    crosses every edge: the register instance's (d 16, 17; n 256, 258),
    L's (d 32, 33; L × n/2 at 1,024), the population's (n × d about
    227 KB), the constants' (the Gaussian at d 225–237 by n, the 16-mode
    mixture near d 3,250) and the residuals' (the Gaussian near
    ``max_d``), each unforced and with every route and place forced."""
    grid = [(n, d, kind, m)
            for n in (2, 8, 18, 32, 62, 64, 66, 256, 258, 512, 1024)
            for d in (1, 3, 4, 16, 17, 32, 33, 100, 129, 225, 226, 231, 232,
                      236, 237, 240, 300, 1000, 3248, 3249, 3250, 40316,
                      40317, 50876, 50877)
            for kind, m in ((0, 0), (1, 4), (1, 16))]
    queries = [(*q, r, c) for q in grid for r in (-1, 0, 1)
               for c in (-1, 0, 1)]
    want = [plan(n, d, kind, m, None if r < 0 else ROUTES[r],
                 None if c < 0 else CONSTS[c])
            for n, d, kind, m, r, c in queries]
    assert _c_plans(queries, tmp_path) == want
    assert sum(p is None for p in want) > 0
    assert {(p[0], p[1]) for p in want if p} == {
        (r, c) for r in ROUTES for c in CONSTS}
    assert max_d(64, 0) == 40_316 and max_d(1024, 0) == 50_876
    assert max_d(64, 1, 16) is None


# ------------------------------------------------ the fused runner
def test_fused_runner_matches_per_generation_engine():
    _, lp = _targets("gaussian", 3)
    n, gens = 16, 150
    cfg = stretch.StretchConfig(n_chains=n)
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (n, 3)).astype(np.float32))
    words = StepWords(12345)
    s = bt.EnsembleSampler(lp, n_chains=n, seed=0, device="cpu")
    state0 = stretch.init(x0, lp)
    ref_state, ref = s._pool_obj.run(state0, words, gens, t0=7)
    runner = make_chunk_runner(lp, cfg, kernel_gens=64)   # 64 + 64 + 22
    st, hist = runner(state0, words, gens, 7)
    np.testing.assert_array_equal(hist["accepted"].numpy(),
                                  ref["accepted"].numpy())
    np.testing.assert_allclose(hist["x"].numpy(), ref["x"].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hist["logp"].numpy(), ref["logp"].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert st.gen == ref_state.gen == gens
    assert hist["x"].shape == (gens, n, 3)

    st_r, hist_r = make_chunk_runner(lp, cfg, kernel_gens=64,
                                     collect="rhat")(state0, words, gens, 7)
    xs = hist["x"].numpy().astype(np.float64)
    rc = hist_r["rhat"]
    assert rc.n == gens and "x" not in hist_r
    np.testing.assert_allclose(rc.mean.numpy(), xs.mean(0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rc.m2.numpy(),
                               ((xs - xs.mean(0)) ** 2).sum(0), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(hist_r["accepted"].numpy(),
                                  hist["accepted"].numpy())


# ------------------------------------------------ the whole slice
def _x0_16x4():
    return (np.random.default_rng(21).standard_normal((16, 4))
            * np.linspace(0.5, 2.0, 4)).astype(np.float32)


def _slice_targets():
    cov = np.diag(np.linspace(0.5, 2.0, 4) ** 2) + 0.3
    return (jtargets.correlated_gaussian(np.zeros(4), cov),
            bt.correlated_gaussian(np.zeros(4), cov))


def _port_sampler(monkeypatch, lp, seed, fused):
    # the port's run reads the JAX run's words (``StepWords`` replaced)
    monkeypatch.setattr(api, "StepWords", lambda key: _JaxWords(seed, 16))
    return bt.EnsembleSampler(lp, n_chains=16, seed=seed, fused=fused,
                              device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_sampler_matches_jax(monkeypatch, fused):
    jlp, lp = _slice_targets()
    x0 = _x0_16x4()
    js = bp.EnsembleSampler(jlp, n_chains=16, seed=3, fused=fused)
    js.run_mcmc(100, jnp.asarray(x0))
    s = _port_sampler(monkeypatch, lp, 3, fused)
    s.run_mcmc(100, x0)
    np.testing.assert_array_equal(s._history["accepted"],
                                  np.asarray(js._history["accepted"]))
    np.testing.assert_allclose(s.super_chain, js.super_chain, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(s.acceptance_fraction, js.acceptance_fraction)


def test_fused_sampler_matches_jax_past_shared_constants(monkeypatch):
    """The fused engine on a 240-d correlated Gaussian (on the card, B9's
    constants from device memory), 70 generations (a chunk of 64 and
    one of 6), in both packages from the same start on the JAX run's
    words: the same decisions, chains within rtol 1e-5."""
    jlp, lp = _targets("gaussian", 240)
    x0 = (0.3 * np.random.default_rng(22).standard_normal((16, 240))
          ).astype(np.float32)
    js = bp.EnsembleSampler(jlp, n_chains=16, seed=6, fused=True)
    js.run_mcmc(70, jnp.asarray(x0))
    s = _port_sampler(monkeypatch, lp, 6, True)
    s.run_mcmc(70, x0)
    acc = s._history["accepted"]
    np.testing.assert_array_equal(acc, np.asarray(js._history["accepted"]))
    np.testing.assert_allclose(s.super_chain, js.super_chain, rtol=1e-5,
                               atol=1e-6)
    assert 0 < acc.mean() < 1


@pytest.mark.parametrize("fused", [False, True])
def test_rhat_stop_matches_jax(monkeypatch, fused):
    jlp, lp = _slice_targets()
    x0 = 0.1 * _x0_16x4()
    kw = dict(rhat_tol=1.1, chunk=40, max_chunks=50)
    ji = bp.EnsembleSampler(jlp, n_chains=16, seed=5,
                            fused=fused).run_mcmc_until(jnp.asarray(x0),
                                                        **kw)
    info = _port_sampler(monkeypatch, lp, 5, fused).run_mcmc_until(x0, **kw)
    assert int(info["steps"]) == int(ji["steps"]) > 3 * 40
    np.testing.assert_allclose(info["rhat"], ji["rhat"], rtol=1e-4)
    np.testing.assert_allclose(info["mean"], ji["mean"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_moments_on_correlated_gaussian(fused):
    s = bt.EnsembleSampler(bt.correlated_gaussian(MEAN, COV), n_chains=32,
                           seed=0, fused=fused, device="cpu")
    s.run_mcmc(3000, np.zeros(2), spread=1.5)
    flat = s.get_chain(discard=1000, flat=True)
    assert np.abs(flat.mean(0) - MEAN).max() < 0.2
    assert np.abs(np.cov(flat.T) - COV).max() < 0.5
    assert 0.1 < s.acceptance_fraction.mean() < 0.9


def test_fused_continuation_and_reset():
    lp = bt.correlated_gaussian(MEAN, COV)
    a = bt.EnsembleSampler(lp, n_chains=16, seed=4, device="cpu")
    b = bt.EnsembleSampler(lp, n_chains=16, seed=4, fused=True,
                           device="cpu")
    for s in (a, b):
        s.run_mcmc(50, np.zeros(2))
        s.run_mcmc(30)
    np.testing.assert_array_equal(a._history["accepted"],
                                  b._history["accepted"])
    np.testing.assert_allclose(a.super_chain, b.super_chain, rtol=1e-6,
                               atol=1e-6)
    assert b.final_state.gen == 80
    first = b.super_chain.copy()
    b.reset().run_mcmc(80, np.zeros(2))
    np.testing.assert_array_equal(b.super_chain, first)


# ------------------------------------------------ refusals
def _user_target(x):
    return -0.5 * torch.sum(x * x, dim=-1)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(n_chains=7), ValueError, "even"),
    (dict(n_chains=MAX_WALKERS + 2, fused=True), ValueError, "walkers"),
    (dict(move="walk"), NotImplementedError, "item 20"),
    (dict(move="kde"), ValueError, "unknown ensemble move"),
    (dict(mesh=object()), NotImplementedError, "item 15"),
    (dict(log_prob_block=lambda x: x), NotImplementedError, "18b"),
    (dict(lp=_user_target, fused=True), ValueError, "kernel"),
    (dict(dtype=torch.float64, fused=True), ValueError, "float32"),
], ids=["odd", "fused-cap", "walk", "unknown-move", "mesh",
        "log_prob_block", "fused-user-target", "fused-float64"])
def test_refusals(kw, exc, match):
    lp = kw.pop("lp", bt.correlated_gaussian(MEAN, COV))
    kw.setdefault("n_chains", 16)
    with pytest.raises(exc, match=match):
        bt.EnsembleSampler(lp, device="cpu", **kw)


def test_progress_every_and_missing_start_raise():
    s = bt.EnsembleSampler(bt.correlated_gaussian(MEAN, COV), n_chains=16,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        s.run_mcmc(10, np.zeros(2), progress_every=5)
    with pytest.raises(ValueError, match="theta_0"):
        s.run_mcmc(10)
    with pytest.raises(RuntimeError):
        s.chain
    with pytest.raises(ValueError, match="rows"):
        s.run_mcmc(10, np.zeros((5, 2)))


def test_per_generation_engine_takes_user_targets_and_float64():
    s = bt.EnsembleSampler(_user_target, n_chains=8, seed=2,
                           dtype=torch.float64, device="cpu")
    s.run_mcmc(40, np.zeros(3))
    assert s.super_chain.dtype == np.float64
    assert s.super_chain.shape == (8, 40, 3)


# ------------------------------------------------ convert.py
def test_convert_round_trip():
    jlp, lp = _targets("gaussian", 3)
    x0 = np.random.default_rng(2).standard_normal((6, 3)).astype(np.float32)
    jstate = jstretch.init(jnp.asarray(x0), jlp)
    fields = {k: np.asarray(getattr(jstate, k)) for k in jstate._fields}
    state = convert.stretch_state_from_numpy(fields, "cpu")
    assert isinstance(state, stretch.StretchState) and state.gen == 0
    back = convert.stretch_state_to_numpy(state)
    assert set(back) == set(jstate._fields)
    for k in jstate._fields:
        np.testing.assert_array_equal(back[k], fields[k])
        assert back[k].dtype == fields[k].dtype
