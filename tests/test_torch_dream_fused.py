"""The fused DREAM-zs engine: the port's chunk runner and
``DreamZs(fused=True)`` against the port's per-generation engine, on the
CPU.

Both engines read generation t's words from ``core/rng.StepWords``
(they depend on t alone), draw the same archive rows and run the same
math (``propose_plain`` and ``metropolis_select``; kernel B1's plain
version on the CPU), so accept and snooker decisions must be identical
and positions equal up to float re-association (held within rtol 1e-6 /
atol 1e-6, the JAX package's ``tests/test_fused_chunk.py`` tolerance;
``logp_sum`` within 1e-5, summed per chunk instead of per generation).
The per-generation engine is held to the JAX package on injected words
by ``tests/test_torch_dream_slice.py``. These are the contracts of
``tests/test_fused_chunk.py``'s ``test_fused_matches_per_generation_
engine``, ``test_fused_run_until_matches_default``,
``test_api_fused_matches_default_engine``, ``test_fused_validation_
errors`` and ``test_api_fused_rejects_unsupported_config``, at small n
and d. ``rhat_merge`` is held to the JAX function on the same arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bipymc_tpu_torch as bt
from bipymc_tpu.utils import streaming as jstream
from bipymc_tpu_torch.ops.fused_chunk import fused_chunk
from bipymc_tpu_torch.samplers.dream_fused import (check_fusable,
                                                   make_chunk_runner,
                                                   validate_fused_segment)
from bipymc_tpu_torch.utils import streaming

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _mixture(d):
    means = np.zeros((2, d), dtype=np.float32)
    means[1, 0] = 4.0
    return bt.gaussian_mixture(means, sigma=1.0)


def _x0(n, d, seed):
    return (2.0 * np.random.default_rng(seed).standard_normal((n, d))
            ).astype(np.float32)


def _clone(state):
    """The state with a copy of its archive (appends write in place)."""
    return state._replace(archive=state.archive._replace(
        buf=state.archive.buf.clone()))


def _burned_in(d=6, n=8, gens=20, **cfg_kw):
    """A sampler after ``gens`` per-generation generations (burn-in 10,
    archive_thin 5), the state and the word source."""
    s = bt.DreamZs(_mixture(d), n_chains=n, seed=7, archive_thin=5,
                   burnin_gens=10, archive_capacity=64, device="cpu",
                   **cfg_kw)
    s.run_mcmc(gens, _x0(n, d, 1))
    return s, s.final_state, s._words


@pytest.mark.parametrize("cfg_kw", [{}, {"jump_full_cr": True,
                                         "jump_interval": 3}])
def test_fused_matches_per_generation_engine(cfg_kw):
    s, state20, words = _burned_in(**cfg_kw)
    ref_state, ref = s._pool_obj.run(_clone(state20), words, 20, t0=20)
    launches = fused_chunk.launches
    fus_state, fus = make_chunk_runner(s.log_like_fn, s.cfg)(
        _clone(state20), words, 20, 20)
    assert fused_chunk.launches == launches      # the CPU takes the plain
    assert torch.equal(ref["accepted"], fus["accepted"])
    assert torch.equal(ref["snooker"], fus["snooker"])
    assert 0 < float(fus["accepted"].float().mean()) < 1
    torch.testing.assert_close(fus["x"], ref["x"], **TOL)
    torch.testing.assert_close(fus["logp"], ref["logp"], **TOL)
    torch.testing.assert_close(fus_state.x, ref_state.x, **TOL)
    assert (fus_state.archive.fill, fus_state.archive.head, fus_state.gen) \
        == (ref_state.archive.fill, ref_state.archive.head, ref_state.gen)
    torch.testing.assert_close(fus_state.archive.buf, ref_state.archive.buf,
                               **TOL)
    torch.testing.assert_close(fus_state.logp_sum, ref_state.logp_sum,
                               rtol=1e-5, atol=1e-5)
    for name in ("cr_p", "cr_cum", "cr_jump", "cr_count"):
        assert torch.equal(getattr(fus_state, name),
                           getattr(ref_state, name)), name


def test_collect_modes_agree():
    """"stats" keeps the decisions without positions; "rhat" folds the
    positions into moments equal to folding the "all" history."""
    s, state20, words = _burned_in()
    outs = {c: make_chunk_runner(s.log_like_fn, s.cfg, collect=c)(
        _clone(state20), words, 20, 20) for c in ("all", "stats", "rhat")}
    all_state, hist = outs["all"]
    for c in ("stats", "rhat"):
        st, h = outs[c]
        assert "x" not in h and torch.equal(st.x, all_state.x)
        for k in ("logp", "accepted", "snooker"):
            assert torch.equal(h[k], hist[k]), (c, k)
    rc = outs["rhat"][1]["rhat"]
    ref = streaming.rhat_init(8, 6, device="cpu")
    for t in range(20):
        ref = streaming.rhat_update(ref, hist["x"][t])
    assert rc.n == 20.0
    torch.testing.assert_close(rc.mean, ref.mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rc.m2, ref.m2, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="collect"):
        make_chunk_runner(s.log_like_fn, s.cfg, collect="x")


def test_fused_statistics_on_gaussian():
    """2,000 fused generations sample a 2-d standard Gaussian."""
    d, n = 2, 16
    s = bt.DreamZs(bt.gaussian_mixture(np.zeros((1, d), np.float32)),
                   n_chains=n, seed=3, burnin_gens=0, archive_capacity=256,
                   fused=True, device="cpu")
    s.run_mcmc(2000, _x0(n, d, 2))
    kept = s.get_chain(discard=500, flat=True)
    assert np.all(np.abs(kept.mean(0)) < 0.15), kept.mean(0)
    assert np.all(np.abs(kept.std(0) - 1.0) < 0.15), kept.std(0)
    assert 0.05 < float(np.mean(s.acceptance_fraction)) < 0.9


def test_api_fused_matches_default_engine():
    """``run_mcmc`` of 503 then 200 generations, burn-in 20: burn-in and
    the unaligned tail on the per-generation engine, the rest fused, the
    same decisions as ``fused=False`` throughout."""
    d, n = 6, 8
    kw = dict(n_chains=n, seed=5, burnin_gens=20, archive_capacity=512,
              device="cpu")
    ref = bt.DreamZs(_mixture(d), **kw)
    fus = bt.DreamZs(_mixture(d), fused=True, **kw)
    for s in (ref, fus):
        s.run_mcmc(503, _x0(n, d, 3))
        s.run_mcmc(200)
    # burn-in, fused, tail; the head to alignment, fused, tail
    assert len(fus._chunks) == 6 and len(ref._chunks) == 2
    rh, fh = ref._history, fus._history
    assert set(rh) == set(fh) and rh["x"].shape == (703, n, d)
    np.testing.assert_array_equal(rh["accepted"], fh["accepted"])
    np.testing.assert_array_equal(rh["snooker"], fh["snooker"])
    np.testing.assert_allclose(fh["x"], rh["x"], **TOL)
    np.testing.assert_allclose(fh["logp"], rh["logp"], **TOL)
    assert fus.final_state.gen == 703


def test_fused_run_until_matches_default():
    """``run_mcmc_until`` with ``fused=True``: burn-in chunks on the
    per-generation engine, the later ones fused with their moments
    merged; the same stop, R̂ and final state as ``fused=False``."""
    d, n = 4, 16
    lp = bt.gaussian_mixture(np.zeros((1, d), np.float32))
    kw = dict(n_chains=n, seed=9, archive_thin=5, burnin_gens=20,
              archive_capacity=256, device="cpu")
    until = dict(rhat_tol=1.2, chunk=20, max_chunks=40, warmup_chunks=2)
    ref = bt.DreamZs(lp, **kw)
    r1 = ref.run_mcmc_until(_x0(n, d, 4), **until)
    fus = bt.DreamZs(lp, fused=True, **kw)
    r2 = fus.run_mcmc_until(_x0(n, d, 4), **until)
    assert int(r1["steps"]) == int(r2["steps"]) > 20
    np.testing.assert_allclose(r2["rhat"], r1["rhat"], rtol=1e-4)
    np.testing.assert_allclose(r2["mean"], r1["mean"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fus.final_state.x, ref.final_state.x, **TOL)
    # an unaligned chunk is rounded up to a multiple of archive_thin
    r3 = bt.DreamZs(lp, fused=True, **kw).run_mcmc_until(
        _x0(n, d, 4), rhat_tol=1.2, chunk=18, max_chunks=40,
        warmup_chunks=2)
    assert int(r3["steps"]) % 20 == 0
    # a continuation from an unaligned generation stays per-generation
    for s in (ref, fus):
        s.reset().run_mcmc(23, _x0(n, d, 4))
    a = ref.run_mcmc_until(None, **until)
    b = fus.run_mcmc_until(None, **until)
    assert int(a["steps"]) == int(b["steps"])
    torch.testing.assert_close(fus.final_state.x, ref.final_state.x, **TOL)


def test_rhat_merge_matches_jax():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(30, 8, 3)).astype(np.float32) + 0.5
    ja = jstream.rhat_update_block(jstream.rhat_init(8, 3),
                                   jnp.asarray(xs[:10]))
    jb = jstream.rhat_update_block(jstream.rhat_init(8, 3),
                                   jnp.asarray(xs[10:]))
    jm = jstream.rhat_merge(ja, jb)
    t = torch.from_numpy(xs)
    ta = streaming.rhat_update_block(streaming.rhat_init(8, 3, device="cpu"),
                                     t[:10])
    tb = streaming.rhat_update_block(streaming.rhat_init(8, 3, device="cpu"),
                                     t[10:])
    tm = streaming.rhat_merge(ta, tb)
    assert tm.n == float(jm.n) == 30.0
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(jm.mean),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.m2.numpy(), np.asarray(jm.m2), rtol=1e-6)
    # merging into an empty carry gives the other carry's moments
    te = streaming.rhat_merge(streaming.rhat_init(8, 3, device="cpu"), tb)
    je = jstream.rhat_merge(jstream.rhat_init(8, 3), jb)
    np.testing.assert_allclose(te.mean.numpy(), np.asarray(je.mean),
                               rtol=1e-6)
    np.testing.assert_allclose(te.m2.numpy(), np.asarray(je.m2), rtol=1e-6)


def test_fused_validation_errors():
    s, state20, words = _burned_in()
    runner = make_chunk_runner(s.log_like_fn, s.cfg)
    with pytest.raises(ValueError, match="multiple of"):
        runner(state20, words, 7, 20)
    with pytest.raises(ValueError, match="archive-aligned"):
        validate_fused_segment(s.cfg, 23)
    with pytest.raises(ValueError, match="post-burn-in"):
        validate_fused_segment(s.cfg, 5)
    with pytest.raises(ValueError, match="post-burn-in"):
        runner(state20, words, 10, 5)
    with pytest.raises(ValueError, match="use_archive"):
        check_fusable(s.cfg._replace(use_archive=False))
    with pytest.raises(ValueError, match="replicated"):
        check_fusable(s.cfg._replace(shard_archive=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_fusable(s.cfg, mesh=object())


def test_api_fused_rejects_unsupported_config():
    lp = bt.gaussian_mixture(np.zeros((1, 2), np.float32))
    with pytest.raises(ValueError, match="use_archive"):
        bt.DreamZs(lp, n_chains=12, fused=True, use_archive=False,
                   p_snooker=0.0, device="cpu")
    with pytest.raises(ValueError, match="kernel form"):
        bt.DreamZs(lambda x: -torch.sum(x ** 2, -1), n_chains=8, fused=True,
                   device="cpu")
    with pytest.raises(ValueError, match="float32"):
        bt.DreamZs(lp, n_chains=8, fused=True, dtype=torch.float64,
                   device="cpu")
    with pytest.raises(ValueError, match="fused_rng"):
        bt.DreamZs(lp, n_chains=8, fused=True, fused_rng="bogus",
                   device="cpu")
    for kw in ({"fused_z_update": 2},
               {"fused_gather": "pergen"}, {"log_prob_block": lambda x: x},
               {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            bt.DreamZs(lp, n_chains=8, fused=True, device="cpu", **kw)
    # thin != 1 runs on the per-generation engine, still correct
    s = bt.DreamZs(lp, n_chains=8, seed=0, burnin_gens=0, fused=True,
                   archive_capacity=64, device="cpu")
    s.run_mcmc(40, thin=4, theta_0=np.zeros((8, 2)), spread=2.0)
    assert s.get_chain().shape == (8, 10, 2)
