"""Kernel B1's kernel-RNG mode, ``DreamZs(fused=True, fused_rng="kernel")``,
on the CPU.

In this mode B1 draws each generation's u_mask, u_e and eps itself:
Philox4x32-10 (``core/rng.philox4x32_10``, ``csrc/philox.cuh``), word
(t, chain i, lane j) from counter (j, i, 0, 0) under the key
``kernel_seed(run key, t)``. On the CPU the plain version draws the same
words in torch ops (``core/rng.kernel_draw_bits``). The tests hold:

- Philox to Random123's published known-answer vectors and to a plain
  Python-int Philox;
- the keying: a chain's draws do not depend on n, G or where a run is
  cut;
- kernel-RNG mode fed stream mode's words (``_test_stream_bits``) to
  stream mode, bit for bit (``tests/test_fused_chunk.py:211`` is the JAX
  package's counterpart);
- the plain version with ``test_bits`` to the JAX package's
  ``fused_chunk_pallas(interpret=True, rng="kernel", test_bits=...)``:
  decisions identical, x and logp within rtol 1e-5 / atol 1e-5, the
  tolerance of ``tests/test_torch_fused_chunk.py`` (sums over d and the
  modes in other orders; the JAX package's normals come from XLA's
  float32 ``erf_inv``, within 5e-5 of the port's, scaled by b* = 1e-6);
- the distributions: the port's kernel-RNG chains against the JAX
  package's stream-word chains and the truth (the test's docstring
  states the bands);
- ``run_mcmc`` and ``run_mcmc_until`` in kernel-RNG mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bipymc_tpu as bp
import bipymc_tpu_torch as bt
from bipymc_tpu.models import targets as jtargets
from bipymc_tpu.ops.fused_chunk import (block_logp_from_scalar,
                                        fused_chunk_pallas)
from bipymc_tpu_torch.core.rng import (KERNEL_RNG_FOLD, StepWords,
                                       _splitmix64, kernel_draw_bits,
                                       kernel_seed, philox4x32_10)
from bipymc_tpu_torch.models import targets
from bipymc_tpu_torch.ops.fused_chunk import (fused_chunk,
                                              fused_chunk_kernel_rng_plain,
                                              run_fused_chunk)
from bipymc_tpu_torch.samplers.dream_fused import make_chunk_runner
from bipymc_tpu_torch.utils.diagnostics import (effective_sample_size,
                                                nearest_mode)

torch.set_num_threads(2)

KW = dict(n_pairs=3, b=1e-4, b_star=1e-6)
RTOL = ATOL = 1e-5
M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ Philox
@pytest.mark.parametrize("ctr,key,out", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))],
    ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, out):
    """Random123's known-answer vectors for philox4x32_10."""
    assert tuple(int(w) for w in philox4x32_10(ctr, key)) == out


def _philox_ints(ctr, key):
    """Philox4x32-10 on Python ints (exact 64-bit products)."""
    c, k = [int(v) for v in ctr], [int(v) for v in key]
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & M32]
    return c


def test_philox_matches_python_ints_on_random_counters():
    """The vectorised int64 Philox (16-bit split products) against exact
    Python-int arithmetic on 256 random counters and keys."""
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2 ** 32, (4, 256), dtype=np.int64)
    key = rng.integers(0, 2 ** 32, (2, 256), dtype=np.int64)
    got = torch.stack(philox4x32_10(torch.from_numpy(ctr),
                                    torch.from_numpy(key))).numpy()
    for i in range(256):
        assert list(got[:, i]) == _philox_ints(ctr[:, i], key[:, i])


def test_kernel_seed_folds_the_step_seed():
    for key, t in ((0, 0), (123, 20), (2 ** 64 - 1, 10 ** 6)):
        assert kernel_seed(key, t) == _splitmix64(
            StepWords(key).seed_of(t) ^ KERNEL_RNG_FOLD)
    assert KERNEL_RNG_FOLD == 0x6B524E47


# ------------------------------------------------------------------ keying
def test_draws_depend_on_key_generation_chain_and_lane_alone():
    """Chain i's words are the same at n = 8 and n = 16 and at G = 1 and
    G = 10; the three blocks are Philox output words 0-2 of counter
    (lane, chain, 0, 0) under kernel_seed(key, t)."""
    key, d = 987654321, 5
    wide = kernel_draw_bits(key, 20, 10, 16, d, "cpu")
    narrow = kernel_draw_bits(key, 20, 10, 8, d, "cpu")
    one = kernel_draw_bits(key, 27, 1, 16, d, "cpu")
    for b in range(3):
        assert wide[b].shape == (10, 16, d) and wide[b].dtype == torch.int32
        assert torch.equal(wide[b][:, :8], narrow[b])
        assert torch.equal(wide[b][7:8], one[b])
    s = kernel_seed(key, 23)
    ref = _philox_ints((4, 11, 0, 0), (s & M32, s >> 32))
    got = [int(wide[b][3, 11, 4]) & M32 for b in range(3)]
    assert got == ref[:3]
    # the other generations, chains and lanes draw other words
    assert not torch.equal(wide[0][0], wide[0][1])
    assert len(set(wide[0].flatten().tolist())) == wide[0].numel()


def _mixture(d, sep=4.0):
    means = np.zeros((2, d), dtype=np.float32)
    means[1, 0] = sep
    return means


def _x0(n, d, seed):
    return (2.0 * np.random.default_rng(seed).standard_normal((n, d))
            ).astype(np.float32)


def _sampler(d=6, n=8, **kw):
    return bt.DreamZs(bt.gaussian_mixture(_mixture(d)), n_chains=n, seed=7,
                      archive_thin=5, burnin_gens=10, archive_capacity=256,
                      fused=True, fused_rng="kernel", device="cpu", **kw)


def test_run_cut_into_two_segments_is_one_run():
    """A run of 100 generations and the same run as 60 then 40 (both
    cuts archive-aligned) take the same draws and decisions."""
    d, n = 6, 8
    one, two = _sampler(d, n), _sampler(d, n)
    one.run_mcmc(100, _x0(n, d, 1))
    two.run_mcmc(60, _x0(n, d, 1))
    two.run_mcmc(40)
    for key in ("x", "logp", "accepted", "snooker"):
        np.testing.assert_array_equal(one._history[key], two._history[key])
    assert torch.equal(one.final_state.archive.buf,
                       two.final_state.archive.buf)


# --------------------------------------------------- port against port
def _clone(state):
    return state._replace(archive=state.archive._replace(
        buf=state.archive.buf.clone()))


@pytest.mark.parametrize("cfg_kw", [{}, {"jump_full_cr": True,
                                         "jump_interval": 3}])
def test_stream_words_reproduce_stream_mode_bit_for_bit(cfg_kw):
    """Kernel-RNG mode handed stream mode's last 3d words a chain
    (``_test_stream_bits``) converts them in its own code path and must
    give stream mode's x, logp, decisions and archive exactly."""
    s = bt.DreamZs(bt.gaussian_mixture(_mixture(6)), n_chains=8, seed=7,
                   archive_thin=5, burnin_gens=10, archive_capacity=64,
                   fused=True, device="cpu", **cfg_kw)
    s.run_mcmc(20, _x0(8, 6, 1))
    state, words = s.final_state, s._words
    st1, h1 = make_chunk_runner(s.log_like_fn, s.cfg)(
        _clone(state), words, 20, 20)
    st2, h2 = make_chunk_runner(s.log_like_fn, s.cfg, rng="kernel",
                                _test_stream_bits=True)(
        _clone(state), words, 20, 20)
    for key in ("x", "logp", "accepted", "snooker"):
        assert torch.equal(h1[key], h2[key]), key
    assert torch.equal(st1.archive.buf, st2.archive.buf)
    assert torch.equal(st1.logp_sum, st2.logp_sum)
    assert 0 < float(h2["accepted"].float().mean()) < 1
    # without the stream words the draws are Philox's: other decisions
    st3, h3 = make_chunk_runner(s.log_like_fn, s.cfg, rng="kernel")(
        _clone(state), words, 20, 20)
    assert not torch.equal(h3["x"], h1["x"])


# ---------------------------------------------------- port against JAX
def _targets(kind, d):
    rng = np.random.default_rng(d)
    if kind == "mixture":
        means = 2.0 * rng.standard_normal((4, d))
        return (jtargets.gaussian_mixture(means),
                targets.gaussian_mixture(means))
    a = rng.standard_normal((d, d))
    mean, cov = rng.standard_normal(d), a @ a.T / d + np.eye(d)
    return (jtargets.correlated_gaussian(mean, cov),
            targets.correlated_gaussian(mean, cov))


def _operands(G, n, d, seed, jump_gen=3, p_snooker=0.3):
    """x0, rows, scal as the fused runner builds them (δ ~ U{1..3}, CR ∈
    {1/3, 2/3, 1}, snooker with probability ``p_snooker``, γ = 1 at
    generation ``jump_gen``) and the three [G, n, d] word blocks."""
    rng = np.random.default_rng(seed)
    x0 = 2.0 * rng.standard_normal((n, d))
    rows = x0[None, :, None, :] + 2.0 * rng.standard_normal((G, n, 6, d))
    jump = np.zeros((G, n))
    if 0 <= jump_gen < G:
        jump[jump_gen] = 1.0
    scal = np.stack([
        np.minimum(1 + np.floor(rng.random((G, n)) * 3), 3),
        rng.integers(1, 4, (G, n)) / 3.0, 1.2 + rng.random((G, n)),
        (rng.random((G, n)) < p_snooker) * 1.0, jump,
        np.log(rng.uniform(1e-7, 1.0, (G, n)))], -1)
    bits = [rng.integers(0, 2 ** 32, (G, n, d), dtype=np.uint64)
            .astype(np.uint32) for _ in range(3)]
    f32 = lambda v: np.ascontiguousarray(v, dtype=np.float32)
    return f32(x0), f32(rows), f32(scal), bits


def _both(kind, G, n, d, seed, nonfinite=False, **op_kw):
    jlp, lp = _targets(kind, d)
    x0, rows, scal, bits = _operands(G, n, d, seed, **op_kw)
    if nonfinite:
        rows[G // 2, n // 2] = np.inf
    lp0 = lp(torch.from_numpy(x0)).numpy()
    jout = fused_chunk_pallas(
        jnp.asarray(x0), jnp.asarray(lp0), jnp.asarray(rows), None, None,
        None, jnp.asarray(scal), block_logp_from_scalar(jlp, d), d_true=d,
        interpret=True, rng="kernel", seeds=jnp.zeros((G,), jnp.uint32),
        test_bits=tuple(jnp.asarray(b) for b in bits), **KW)
    tb = tuple(torch.from_numpy(b.view(np.int32)) for b in bits)
    out = fused_chunk_kernel_rng_plain(
        torch.from_numpy(x0), torch.from_numpy(lp0), torch.from_numpy(rows),
        torch.from_numpy(scal), lp, d_true=d, run_key=0, t0=0, test_bits=tb,
        **KW)
    return [np.asarray(a) for a in jout], [a.numpy() for a in out], scal


@pytest.mark.parametrize("kind,G,n,d,seed,op_kw", [
    ("mixture", 10, 16, 8, 0, {}), ("mixture", 10, 16, 8, 1, {}),
    ("gaussian", 10, 16, 8, 2, {}), ("mixture", 1, 7, 3, 3, {}),
    ("gaussian", 4, 9, 129, 4, {}),
    ("mixture", 6, 12, 8, 5, {"jump_gen": 2, "p_snooker": 1.0}),
    ("gaussian", 2, 3, 240, 11, {})],
    ids=["mixture-a", "mixture-b", "gaussian", "ragged", "wide",
         "all-snooker", "d240"])
def test_plain_matches_pallas_interpret_kernel_rng(kind, G, n, d, seed,
                                                   op_kw):
    (jx, jl, ja), (x, l, acc), scal = _both(kind, G, n, d, seed, **op_kw)
    assert x.shape == (G, n, d) and acc.dtype == np.bool_
    np.testing.assert_array_equal(acc, ja)
    np.testing.assert_allclose(x, jx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l, jl, rtol=RTOL, atol=ATOL)
    assert 0 < acc.sum() < acc.size
    snk = scal[..., 3] > 0.5
    if G > 1 and op_kw.get("p_snooker") is None:
        assert snk.any() and (~snk).any()
    if op_kw.get("p_snooker") == 1.0:
        assert snk.all()


def test_nonfinite_proposal_is_rejected_like_the_reference():
    (jx, jl, ja), (x, l, acc), _ = _both("mixture", 5, 8, 4, 6,
                                         nonfinite=True, jump_gen=-1)
    np.testing.assert_array_equal(acc, ja)
    assert not acc[2, 4] and np.all(np.isfinite(x))
    np.testing.assert_allclose(x, jx, rtol=RTOL, atol=ATOL)


def test_wrapper_and_dispatch_raise_for_what_they_do_not_take():
    G, n, d = 3, 4, 2
    x0, rows, scal, bits = _operands(G, n, d, 8)
    lp = _targets("mixture", d)[1]
    x0, rows, scal = (torch.from_numpy(a) for a in (x0, rows, scal))
    tb = tuple(torch.from_numpy(b.view(np.int32)) for b in bits)
    lp0 = lp(x0)
    kw = dict(d_true=d, rng="kernel", run_key=1, t0=0, **KW)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fused_chunk(x0, lp0, rows, None, None, None, scal, lp, **kw)
    meta = [a.to("meta") for a in (x0, lp0, rows, scal)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_chunk(*meta[:3], None, None, None, meta[3], lp, **kw)
    with pytest.raises(ValueError, match="test_bits\\[1\\] must be"):
        run_fused_chunk(x0, lp0, rows, None, None, None, scal, lp,
                        test_bits=(tb[0], tb[1][:, :2], tb[2]), **kw)
    with pytest.raises(ValueError, match="int32"):
        fused_chunk(*meta[:3], None, None, None, meta[3], lp,
                    test_bits=tuple(b.to("meta").float() for b in tb), **kw)
    with pytest.raises(ValueError, match="pass None"):
        run_fused_chunk(x0, lp0, rows, x0.expand(G, n, d), None, None, scal,
                        lp, **kw)
    with pytest.raises(ValueError, match="run_key and t0"):
        run_fused_chunk(x0, lp0, rows, None, None, None, scal, lp,
                        **{**kw, "run_key": None})
    with pytest.raises(ValueError, match="expected 'stream'"):
        run_fused_chunk(x0, lp0, rows, None, None, None, scal, lp,
                        **{**kw, "rng": "prng"})
    with pytest.raises(ValueError, match="expected 'stream'"):
        make_chunk_runner(lp, bt.samplers.dream.DreamConfig(8), rng="prng")


# ------------------------------------------------------------ distribution
def _moments(chains, accepted, means):
    """Per statistic (the mean and the second moment of each dimension,
    the share of samples nearest mode 1, the acceptance): its estimate
    and standard error. A statistic's SE is its sample sd over √ESS, the
    ESS from the port's ``effective_sample_size`` of that statistic's
    chains; the acceptance's SE is the spread of the chains' rates over
    √(chains)."""
    feats = {"mean": chains, "second": chains ** 2,
             "mode1": (nearest_mode(chains, means) == 1)[..., None] * 1.0}
    out = {}
    for name, f in feats.items():
        flat = f.reshape(-1, f.shape[-1])
        ess = np.array([effective_sample_size(f[..., j:j + 1])
                        for j in range(f.shape[-1])])
        out[name] = (flat.mean(0), flat.std(0) / np.sqrt(ess))
    per_chain = accepted.mean(0)                       # [n_chains]
    out["acceptance"] = (np.array([per_chain.mean()]),
                         np.array([per_chain.std() / np.sqrt(
                             per_chain.size)]))
    return out


def test_kernel_rng_distribution_matches_jax_stream_words_and_truth():
    """The port's ``DreamZs(fused=True, fused_rng="kernel")`` on the CPU
    (Philox draws in the fused chunks) against the JAX package's
    ``DreamZs(fused=False)`` (threefry stream words), on one target: a
    two-mode ``gaussian_mixture`` in d = 4, modes at ±1.5 on the first
    axis, σ = 1; 16 chains, 4,000 generations, burn-in 500, the last
    3,000 kept. Truth: mean 0, second moment 3.25 on the first axis and
    1 on the others, half the samples nearest each mode.

    Bands, from each run's ESS (per statistic, the port's
    ``effective_sample_size``; ~3,000 of the 48,000 kept draws): each
    run within 4 SE of the truth, and the two runs within 4·√(SE₁² +
    SE₂²) of each other, for every dimension's mean and second moment,
    the mode-1 share and the acceptance (which has no closed form, so
    only the two runs are compared). Seeds are fixed; the readings when
    written were all within 2 SE.
    """
    d, n, gens, keep = 4, 16, 4000, 3000
    means = np.zeros((2, d), np.float32)
    means[0, 0], means[1, 0] = -1.5, 1.5
    x0 = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    port = bt.DreamZs(bt.gaussian_mixture(means), n_chains=n, seed=1,
                      burnin_gens=500, archive_capacity=8192, fused=True,
                      fused_rng="kernel", device="cpu")
    port.run_mcmc(gens, x0)
    ref = bp.DreamZs(jtargets.gaussian_mixture(means), n_chains=n, seed=1,
                     burnin_gens=500, archive_capacity=8192)
    ref.run_mcmc(gens, jnp.asarray(x0))
    p = _moments(port.get_chain(discard=gens - keep),
                 np.asarray(port._history["accepted"][gens - keep:]), means)
    j = _moments(np.asarray(ref.get_chain(discard=gens - keep)),
                 np.asarray(ref._history["accepted"][gens - keep:]), means)
    truth = {"mean": np.zeros(d), "second": np.array([3.25, 1.0, 1.0, 1.0]),
             "mode1": np.array([0.5])}
    for name in p:
        (mp, sp), (mj, sj) = p[name], j[name]
        assert np.all(np.abs(mp - mj) < 4 * np.hypot(sp, sj)), (name, mp, mj)
        if name in truth:
            assert np.all(np.abs(mp - truth[name]) < 4 * sp), (name, mp)
            assert np.all(np.abs(mj - truth[name]) < 4 * sj), (name, mj)
    assert 0.2 < p["acceptance"][0][0] < 0.5


# ---------------------------------------------------------------- the API
def test_run_mcmc_kernel_rng_shapes_and_finiteness():
    d, n = 6, 8
    s = _sampler(d, n)
    s.run_mcmc(103, _x0(n, d, 2))
    s.run_mcmc(50)
    h = s._history
    assert h["x"].shape == (153, n, d) and h["accepted"].shape == (153, n)
    assert np.all(np.isfinite(h["x"])) and np.all(np.isfinite(h["logp"]))
    assert s.get_chain().shape == (n, 153, d)
    assert 0.05 < float(np.mean(s.acceptance_fraction)) < 0.9
    assert s.final_state.gen == 153


def test_run_mcmc_until_kernel_rng_reaches_the_stop():
    d, n = 4, 16
    s = bt.DreamZs(bt.gaussian_mixture(np.zeros((1, d), np.float32)),
                   n_chains=n, seed=9, archive_thin=5, burnin_gens=20,
                   archive_capacity=256, fused=True, fused_rng="kernel",
                   device="cpu")
    info = s.run_mcmc_until(_x0(n, d, 4), rhat_tol=1.2, chunk=20,
                            max_chunks=40, warmup_chunks=2)
    steps = int(info["steps"])
    assert 20 < steps < 800 and steps % 20 == 0
    assert np.max(info["rhat"]) < 1.2
    assert info["mean"].shape == (n, d) and np.all(np.isfinite(info["mean"]))
    assert bool(torch.all(torch.isfinite(s.final_state.logp)))


def test_collect_modes_agree_in_kernel_rng_mode():
    s = _sampler()
    s.run_mcmc(20, _x0(8, 6, 1))
    outs = {c: make_chunk_runner(s.log_like_fn, s.cfg, collect=c,
                                 rng="kernel")(
        _clone(s.final_state), s._words, 20, 20)
        for c in ("all", "stats", "rhat")}
    ref_state, hist = outs["all"]
    for c in ("stats", "rhat"):
        st, h = outs[c]
        assert "x" not in h and torch.equal(st.x, ref_state.x)
        for k in ("logp", "accepted", "snooker"):
            assert torch.equal(h[k], hist[k]), (c, k)
    assert outs["rhat"][1]["rhat"].n == 20.0


def test_fused_rng_kernel_is_ignored_without_fused():
    """``fused=False`` accepts ``fused_rng="kernel"`` and runs the
    per-generation engine unchanged, as the JAX package does."""
    lp = bt.gaussian_mixture(_mixture(4))
    kw = dict(n_chains=8, seed=3, burnin_gens=10, device="cpu")
    a = bt.DreamZs(lp, **kw)
    b = bt.DreamZs(lp, fused_rng="kernel", **kw)
    for s in (a, b):
        s.run_mcmc(30, _x0(8, 4, 5))
    np.testing.assert_array_equal(a._history["x"], b._history["x"])
