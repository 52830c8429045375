"""The port's CUDA kernels against their plain versions, on the card.

Tests marked ``cuda`` skip where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor the JAX package, so it also runs on a
machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up.) B3 must be
bit-equal to its plain version; B2 is held within x_star rtol 1e-5 /
atol 1e-6 and log_jac rtol 1e-5 / atol 1e-4 (tests/
test_torch_dream_proposal.py gives the reasons). B4 must take the same
accept decisions and stages as its plain version, with positions and
logp within rtol 1e-5 / atol 1e-6 (the kernel sums over d in another
order). B5 is held within atol 1e-3 of its plain version (tests/
test_gp.py's bound for the reference's kernel), B6 within L atol
5e-6·max|L| and z atol 1e-5·max|z| (tests/test_pallas_bchol.py's), with
NaN in the same matrices and L bit-equal between its two entry points.
On config 4's Gram matrices, where both float32 routes stand ~cond·ε
from a float64 factor, B6 is held to that factor: within 1.5 x the plain
version's distance from it, and within 1e-5 (L) and 1e-4 (z), per matrix
relative to its max, of it and of the plain version (chip_smoke.py's
GRAM_TOL). B1 must take the same accept decisions as its plain version,
except a bit the plain version puts within 1e-4 of its threshold, with x
within rtol 1e-5 / atol 1e-5 and logp within rtol 1e-5 / atol 1e-4 (B2's
tolerances: |logp| reaches ~200 at d = 100), in kernel-RNG mode too,
against its plain version on the same Philox words and, fed stream
words as ``test_bits``, against stream mode. B7 is held within
5e-6·max|L| of its plain version on SPD
matrices (B6's bound), B8 within 1e-5·max|x| (two float32 substitutions
summing in other orders); their gradients, and B5's and B6's, within
1e-4 of the plain routes' (relative to the largest entry), autograd of
``cholesky_ex`` and ``solve_triangular`` on the card. B9 must take
its plain version's decisions, except a bit the plain version puts
within 1e-4 of its threshold (after which, as the walkers interact, no
later generation is compared), with x and logp within rtol 1e-5 / atol
1e-6 (B4's bound), on the route it chooses and on the global route
forced, the launch's own plan equal to ``ops/fused_stretch.plan``'s and
the two routes' outputs equal where both can run;
``EnsembleSampler(fused=True)`` must launch it once a chunk and take the
per-generation engine's decisions by the same rule.
B11 must be bit-equal to its plain version (a copy is a copy), in every
element type and for indices out of range, and ``DreamZs`` with
``fused_gather="kernel"`` and ``gather_kernel=True`` must launch it once
a generation and once a chunk and take the default route's decisions,
positions bit-equal. B10 must be bit-equal to its plain version (its ops
are exact), NaN and infinite edge rows included, and ``DreamZs`` with
``pallas_accept=True`` must launch it once a per-generation step and
never in a fused chunk, and take the default route's decisions,
positions bit-equal. The unmarked tests run everywhere: a tensor on a
device with no kernel raises rather than taking the plain version.
"""

import numpy as np
import pytest
import torch

import bipymc_tpu_torch as bt
from bipymc_tpu_torch.core.rng import draw_words
from bipymc_tpu_torch.ops.accept_select import (accept_select,
                                                accept_select_reference)
from bipymc_tpu_torch.ensemble.indices import distinct_from_bits
from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
from bipymc_tpu_torch.ops.dream_proposal import dream_propose, propose_plain
from bipymc_tpu_torch.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu_torch.ops.fused_chunk import (fused_chunk, fused_chunk_plain,
                                              kernel_rng_draws)
from bipymc_tpu_torch.ops.fused_rw_chunk import (fused_rw_chunk,
                                                 fused_rw_chunk_plain)
from bipymc_tpu_torch.ops.fused_stretch import (fused_stretch,
                                                fused_stretch_plain, plan)
from bipymc_tpu_torch.ops.gather_rows import (gather_rows,
                                              gather_rows_reference)
from bipymc_tpu_torch.ops.pallas_bchol import (cholesky_batched,
                                               cholesky_solve_batched,
                                               cholesky_solve_plain)
from bipymc_tpu_torch.ops.pallas_chol import cholesky_pallas, cholesky_plain
from bipymc_tpu_torch.ops.pallas_kernels import sqdist, sqdist_plain
from bipymc_tpu_torch.ops.pallas_solve import (solve_chol, tri_solve,
                                               tri_solve_plain, tri_solve_t,
                                               tri_solve_t_plain)
from bipymc_tpu_torch.samplers import dream, rw, stretch
from bipymc_tpu_torch.samplers.dream_fused import chunk_operands
from bipymc_tpu_torch.samplers.stretch_fused import chunk_words
from bipymc_tpu_torch.testing import (ACCEPT_FIELDS, accept_edge_groups,
                                      accept_operands, bit_equal,
                                      check_accept_edges, match_decisions,
                                      match_stretch_decisions,
                                      plain_log_alpha, stretch_log_alpha)

torch.set_num_threads(2)

KW = dict(n_pairs=3, b=1e-4, b_star=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _b3_operands(n_chains, k, n, seed):
    rng = np.random.default_rng(seed)
    block = rng.integers(0, 2 ** 32, (n_chains, k + 9), dtype=np.uint64)
    words = torch.from_numpy(block.astype(np.uint32).view(np.int32))
    exclude = torch.from_numpy((rng.permutation(n_chains) % n)
                               .astype(np.int32))
    return words[:, 5:5 + k], exclude


def _b2_operands(n, d, snooker, jump, ties, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    rows = x[:, None, :] + 2.0 * rng.normal(size=(n, 6, d))
    u_mask = rng.random((n, d))
    if ties:
        u_mask[:, ::2] = 0.0625
        u_mask[:, 1::2] = np.maximum(u_mask[:, 1::2], 0.5)
    u_e = rng.random((n, d))
    eps = rng.normal(size=(n, d))
    scal = np.stack([
        np.minimum(1 + np.floor(rng.random(n) * 3), 3),
        rng.integers(1, 4, n) / 3.0, 1.2 + rng.random(n),
        {"all": np.ones(n), "none": np.zeros(n),
         "mixed": (rng.random(n) < 0.5) * 1.0}[snooker],
        np.full(n, float(jump))], 1)
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, rows, u_mask, u_e, eps, scal)]


def test_meta_tensors_raise_instead_of_plain():
    words = torch.empty((4, 6), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        distinct_idx(words, 6, 100)
    ops = [a.to("meta") for a in _b2_operands(4, 3, "mixed", False, False,
                                              0)]
    with pytest.raises(ValueError, match="no kernel"):
        dream_propose(*ops, d_true=3, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chains,k,n,with_exclude", [
    (256, 6, 8192, False), (37, 3, 3, False), (37, 6, 7, False),
    (5, 6, 17, True), (33, 3, 4, True), (1000, 8, 40, True)])
def test_b3_kernel_matches_plain(cuda, n_chains, k, n, with_exclude):
    words, exclude = _b3_operands(n_chains, k, n, seed=n_chains + k)
    words = words.to(cuda)
    ex = exclude.to(cuda) if with_exclude else None
    before = distinct_idx.launches
    out = distinct_idx(words, k, n, ex)
    torch.cuda.synchronize()
    assert distinct_idx.launches == before + 1
    assert torch.equal(out, distinct_from_bits(words, k, n, ex))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,snooker,jump,ties", [
    (256, 100, "mixed", False, False), (256, 100, "mixed", True, False),
    (5, 1, "all", False, False), (32, 3, "none", True, True),
    (5, 129, "mixed", False, True), (32, 8, "all", True, False),
    (5, 300, "mixed", False, False)])
def test_b2_kernel_matches_plain(cuda, n, d, snooker, jump, ties):
    ops = [a.to(cuda) for a in _b2_operands(n, d, snooker, jump, ties, d)]
    before = dream_propose.launches
    x_star, log_jac = dream_propose(*ops, d_true=d, **KW)
    torch.cuda.synchronize()
    assert dream_propose.launches == before + 1
    ref_x, ref_j = propose_plain(*ops, d_true=d, **KW)
    torch.testing.assert_close(x_star, ref_x, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(log_jac, ref_j, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    words, _ = _b3_operands(8, 6, 100, 0)
    with pytest.raises(TypeError):
        distinct_idx(words.to(cuda).to(torch.int64), 6, 100)
    with pytest.raises(ValueError):
        distinct_idx(words.to(cuda).t().contiguous().t(), 6, 100)
    ops = [a.to(cuda) for a in _b2_operands(8, 4, "mixed", False, False, 0)]
    with pytest.raises(TypeError):
        dream_propose(ops[0].double(), *ops[1:], d_true=4, **KW)
    with pytest.raises(ValueError):
        dream_propose(*ops[:2], ops[2].t().contiguous().t(), *ops[3:],
                      d_true=4, **KW)


@pytest.mark.cuda
def test_step_on_card_matches_step_on_cpu(cuda):
    n, d = 32, 8
    means = bt.baseline_config3_means(d)
    cfg = dream.DreamConfig(n_chains=n, burnin_gens=20)
    lp = bt.gaussian_mixture(means)
    step = dream.make_step(lp, cfg)
    g = torch.Generator().manual_seed(0)
    x0 = bt.stratified_mode_init(g, means, n, device="cpu")
    z0 = bt.stratified_mode_init(g, means, 64, device="cpu")
    s_cpu = dream.init(x0, lp, cfg, 256, z0)
    s_gpu = dream.init(x0.to(cuda), lp, cfg, 256, z0.to(cuda))
    for t in range(40):
        words = draw_words(g, n, dream.n_words(cfg, d), "cpu")
        s_cpu, i_cpu = step(s_cpu, words, t)
        s_gpu, i_gpu = step(s_gpu, words.to(cuda), t)
        assert torch.equal(i_gpu.accepted.cpu(), i_cpu.accepted), t
    torch.testing.assert_close(s_gpu.x.cpu(), s_cpu.x, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_dreamzs_on_card_launches_both_kernels(cuda):
    means = bt.baseline_config3_means(8)
    s = bt.DreamZs(bt.gaussian_mixture(means), n_chains=32, seed=0,
                   burnin_gens=20, archive_capacity=256)
    b2, b3 = dream_propose.launches, distinct_idx.launches
    s.run_mcmc(50, bt.stratified_mode_init(
        torch.Generator(device=cuda).manual_seed(0), means, 32))
    assert dream_propose.launches - b2 == 50
    assert distinct_idx.launches - b3 == 50
    assert np.all(np.isfinite(s.get_chain()))
    with pytest.raises(ValueError, match="pallas_proposal"):
        bt.DreamZs(bt.gaussian_mixture(means), n_chains=32,
                   pallas_proposal=False).run_mcmc(5, np.zeros(8))


# ---- kernel B4: fused_rw_chunk ---------------------------------------------

def _b4_target(kind, d):
    rng = np.random.default_rng(d)
    if kind == "gaussian":
        a = rng.standard_normal((d, d))
        return bt.correlated_gaussian(rng.standard_normal(d),
                                      a @ a.T / d + np.eye(d))
    return bt.gaussian_mixture(2.0 * rng.standard_normal((4, d)))


def _b4_operands(n, d, K, seed, device):
    rng = np.random.default_rng(seed)
    isk = float(np.float32(1.0) / np.sqrt(np.float32(5.0)))
    step = 2.4 / np.sqrt(d)
    z1 = rng.standard_normal((K, n, d))
    z2 = rng.standard_normal((K, n, d))
    u = rng.uniform(1e-7, 1.0, (2, K, n))
    w = z1 - isk * z2
    scal = np.stack([np.sum(z1 ** 2, -1), np.sum(w ** 2, -1), np.log(u[0]),
                     np.log(u[1])], -1)
    x0 = rng.standard_normal((n, d))
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        device) for a in (x0, step * z1, isk * step * z2, scal)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,K", [(1, 2, 50), (4, 2, 20), (37, 129, 7),
                                   (256, 100, 50)])
@pytest.mark.parametrize("kind", ["gaussian", "mixture"])
@pytest.mark.parametrize("delayed", [False, True])
def test_b4_kernel_matches_plain(cuda, n, d, K, kind, delayed):
    lp = _b4_target(kind, d)
    x0, dy1, dy2, scal = _b4_operands(n, d, K, seed=n + d + K, device=cuda)
    lp0 = lp(x0)
    dy2 = dy2 if delayed else None
    before = fused_rw_chunk.launches
    out = fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, delayed)
    torch.cuda.synchronize()
    assert fused_rw_chunk.launches == before + 1
    ref = fused_rw_chunk_plain(x0, lp0, dy1, dy2, scal, lp, delayed)
    assert torch.equal(out[2], ref[2]) and torch.equal(out[3], ref[3])
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[1], ref[1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_b4_rejects_a_nonfinite_proposal(cuda):
    lp = _b4_target("gaussian", 2)
    x0, dy1, dy2, scal = _b4_operands(8, 2, 20, seed=3, device=cuda)
    dy1[5, 3] = torch.inf
    lp0 = lp(x0)
    out = fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, True)
    ref = fused_rw_chunk_plain(x0, lp0, dy1, dy2, scal, lp, True)
    torch.cuda.synchronize()
    assert torch.equal(out[3], ref[3]) and int(out[3][5, 3]) != 1
    assert bool(torch.all(torch.isfinite(out[0])))


@pytest.mark.cuda
def test_b4_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    lp = _b4_target("gaussian", 2)
    x0, dy1, dy2, scal = _b4_operands(4, 2, 5, seed=0, device=cuda)
    with pytest.raises(ValueError, match="kernel form"):
        fused_rw_chunk(x0, lp(x0), dy1, dy2, scal,
                       lambda x: -torch.sum(x ** 2, -1), True)
    with pytest.raises(TypeError):
        fused_rw_chunk(x0.double(), lp(x0).double(), dy1.double(),
                       dy2.double(), scal.double(), lp, True)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rw_chunk(x0, lp(x0), dy1.transpose(0, 1).contiguous()
                       .transpose(0, 1), dy2, scal, lp, True)


@pytest.mark.cuda
def test_dram_fused_on_card_launches_b4_once_per_chunk(cuda):
    lp = bt.correlated_gaussian([1.0, -1.0], [[2.0, 0.8], [0.8, 1.0]])
    s = bt.Dram(lp, seed=1, n_chains=4, fused=True, t0=60,
                adapt_interval=20)
    before = fused_rw_chunk.launches
    s.run_mcmc(130, np.zeros(2), cov_est=np.eye(2))     # 6 chunks + 10
    s.run_mcmc(130)                                      # 10 + 6 chunks
    assert fused_rw_chunk.launches - before == 12
    assert s.get_chain().shape == (4, 260, 2)
    assert np.all(np.isfinite(s.get_chain()))
    assert 0.2 < float(np.mean(s.acceptance_fraction)) < 0.95


@pytest.mark.cuda
def test_rw_step_on_card_matches_step_on_cpu(cuda):
    n, d, T = 8, 2, 100
    lp = bt.correlated_gaussian([1.0, -1.0], [[2.0, 0.8], [0.8, 1.0]])
    cfg = rw.dram_config(t0=40, adapt_interval=20)
    rng = np.random.default_rng(0)
    tables = [rng.standard_normal((T, n, d)), rng.standard_normal((T, n, d)),
              rng.uniform(1e-7, 1, (T, n)), rng.uniform(1e-7, 1, (T, n))]
    tables = [torch.from_numpy(a.astype(np.float32)) for a in tables]
    on = {dev: [a.to(dev) for a in tables] for dev in ("cpu", cuda)}
    states, steps = {}, {}
    for dev in ("cpu", cuda):
        steps[dev] = rw.make_step(lp, cfg, draws_fn=lambda w, ts, d_, dt,
                                  _t=on[dev]: tuple(a[ts] for a in _t))
        states[dev] = rw.init(torch.zeros((n, d), device=dev), lp,
                              torch.eye(2, device=dev))
    for t in range(T):
        infos = {}
        for dev in ("cpu", cuda):
            states[dev], infos[dev] = steps[dev](states[dev], None, t)
        assert torch.equal(infos[cuda].accepted.cpu(),
                           infos["cpu"].accepted), t
    torch.testing.assert_close(states[cuda].theta.cpu(), states["cpu"].theta,
                               rtol=1e-5, atol=1e-5)


# ---- kernel B1: fused_chunk ------------------------------------------------

def _b1_target(kind, d):
    rng = np.random.default_rng(d)
    if kind == "gaussian":
        a = rng.standard_normal((d, d))
        return bt.correlated_gaussian(rng.standard_normal(d),
                                      a @ a.T / d + np.eye(d))
    return bt.gaussian_mixture(2.0 * rng.standard_normal((4, d)))


def _b1_operands(G, n, d, seed, device):
    """x0, rows, u_mask, u_e, eps, scal as the fused runner builds them;
    u_mask and u_e are slices of a wider uniform block (row stride 2d+4),
    as the runner passes them."""
    rng = np.random.default_rng(seed)
    x0 = 2.0 * rng.standard_normal((n, d))
    rows = x0[None, :, None, :] + 2.0 * rng.standard_normal((G, n, 6, d))
    block = rng.random((G, n, 2 * d + 4))
    eps = rng.standard_normal((G, n, d))
    jump = np.zeros((G, n))
    jump[G // 2] = 1.0
    scal = np.stack([
        np.minimum(1 + np.floor(rng.random((G, n)) * 3), 3),
        rng.integers(1, 4, (G, n)) / 3.0, 1.2 + rng.random((G, n)),
        (rng.random((G, n)) < 0.3) * 1.0, jump,
        np.log(rng.uniform(1e-7, 1.0, (G, n)))], -1)
    t = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        device) for a in (x0, rows, block, eps, scal)]
    return t[0], t[1], t[2][..., 4:4 + d], t[2][..., 4 + d:], t[3], t[4]


def _b1_both(lp, ops, d):
    x0, rows, u_mask, u_e, eps, scal = ops
    lp0 = lp(x0)
    before = fused_chunk.launches
    out = fused_chunk(x0, lp0, rows, u_mask, u_e, eps, scal, lp, d_true=d,
                      **KW)
    torch.cuda.synchronize()
    assert fused_chunk.launches == before + 1
    args = (x0, lp0, rows, u_mask, u_e, eps, scal, lp)
    ref = fused_chunk_plain(*args, d_true=d, **KW)
    return out, ref + (plain_log_alpha(*args, d_true=d, **KW),)


@pytest.mark.cuda
@pytest.mark.parametrize("G,n,d,kind", [
    (10, 256, 100, "mixture"), (1, 7, 3, "mixture"), (1, 7, 3, "gaussian"),
    (10, 37, 129, "gaussian"), (5, 32, 8, "mixture")])
def test_b1_kernel_matches_plain(cuda, G, n, d, kind):
    """Config 3's shape [10, 256, 6, 100] and ragged ones: the same
    accept bits, except where the plain version's |log u − log α| < 1e-4
    (that chain then left out), x and logp within B2's tolerances."""
    lp = _b1_target(kind, d)
    ops = _b1_operands(G, n, d, seed=G + n + d, device=cuda)
    out, ref = _b1_both(lp, ops, d)
    kept, _ = match_decisions(out[2], ref[2],
                              (ops[5][..., 5] - ref[3]).abs())
    assert bool(kept[0].all())
    torch.testing.assert_close(out[0][kept], ref[0][kept], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out[1][kept], ref[1][kept], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_b1_rejects_a_nonfinite_proposal(cuda):
    lp = _b1_target("mixture", 4)
    ops = _b1_operands(5, 8, 4, seed=3, device=cuda)
    ops[1][2, 3] = torch.inf
    out, ref = _b1_both(lp, ops, 4)
    assert torch.equal(out[2], ref[2]) and not bool(out[2][2, 3])
    assert bool(torch.all(torch.isfinite(out[0])))


@pytest.mark.cuda
def test_b1_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    lp = _b1_target("mixture", 4)
    x0, rows, u_mask, u_e, eps, scal = _b1_operands(3, 4, 4, 0, cuda)
    args = [x0, lp(x0), rows, u_mask, u_e, eps, scal]
    with pytest.raises(ValueError, match="kernel form"):
        fused_chunk(*args, lambda x: -torch.sum(x ** 2, -1), d_true=4, **KW)
    with pytest.raises(ValueError, match="float32"):
        fused_chunk(*[a.double() for a in args], lp, d_true=4, **KW)
    with pytest.raises(ValueError, match="contiguous"):
        fused_chunk(*args[:2], rows.transpose(0, 1).contiguous()
                    .transpose(0, 1), *args[3:], lp, d_true=4, **KW)
    with pytest.raises(ValueError, match="unit stride"):
        fused_chunk(*args[:3], u_mask.transpose(0, 1).contiguous()
                    .transpose(0, 1), *args[4:], lp, d_true=4, **KW)


@pytest.mark.cuda
def test_dreamzs_fused_on_card_matches_per_generation_engine(cuda):
    """``DreamZs(fused=True)`` against ``fused=False`` on the card, the
    same seed, 60 generations after a burn-in of 100: B1 once a chunk,
    B2 only through burn-in, and the same decisions, except a bit the
    plain version puts within 1e-4 of its threshold (after it, that
    chunk's later generations of the chain and every later chunk are left
    out)."""
    n, d, burnin, gens = 64, 20, 100, 60
    means = bt.baseline_config3_means(d)
    theta0 = bt.stratified_mode_init(
        torch.Generator(device=cuda).manual_seed(0), means, n, device=cuda)
    kw = dict(n_chains=n, seed=0, burnin_gens=burnin, archive_capacity=2048,
              device=cuda)
    ref = bt.DreamZs(bt.gaussian_mixture(means), **kw)
    fus = bt.DreamZs(bt.gaussian_mixture(means), fused=True, **kw)
    ref.run_mcmc(burnin + gens, theta0)
    b1, b2 = fused_chunk.launches, dream_propose.launches
    fus.run_mcmc(burnin + gens, theta0)
    assert fused_chunk.launches - b1 == gens // 10
    assert dream_propose.launches - b2 == burnin
    rh, fh = ref._history, fus._history
    assert np.array_equal(rh["accepted"][:burnin], fh["accepted"][:burnin])
    for c in range(burnin, burnin + gens, 10):
        ra, fa = rh["accepted"][c:c + 10], fh["accepted"][c:c + 10]
        assert np.array_equal(rh["snooker"][c:c + 10],
                              fh["snooker"][c:c + 10])
        if np.array_equal(ra, fa):
            np.testing.assert_allclose(fh["x"][c:c + 10], rh["x"][c:c + 10],
                                       rtol=1e-5, atol=1e-4)
            continue
        # the chunk's log α from the plain version, at the state the
        # per-generation engine reached
        s = bt.DreamZs(bt.gaussian_mixture(means), **kw)
        s.run_mcmc(c, theta0)
        ops = chunk_operands(s.final_state, s._words, c, s.cfg)
        ref_la = plain_log_alpha(
            s.final_state.x, s.final_state.logp, *ops, s.log_like_fn,
            d_true=d, **KW)
        match_decisions(torch.from_numpy(fa), torch.from_numpy(ra),
                        (ops[4][..., 5] - ref_la).abs().cpu())
        break
    assert np.all(np.isfinite(fh["x"])) and 0 < fh["accepted"].mean() < 1


KEY = 0x0123456789ABCDEF
KEY_HI = 0xF123456789ABCDEF      # top bit set: a key ≥ 2⁶³ through uint64


def _b1_kernel_rng_both(lp, x0, rows, scal, d, t0=500, test_bits=None,
                        key=KEY):
    """Kernel-RNG B1 and its plain version (the same words) on one
    operand set: (kernel outputs, plain outputs, plain log α)."""
    G, n = scal.shape[:2]
    lp0 = lp(x0)
    before = (fused_chunk.launches, fused_chunk.kernel_rng_launches)
    out = fused_chunk(x0, lp0, rows, None, None, None, scal, lp, d_true=d,
                      rng="kernel", run_key=key, t0=t0, test_bits=test_bits,
                      **KW)
    torch.cuda.synchronize()
    assert (fused_chunk.launches, fused_chunk.kernel_rng_launches) == (
        before[0] + 1, before[1] + 1)
    draws = kernel_rng_draws(key, t0, G, n, d, x0.device, test_bits)
    args = (x0, lp0, rows, *draws, scal, lp)
    return (out, fused_chunk_plain(*args, d_true=d, **KW),
            plain_log_alpha(*args, d_true=d, **KW))


def _b1_hold(out, ref, ref_la, scal):
    kept, _ = match_decisions(out[2], ref[2], (scal[..., 5] - ref_la).abs())
    assert bool(kept[0].all())
    torch.testing.assert_close(out[0][kept], ref[0][kept], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out[1][kept], ref[1][kept], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("G,n,d,kind,key", [
    (10, 256, 100, "mixture", KEY), (10, 256, 100, "mixture", KEY_HI),
    (1, 7, 3, "mixture", KEY_HI), (1, 7, 3, "gaussian", KEY_HI),
    (10, 37, 129, "gaussian", KEY_HI)])
def test_b1_kernel_rng_matches_plain(cuda, G, n, d, kind, key):
    """Kernel-RNG B1 at config 3's shape and the ragged ones of phase 2e
    against its plain version on the same Philox words (B1's
    tolerances), under run keys below and above 2⁶³."""
    lp = _b1_target(kind, d)
    x0, rows, _, _, _, scal = _b1_operands(G, n, d, seed=G + n + d,
                                           device=cuda)
    out, ref, ref_la = _b1_kernel_rng_both(lp, x0, rows, scal, d, key=key)
    _b1_hold(out, ref, ref_la, scal)
    assert 0 < int(out[2].sum()) < out[2].numel() or G == 1


@pytest.mark.cuda
def test_b1_kernel_rng_on_stream_words_takes_stream_decisions(cuda):
    """Fed words as ``test_bits``, kernel-RNG B1 against stream-mode B1
    on the same words converted by ``bits_to_uniform`` and
    ``uniform_to_normal``: the same decisions (a bit excused only where
    the plain version's |log u − log α| < 1e-4)."""
    G, n, d = 10, 256, 100
    lp = _b1_target("mixture", d)
    x0, rows, _, _, _, scal = _b1_operands(G, n, d, seed=11, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    tb = tuple(torch.randint(-2 ** 31, 2 ** 31, (G, n, d), generator=g,
                             device=cuda, dtype=torch.int32)
               for _ in range(3))
    out, ref, ref_la = _b1_kernel_rng_both(lp, x0, rows, scal, d,
                                           test_bits=tb)
    _b1_hold(out, ref, ref_la, scal)
    stream = fused_chunk(x0, lp(x0), rows, bits_to_uniform(tb[0]),
                         bits_to_uniform(tb[1]),
                         uniform_to_normal(bits_to_uniform(tb[2])), scal, lp,
                         d_true=d, **KW)
    kept, _ = match_decisions(out[2], stream[2],
                              (scal[..., 5] - ref_la).abs())
    torch.testing.assert_close(out[0][kept], stream[0][kept], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_b1_kernel_rng_rejects_a_nonfinite_proposal(cuda):
    lp = _b1_target("mixture", 4)
    x0, rows, _, _, _, scal = _b1_operands(5, 8, 4, seed=3, device=cuda)
    rows[2, 3] = torch.inf
    out, ref, _ = _b1_kernel_rng_both(lp, x0, rows, scal, 4)
    assert torch.equal(out[2], ref[2]) and not bool(out[2][2, 3])
    assert bool(torch.all(torch.isfinite(out[0])))


@pytest.mark.cuda
def test_b1_kernel_rng_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    lp = _b1_target("mixture", 4)
    x0, rows, _, _, _, scal = _b1_operands(3, 4, 4, 0, cuda)
    kw = dict(d_true=4, rng="kernel", run_key=KEY, t0=0, **KW)
    args = [x0, lp(x0), rows, None, None, None, scal, lp]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fused_chunk(*[a.cpu() if isinstance(a, torch.Tensor) else a
                      for a in args], **kw)
    tb = [torch.zeros((3, 4, 4), dtype=torch.int32, device=cuda)
          for _ in range(3)]
    with pytest.raises(ValueError, match="test_bits\\[2\\] must be"):
        fused_chunk(*args, test_bits=(tb[0], tb[1], tb[2][:, :3]), **kw)
    with pytest.raises(ValueError, match="int32"):
        fused_chunk(*args, test_bits=(tb[0], tb[1], tb[2].float()), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused_chunk(*args, test_bits=(
            tb[0], tb[1].transpose(1, 2).contiguous().transpose(1, 2),
            tb[2]), **kw)


@pytest.mark.cuda
def test_dreamzs_kernel_rng_on_card_launches_only_kernel_mode_b1(cuda):
    """``DreamZs(fused=True, fused_rng="kernel")`` on the card: after
    burn-in every chunk is one kernel-RNG launch of B1 and none in
    stream mode, B2 only through burn-in; the R̂ stop also runs
    kernel-RNG chunks."""
    n, d, burnin, gens = 64, 20, 100, 60
    means = bt.baseline_config3_means(d)
    theta0 = bt.stratified_mode_init(
        torch.Generator(device=cuda).manual_seed(0), means, n, device=cuda)
    s = bt.DreamZs(bt.gaussian_mixture(means), n_chains=n, seed=0,
                   burnin_gens=burnin, archive_capacity=2048, fused=True,
                   fused_rng="kernel", device=cuda)
    b1, k1, b2 = (fused_chunk.launches, fused_chunk.kernel_rng_launches,
                  dream_propose.launches)
    s.run_mcmc(burnin + gens, theta0)
    assert fused_chunk.launches - b1 == gens // 10
    assert fused_chunk.kernel_rng_launches - k1 == gens // 10
    assert dream_propose.launches - b2 == burnin
    h = s._history
    assert np.all(np.isfinite(h["x"])) and 0 < h["accepted"].mean() < 1
    b1, k1 = fused_chunk.launches, fused_chunk.kernel_rng_launches
    info = s.reset().run_mcmc_until(theta0, rhat_tol=1.5, chunk=50,
                                    max_chunks=20, warmup_chunks=2)
    n_chunks = (int(info["steps"]) - burnin) // 10
    assert n_chunks > 0
    assert fused_chunk.launches - b1 == fused_chunk.kernel_rng_launches - \
        k1 == n_chunks


# ---- kernels B5 and B6: sqdist and the batched Cholesky --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("c,n,m,k", [(64, 512, 512, 2), (1, 130, 140, 5),
                                     (3, 17, 9, 4), (2, 1000, 200, 33),
                                     (2, 70, 129, 2), (3, 50, 130, 8),
                                     (1, 33, 131, 9), (2, 64, 256, 8),
                                     (2, 100, 260, 9)])
def test_b5_kernel_matches_plain(cuda, c, n, m, k):
    rng = np.random.default_rng(n + m + k)
    A = torch.from_numpy(3 * rng.standard_normal((c, n, k)).astype(
        np.float32)).to(cuda)
    B = torch.from_numpy(3 * rng.standard_normal((c, m, k)).astype(
        np.float32)).to(cuda)
    before = sqdist.launches
    out = sqdist(A, B)
    one = sqdist(A[0], B[0])
    torch.cuda.synchronize()
    assert sqdist.launches == before + 2
    ref = sqdist_plain(A, B)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-3)
    torch.testing.assert_close(one, ref[0], rtol=0, atol=1e-3)
    assert bool(torch.all(out >= 0))


def _spd(b, n, seed):
    x = np.random.default_rng(seed).standard_normal((b, n, 24))
    a = x @ np.swapaxes(x, -1, -2) / 24 + 3 * np.eye(n)
    y = np.random.default_rng(seed + 1).standard_normal((b, n))
    return [torch.from_numpy(v.astype(np.float32)) for v in (a, y)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(64, 512), (3, 64), (5, 200), (12, 256),
                                 (8, 1000), (2, 33)])
def test_b6_kernel_matches_plain(cuda, b, n):
    a, y = (v.to(cuda) for v in _spd(b, n, seed=n + b))
    before = cholesky_solve_batched.launches
    L, z = cholesky_solve_batched(a, y)
    L_only = cholesky_batched(a)
    torch.cuda.synchronize()
    assert cholesky_solve_batched.launches == before + 2
    L_ref, z_ref = cholesky_solve_plain(a, y)
    assert torch.equal(L, L_only)
    torch.testing.assert_close(L, L_ref, rtol=0,
                               atol=5e-6 * float(L_ref.abs().max()))
    torch.testing.assert_close(z, z_ref, rtol=0,
                               atol=1e-5 * float(z_ref.abs().max()))
    assert bool(torch.all(torch.triu(L, 1) == 0))


@pytest.mark.cuda
def test_b6_on_config4_gram_matrices_is_as_close_to_float64_as_plain(cuda):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(-4, 4, (512, 2)).astype(
        np.float32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((64, 512)).astype(
        np.float32)).to(cuda)
    theta = (np.linspace(0, 1, 64)[:, None] * [-0.18, 0.45, -0.26, -1.57]
             + 0.3 * rng.standard_normal((64, 4)))
    t = torch.from_numpy(theta.astype(np.float32)).to(cuda)
    a = bt.GpRegressor()._gram({"log_lengthscale": t[:, :2],
                                "log_sigma_f": t[:, 2],
                                "log_sigma_n": t[:, 3]}, x)
    L64 = torch.linalg.cholesky(a.double())
    z64 = torch.linalg.solve_triangular(L64, y.double()[..., None],
                                        upper=False)[..., 0]

    def rel(u, v):
        u, v = u.double().flatten(1), v.double().flatten(1)
        return float(((u - v).abs().amax(1) / v.abs().amax(1)).max())

    L, z = cholesky_solve_batched(a, y)
    L_p, z_p = cholesky_solve_plain(a, y)
    assert rel(L, L64) <= 1.5 * rel(L_p, L64)
    assert rel(z, z64) <= 1.5 * rel(z_p, z64)
    assert max(rel(L, L64), rel(L, L_p)) <= 1e-5
    assert max(rel(z, z64), rel(z, z_p)) <= 1e-4


@pytest.mark.cuda
def test_b6_non_positive_definite_matrices_are_nan(cuda):
    a, y = (v.to(cuda) for v in _spd(8, 128, seed=3))
    a[2] -= 10.0 * torch.eye(128, device=cuda)
    a[5, 64, 64] = -1.0
    L, z = cholesky_solve_batched(a, y)
    L_ref, _ = cholesky_solve_plain(a, y)
    torch.cuda.synchronize()
    bad = [j in (2, 5) for j in range(8)]
    assert torch.isnan(L).flatten(1).all(1).tolist() == bad
    assert torch.isnan(z).all(1).tolist() == bad
    assert torch.isnan(L_ref).flatten(1).all(1).tolist() == bad
    assert bool(torch.isfinite(L[[0, 1, 3, 4, 6, 7]]).all())


@pytest.mark.cuda
def test_b5_b6_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """Types and sizes the kernels do not take raise; a tensor that
    requires grad, once refused, now goes through the kernels' autograd
    Functions."""
    A = torch.zeros((2, 8, 3), device=cuda, requires_grad=True)
    assert type(sqdist(A, A).grad_fn).__name__ == "_SqdistBackward"
    with pytest.raises(TypeError):
        sqdist(A.detach().double(), A.detach().double())
    a, y = (v.to(cuda) for v in _spd(2, 16, seed=0))
    assert type(cholesky_batched(a.requires_grad_()).grad_fn).__name__ == \
        "CholeskyBackward"
    with pytest.raises(TypeError):
        cholesky_solve_batched(a.detach().double(), y.double())
    with pytest.raises(ValueError, match="n <="):
        cholesky_batched(torch.zeros((1, 1601, 1601), device=cuda))


def _rel(u, v):
    return float((u - v).abs().max() / v.abs().max())


@pytest.mark.cuda
def test_b5_b6_gradients_match_plain_routes(cuda):
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.standard_normal((2, 150, 2)).astype(
        np.float32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal((2, 150, 150)).astype(
        np.float32)).to(cuda)
    grads = []
    for fn in (sqdist, sqdist_plain):
        a = A.clone().requires_grad_(True)
        torch.sum(g * fn(a, a)).backward()
        grads.append(a.grad)
    assert _rel(*grads) <= 1e-4
    a, y = (v.to(cuda) for v in _spd(4, 100, seed=5))
    lbar = torch.from_numpy(rng.standard_normal((4, 100, 100)).astype(
        np.float32)).to(cuda)
    out = []
    for fn in (cholesky_solve_batched, cholesky_solve_plain):
        aa, yy = a.clone().requires_grad_(True), y.clone().requires_grad_(
            True)
        L, z = fn(aa, yy)
        torch.autograd.backward([L, z], [lbar, yy.detach()])
        out.append((aa.grad, yy.grad))
    assert _rel(out[0][0], out[1][0]) <= 1e-4
    assert _rel(out[0][1], out[1][1]) <= 1e-4


# n at a tile's edges, at the cluster route's last n (480) and the
# cooperative route's first, 512, 1000, 1024; batches of several clusters
@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(None, 256), (None, 4), (None, 33),
                                 (None, 200), (None, 1000), (5, 130),
                                 (None, 1), (None, 31), (None, 32),
                                 (None, 255), (None, 257), (None, 480),
                                 (None, 481), (None, 512), (None, 1024),
                                 (4, 256), (3, 300)])
def test_b7_kernel_matches_plain(cuda, b, n):
    a, _ = (v.to(cuda) for v in _spd(b or 1, n, seed=n))
    a = a if b else a[0]
    before = cholesky_pallas.launches
    L = cholesky_pallas(a)
    torch.cuda.synchronize()
    assert cholesky_pallas.launches == before + 1
    ref = cholesky_plain(a)
    torch.testing.assert_close(L, ref, rtol=0,
                               atol=5e-6 * float(ref.abs().max()))
    assert bool(torch.all(torch.triu(L, 1) == 0))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 130])
def test_b7_cooperative_route_matches_plain(cuda, n):
    """The cooperative kernel, the route above n = 480, forced at n <= 480
    (as chip_smoke.py times it beside the cluster route)."""
    from bipymc_tpu_torch.ops.pallas_chol import _chol_kernel

    a, _ = (v.to(cuda) for v in _spd(2, n, seed=n))
    L = _chol_kernel(a, "cooperative")
    torch.cuda.synchronize()
    ref = cholesky_plain(a)
    torch.testing.assert_close(L, ref, rtol=0,
                               atol=5e-6 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="no 'cluster' route"):
        _chol_kernel(_spd(1, 481, seed=1)[0].to(cuda), "cluster")


@pytest.mark.cuda
def test_b7_non_pd_and_gradient(cuda):
    a, _ = (v.to(cuda) for v in _spd(4, 96, seed=1))
    a[2, 50, 50] = -3.0
    L = cholesky_pallas(a)
    torch.cuda.synchronize()
    assert torch.isnan(L).flatten(1).all(1).tolist() == [False, False, True,
                                                         False]
    w = torch.randn(96, 96, device=cuda)
    grads = []
    for fn in (cholesky_pallas, cholesky_plain):
        aa = a[0].clone().requires_grad_(True)
        torch.sum(w * fn(aa)).backward()
        grads.append(aa.grad)
    assert _rel(*grads) <= 1e-4


# n at a tile's edges, at the last n whose tiles all stay in shared
# memory (256) and past it, 1024 and the largest, 4096; m at the columns
# a block takes and past them; a batched and a shared L at each m
_B8_EDGES = [(None, n, (n,) + m) for n in (1, 31, 32, 33, 255, 256, 257,
                                          1024, 4096)
             for m in ((), (7,), (8,), (9,))]
_B8_EDGES += [(3, 256, (3, 256, m)) for m in (1, 7, 8, 9)]
_B8_EDGES += [(None, 256, (4, 256, m)) for m in (1, 7, 8, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,shape", [
    (None, 256, (256,)), (None, 256, (256, 1024)), (None, 4, (4, 9)),
    (None, 200, (200, 130)), (None, 1000, (1000, 17)), (3, 96, (3, 96)),
    (3, 96, (3, 96, 5)), (None, 70, (4, 70, 3))] + _B8_EDGES)
def test_b8_kernel_matches_plain(cuda, b, n, shape):
    a, _ = _spd(b or 1, n, seed=n)
    L = cholesky_plain(a.to(cuda))
    L = L if b else L[0]
    y = torch.from_numpy(np.random.default_rng(n).standard_normal(
        shape).astype(np.float32)).to(cuda)
    for fn, ref_fn in ((tri_solve, tri_solve_plain),
                       (tri_solve_t, tri_solve_t_plain)):
        before = tri_solve.launches
        out = fn(L, y)
        torch.cuda.synchronize()
        assert tri_solve.launches == before + 1
        ref = ref_fn(L, y)
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [None, 7])
def test_b8_gradients_match_plain_and_launch_the_other_kernel(cuda, m):
    a, _ = _spd(1, 200, seed=9)
    L0 = cholesky_plain(a.to(cuda))[0]
    rng = np.random.default_rng(1)
    shape = (200,) if m is None else (200, m)
    b0 = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda)
    grads = []
    for fn in (solve_chol, lambda l, v: tri_solve_t_plain(
            l, tri_solve_plain(l, v))):
        L, b = L0.clone().requires_grad_(True), b0.clone().requires_grad_(
            True)
        before = tri_solve.launches
        torch.sum(w * fn(L, b) ** 2).backward()
        grads.append((torch.tril(L.grad), b.grad, tri_solve.launches -
                      before))
    assert grads[0][2] == 4 and grads[1][2] == 0
    assert _rel(grads[0][0], grads[1][0]) <= 1e-4
    assert _rel(grads[0][1], grads[1][1]) <= 1e-4


@pytest.mark.cuda
def test_b7_b8_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        cholesky_pallas(torch.eye(8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="n <="):
        cholesky_pallas(torch.eye(1025, device=cuda))
    L = torch.eye(8, device=cuda)
    with pytest.raises(TypeError):
        tri_solve(L.double(), torch.ones(8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="B8 takes"):
        tri_solve(L, torch.ones(9, device=cuda))
    with pytest.raises(ValueError, match="no kernel"):
        tri_solve(L, torch.ones(8))


@pytest.mark.cuda
def test_optimize_on_card_launches_b7_b8_and_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    x = rng.uniform(-4, 4, (200, 2)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
         + rng.normal(0, 0.2, 200)).astype(np.float32)
    gp = bt.GpRegressor(pallas_chol=True, pallas_solve=True)
    b5, b7, b8 = sqdist.launches, cholesky_pallas.launches, tri_solve.launches
    p, lml = gp.optimize(x, y, steps=20)
    torch.cuda.synchronize()
    assert cholesky_pallas.launches - b7 == 21
    assert tri_solve.launches - b8 == 41
    assert sqdist.launches - b5 == 21
    ref_p, ref_l = bt.GpRegressor(device="cpu").optimize(x, y, steps=20)
    assert abs(float(lml) - float(ref_l)) <= 1e-4 * abs(float(ref_l))
    for k in p:
        torch.testing.assert_close(p[k].cpu(), ref_p[k], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_gp_lml_on_card_routes_to_b5_b6_and_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    x = rng.uniform(-4, 4, (256, 2)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
         + rng.normal(0, 0.2, 256)).astype(np.float32)
    theta = (np.array([-0.3, 0.2, -0.1, -1.0]) + rng.normal(
        0, 0.2, (8, 4))).astype(np.float32)

    def lml(device):
        gp = bt.GpRegressor(device=device)
        t = torch.from_numpy(theta).to(device)
        p = {"log_lengthscale": t[:, :2], "log_sigma_f": t[:, 2],
             "log_sigma_n": t[:, 3]}
        return gp._lml_impl(p, torch.from_numpy(x).to(device),
                            torch.from_numpy(y).to(device))

    b5, b6 = sqdist.launches, cholesky_solve_batched.launches
    on_card = lml(cuda)
    torch.cuda.synchronize()
    assert sqdist.launches - b5 == 1
    assert cholesky_solve_batched.launches - b6 == 1
    torch.testing.assert_close(on_card.cpu(), lml("cpu"), rtol=1e-4,
                               atol=0)


@pytest.mark.cuda
def test_dram_over_gp_on_card_launches_b5_b6_twice_a_step(cuda):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-4, 4, (128, 2)).astype(
        np.float32)).to(cuda)
    y = torch.sin(2 * x[:, 0]) * torch.cos(x[:, 1])
    gp = bt.GpRegressor()

    def log_post(theta):
        p = {"log_lengthscale": theta[:, :2], "log_sigma_f": theta[:, 2],
             "log_sigma_n": theta[:, 3]}
        return (gp._lml_impl(p, x, y)          # config 4's target: B6
                - 0.5 * torch.sum((theta / 2) ** 2, -1))

    s = bt.Dram(log_post, seed=1, n_chains=16)
    b5, b6 = sqdist.launches, cholesky_solve_batched.launches
    s.run_mcmc(30, np.zeros(4), cov_est=0.05 * np.eye(4))
    assert sqdist.launches - b5 == 61
    assert cholesky_solve_batched.launches - b6 == 61
    assert np.all(np.isfinite(s.get_chain()))
    assert bool(torch.all(torch.isfinite(s.final_state.logp)))


def _stretch_target(kind, d):
    rng = np.random.default_rng(d)
    if kind == "gaussian":
        a = rng.standard_normal((d, d))
        return bt.correlated_gaussian(rng.standard_normal(d),
                                      a @ a.T / d + np.eye(d))
    return bt.gaussian_mixture(2.0 * rng.standard_normal((4, d)))


def _b9_hold(lp, x0, j, z, log_u, route=None):
    """B9 against its plain version on one operand set; returns the
    kernel's outputs."""
    lp0 = lp(x0)
    before = fused_stretch.launches
    out = fused_stretch(x0, lp0, j, z, log_u, lp, x0.shape[0] // 2,
                        route=route)
    torch.cuda.synchronize()
    assert fused_stretch.launches == before + 1
    ref = fused_stretch_plain(x0, lp0, j, z, log_u, lp, x0.shape[0] // 2)
    ref_la = stretch_log_alpha(x0, lp0, j, z, log_u, lp)
    kept, _ = match_stretch_decisions(out[2], ref[2], (log_u - ref_la).abs())
    assert bool(kept[0].all())
    torch.testing.assert_close(out[0][kept], ref[0][kept], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(out[1][kept], ref[1][kept], rtol=1e-5,
                               atol=1e-6)
    return out


def _b9_operands(G, n, d, kind, dev):
    lp = _stretch_target("mixture" if kind == "mixture" else "gaussian", d)
    g = torch.Generator(device=dev).manual_seed(G + n + d)
    words = torch.randint(-2 ** 31, 2 ** 31, (G, n, 3), generator=g,
                          device=dev, dtype=torch.int32)
    j, z, log_u = stretch.convert_words(words, 2.0)
    if kind == "nonfinite":
        z[1, 0] = z[3, n - 1] = torch.inf
    x0 = 2.0 * torch.randn((n, d), generator=g, device=dev)
    return lp, x0, j, z, log_u


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "global"])
@pytest.mark.parametrize("G,n,d,kind", [(64, 256, 16, "gaussian"),
                                        (5, 18, 3, "mixture"),
                                        (6, 16, 4, "nonfinite"),
                                        (8, 1024, 16, "gaussian"),
                                        (4, 256, 100, "gaussian"),
                                        (4, 1024, 100, "mixture"),
                                        (4, 1024, 100, "gaussian")])
def test_b9_kernel_matches_plain(cuda, G, n, d, kind, route):
    """B9 on the route it chooses and on the global route forced, against
    its plain version; the launch's own plan equal to ``plan``'s."""
    lp, x0, j, z, log_u = _b9_operands(G, n, d, kind, cuda)
    out = _b9_hold(lp, x0, j, z, log_u, route)
    mixture = kind == "mixture"
    assert fused_stretch.last_plan == plan(n, d, int(mixture),
                                           4 if mixture else 0, route=route)
    assert fused_stretch.last_plan[0] == (
        "global" if route == "global" or n * d > 256 * 100 else "shared")
    if kind == "nonfinite":
        assert not bool(out[2][1, 0]) and not bool(out[2][3, n - 1])
    assert 0 < float(out[2].float().mean()) < 1


@pytest.mark.cuda
@pytest.mark.parametrize("G,n,d,kind", [(64, 256, 16, "gaussian"),
                                        (5, 18, 3, "mixture"),
                                        (8, 1024, 16, "gaussian"),
                                        (4, 256, 100, "mixture"),
                                        (4, 256, 100, "gaussian")])
def test_b9_routes_agree_bit_for_bit(cuda, G, n, d, kind):
    """Where the population fits shared memory, both routes run the same
    per-walker code with the same lanes a walker: equal outputs."""
    lp, x0, j, z, log_u = _b9_operands(G, n, d, kind, cuda)
    lp0 = lp(x0)
    outs = []
    for route in ("shared", "global"):
        outs.append(fused_stretch(x0, lp0, j, z, log_u, lp, n // 2,
                                  route=route))
        assert fused_stretch.last_plan[0] == route
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_b9_forced_shared_route_that_does_not_fit_raises(cuda):
    lp, x0, j, z, log_u = _b9_operands(2, 1024, 100, "mixture", cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_stretch(x0, lp(x0), j, z, log_u, lp, 512, route="shared")
    with pytest.raises(ValueError, match="route"):
        fused_stretch(x0, lp(x0), j, z, log_u, lp, 512, route="l2")


@pytest.mark.cuda
def test_b9_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    lp = _stretch_target("gaussian", 3)
    x0 = torch.randn((8, 3), device=cuda)
    j = torch.full((2, 8), 4, dtype=torch.int32, device=cuda)
    j[:, 4:] = 0
    z, log_u = torch.ones((2, 8), device=cuda), torch.zeros((2, 8),
                                                             device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_stretch(x0.double(), lp(x0).double(), j, z.double(),
                      log_u.double(), lp, 4)
    with pytest.raises(ValueError, match="kernel form"):
        fused_stretch(x0, lp(x0), j, z, log_u,
                      lambda x: -0.5 * (x * x).sum(-1), 4)
    with pytest.raises(ValueError, match="int32"):
        fused_stretch(x0, lp(x0), j.long(), z, log_u, lp, 4)
    # d = 240: the Gaussian's 57,840 constants alone fill shared memory,
    # which the entry point refuses before launching
    big = _stretch_target("gaussian", 240)
    xb = torch.randn((8, 240), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_stretch(xb, big(xb), j, z, log_u, big, 4)


@pytest.mark.cuda
def test_ensemble_fused_on_card_matches_per_generation_engine(cuda):
    """``EnsembleSampler(fused=True)`` against ``fused=False`` on the card,
    the same seed and start, 300 generations (four chunks of 64 and one of
    44): B9 once a chunk, and the same decisions, except a bit the
    per-generation engine puts within 1e-4 of its threshold (no later
    generation is then compared); positions equal before it."""
    n, d, gens = 64, 16, 300
    lp = _stretch_target("gaussian", d)
    x0 = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    ref = bt.EnsembleSampler(lp, n_chains=n, seed=2, device=cuda)
    fus = bt.EnsembleSampler(lp, n_chains=n, seed=2, fused=True,
                             device=cuda)
    ref.run_mcmc(gens, x0)
    before = fused_stretch.launches
    fus.run_mcmc(gens, x0)
    assert fused_stretch.launches - before == 5
    xt = torch.from_numpy(x0).to(cuda)
    ops = chunk_words(ref._words, 0, gens, n, d, 2.0, torch.float32, cuda)
    margin = (ops[2] - stretch_log_alpha(xt, lp(xt), *ops, lp)).abs()
    kept, _ = match_stretch_decisions(
        torch.from_numpy(fus._history["accepted"]),
        torch.from_numpy(ref._history["accepted"]), margin.cpu())
    g0 = int(kept[:, 0].sum())
    np.testing.assert_array_equal(fus._history["x"][:g0],
                                  ref._history["x"][:g0])
    assert np.all(np.isfinite(fus._history["x"]))
    info_r = ref.reset().run_mcmc_until(x0, rhat_tol=1.2, chunk=50)
    before = fused_stretch.launches
    info_f = fus.reset().run_mcmc_until(x0, rhat_tol=1.2, chunk=50)
    assert int(info_f["steps"]) == int(info_r["steps"])
    assert fused_stretch.launches - before == int(info_f["steps"]) // 50


# ---- kernel B11: gather_rows ------------------------------------------------

def _b11_operands(cap, d, shape, dtype, idx_dtype, lo, hi, seed, ld=None):
    """buf [cap, d] (a view of a [cap, ld] buffer where ``ld`` is given)
    and indices of ``shape`` uniform on [lo, hi)."""
    rng = np.random.default_rng(seed)
    full = rng.standard_normal((cap, ld or d)).astype(np.float32)
    buf = torch.from_numpy(full).to(dtype)[:, :d]
    idx = torch.from_numpy(rng.integers(lo, hi, shape)).to(idx_dtype)
    return buf, idx


def test_b11_meta_tensors_raise_instead_of_plain():
    buf = torch.empty((64, 100), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gather_rows(buf, torch.zeros(6, dtype=torch.int32, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,d,shape,dtype,idx_dtype,lo,hi,ld", [
    (8192, 100, (2560, 6), torch.float32, torch.int32, 0, 8192, None),
    (8192, 100, (256, 6), torch.float32, torch.int32, 0, 8192, None),
    (64, 100, (300,), torch.float32, torch.int32, 0, 4, None),
    (64, 12, (40,), torch.float32, torch.int32, -100, 200, None),
    (8192, 100, (256, 6), torch.float32, torch.int64, -5, 8200, None),
    (50, 1, (10, 16, 7), torch.float32, torch.int32, -2, 52, None),
    (50, 3, (37,), torch.float32, torch.int32, 0, 50, None),
    (50, 129, (4, 9), torch.float32, torch.int32, 0, 50, None),
    (512, 100, (10, 16, 7), torch.float64, torch.int32, -1, 513, None),
    (512, 100, (37,), torch.bfloat16, torch.int64, 0, 512, None),
    (512, 3, (37,), torch.bfloat16, torch.int32, 0, 512, None),
    (512, 100, (256, 6), torch.float32, torch.int32, 0, 512, 101),
    (512, 100, (0,), torch.float32, torch.int32, 0, 1, None)])
def test_b11_kernel_matches_plain(cuda, cap, d, shape, dtype, idx_dtype,
                                  lo, hi, ld):
    buf, idx = _b11_operands(cap, d, shape, dtype, idx_dtype, lo, hi,
                             seed=cap + d, ld=ld)
    buf, idx = buf.to(cuda), idx.to(cuda)
    before = gather_rows.launches
    out = gather_rows(buf, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + (idx.numel() > 0)
    assert out.shape == (*shape, d) and out.dtype == dtype
    assert torch.equal(out, gather_rows_reference(buf, idx))


@pytest.mark.cuda
def test_b11_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    buf, idx = _b11_operands(64, 100, (256, 6), torch.float32, torch.int32,
                             0, 64, 0)
    buf, idx = buf.to(cuda), idx.to(cuda)
    with pytest.raises(ValueError, match="idx on cpu"):
        gather_rows(buf, idx.cpu())
    with pytest.raises(ValueError, match="buf on cpu"):
        gather_rows(buf.cpu(), idx)
    with pytest.raises(ValueError, match="unit stride"):
        gather_rows(buf.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(buf, idx.t())
    with pytest.raises(TypeError):
        gather_rows(buf, idx.to(torch.int16))
    with pytest.raises(TypeError):
        gather_rows(buf.to(torch.int32), idx)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_rng", ["stream", "kernel"])
def test_dreamzs_gather_flags_on_card_take_default_decisions(cuda,
                                                             fused_rng):
    """``DreamZs(fused=True, fused_gather="kernel", gather_kernel=True)``
    on the card: B11 once a burn-in generation and once a chunk, and the
    default route's decisions and positions, bit for bit; the R̂ stop at
    the same generation."""
    n, d, burnin, gens = 64, 20, 100, 60
    means = bt.baseline_config3_means(d)
    theta0 = bt.stratified_mode_init(
        torch.Generator(device=cuda).manual_seed(0), means, n, device=cuda)
    kw = dict(n_chains=n, seed=0, burnin_gens=burnin, archive_capacity=2048,
              fused=True, fused_rng=fused_rng, device=cuda)
    ref = bt.DreamZs(bt.gaussian_mixture(means), **kw)
    before = gather_rows.launches
    ref.run_mcmc(burnin + gens, theta0)
    assert gather_rows.launches == before
    s = bt.DreamZs(bt.gaussian_mixture(means), fused_gather="kernel",
                   gather_kernel=True, **kw)
    s.run_mcmc(burnin + gens, theta0)
    assert gather_rows.launches - before == burnin + gens // 10
    for key in ("x", "logp", "accepted", "snooker"):
        np.testing.assert_array_equal(s._history[key], ref._history[key])
    info_r = ref.reset().run_mcmc_until(theta0, rhat_tol=1.5, chunk=50,
                                        max_chunks=20, warmup_chunks=2)
    before = gather_rows.launches
    info = s.reset().run_mcmc_until(theta0, rhat_tol=1.5, chunk=50,
                                    max_chunks=20, warmup_chunks=2)
    steps = int(info["steps"])
    assert steps == int(info_r["steps"])
    np.testing.assert_array_equal(info["rhat"], info_r["rhat"])
    assert gather_rows.launches - before == burnin + (steps - burnin) // 10


# ---- kernel B10: accept_select ----------------------------------------------

def _b10_operands(n, d, seed, edges, dtype, device):
    ops = accept_operands(n, d, seed, edges, dtype=dtype)
    return [torch.from_numpy(ops[k]).to(device) for k in ACCEPT_FIELDS]


def test_b10_meta_tensors_raise_instead_of_plain():
    ops = _b10_operands(8, 3, 0, (), np.float32, "meta")
    with pytest.raises(ValueError, match="no kernel"):
        accept_select(*ops)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,dtype", [
    (256, 100, np.float32), (1024, 100, np.float32), (4096, 100, np.float32),
    (1024, 2, np.float32), (200, 37, np.float32), (7, 129, np.float32),
    (1, 1, np.float32), (256, 100, np.float64)])
def test_b10_kernel_matches_plain(cuda, n, d, dtype):
    for i, edges in enumerate(accept_edge_groups(n)):
        ops = _b10_operands(n, d, n + d + i, edges, dtype, cuda)
        before = accept_select.launches
        out = accept_select(*ops)
        torch.cuda.synchronize()
        assert accept_select.launches == before + 1
        for name, a, b in zip(("x_new", "logp_new", "logp_sum_new",
                               "accepted"), out,
                              accept_select_reference(*ops)):
            assert bit_equal(a, b), (name, edges)
        check_accept_edges(out[3].cpu(), edges)


@pytest.mark.cuda
def test_b10_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, x_star, *vecs = _b10_operands(64, 100, 0, (), np.float32, cuda)
    with pytest.raises(ValueError, match="x_star on cpu"):
        accept_select(x, x_star.cpu(), *vecs)
    with pytest.raises(ValueError, match="logp on cpu"):
        accept_select(x, x_star, vecs[0].cpu(), *vecs[1:])
    with pytest.raises(TypeError, match="one dtype"):
        accept_select(x, x_star.double(), *vecs)
    with pytest.raises(TypeError, match="no kernel for dtype"):
        accept_select(*(t.half() for t in (x, x_star, *vecs)))
    with pytest.raises(ValueError, match="unit stride"):
        accept_select(x.t().contiguous().t(), x_star, *vecs)
    strided = torch.stack([vecs[3], vecs[3]], dim=1)[:, 0]
    with pytest.raises(ValueError, match="log_u must be contiguous"):
        accept_select(x, x_star, *vecs[:3], strided, vecs[4])
    # a row stride is taken: x a view of a [64, 101] buffer
    wide = torch.zeros((64, 101), device=cuda)
    wide[:, :100] = x
    out = accept_select(wide[:, :100], x_star, *vecs)
    for a, b in zip(out, accept_select_reference(x, x_star, *vecs)):
        assert bit_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_dreamzs_pallas_accept_on_card_takes_default_decisions(cuda, fused):
    """``DreamZs(pallas_accept=True)`` on the card: B10 once a
    per-generation step (every generation, or burn-in alone with
    ``fused=True, fused_rng="kernel"``, whose chunks run B1), and the
    default route's decisions and positions, bit for bit."""
    n, d, burnin, gens = 64, 20, 100, 60
    means = bt.baseline_config3_means(d)
    theta0 = bt.stratified_mode_init(
        torch.Generator(device=cuda).manual_seed(0), means, n, device=cuda)
    kw = dict(n_chains=n, seed=0, burnin_gens=burnin, archive_capacity=2048,
              device=cuda)
    if fused:
        kw.update(fused=True, fused_rng="kernel")
    ref = bt.DreamZs(bt.gaussian_mixture(means), **kw)
    before = accept_select.launches
    ref.run_mcmc(burnin + gens, theta0)
    assert accept_select.launches == before
    s = bt.DreamZs(bt.gaussian_mixture(means), pallas_accept=True, **kw)
    s.run_mcmc(burnin + gens, theta0)
    assert accept_select.launches - before == (burnin if fused
                                               else burnin + gens)
    for key in ("x", "logp", "accepted", "snooker"):
        np.testing.assert_array_equal(s._history[key], ref._history[key])
