"""The port's CUDA kernels against their plain versions, on the card.

Tests marked ``cuda`` skip where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor the JAX package, so it also runs on a
machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up.) B3 must be
bit-equal to its plain version; B2 is held within x_star rtol 1e-5 /
atol 1e-6 and log_jac rtol 1e-5 / atol 1e-4 (tests/
test_torch_dream_proposal.py gives the reasons). The unmarked tests run
everywhere: a tensor on a device with no kernel raises rather than
taking the plain version.
"""

import numpy as np
import pytest
import torch

import bipymc_tpu_torch as bt
from bipymc_tpu_torch.core.rng import draw_words
from bipymc_tpu_torch.ensemble.indices import distinct_from_bits
from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
from bipymc_tpu_torch.ops.dream_proposal import dream_propose, propose_plain
from bipymc_tpu_torch.samplers import dream

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
