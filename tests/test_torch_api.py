"""The port's public entry point, ``DreamZs``, on the CPU.

Statistical checks run a 4-d correlated Gaussian and hold the posterior
mean and variance inside Monte-Carlo bands. The rest pins the API
contract the JAX package has: R̂-stopped runs, ``reset()`` reruns,
continuation, the input probes, and ``NotImplementedError`` for what
the port lacks. The last tests read the port's sources: nothing in the
package or in ``chip_smoke.py`` imports JAX or the JAX package.
"""

import ast
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import bipymc_tpu_torch as bt
from bipymc_tpu_torch.samplers.dream import DreamConfig, make_step

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MEAN = np.array([1.0, -2.0, 0.5, 3.0])
COV = np.array([[1.0, 0.6, 0.0, 0.0],
                [0.6, 1.0, 0.0, 0.0],
                [0.0, 0.0, 2.0, -0.5],
                [0.0, 0.0, -0.5, 0.5]])


def _gaussian():
    prec = torch.tensor(np.linalg.inv(COV), dtype=torch.float32)
    mean = torch.tensor(MEAN, dtype=torch.float32)

    def log_prob(x):                                       # [n, 4] → [n]
        r = x - mean
        return -0.5 * torch.sum((r @ prec) * r, dim=-1)

    return log_prob


def _sampler(**kw):
    kw.setdefault("burnin_gens", 300)
    return bt.DreamZs(_gaussian(), n_chains=16, seed=3, device="cpu", **kw)


def test_posterior_moments_within_mc_bands():
    s = _sampler()
    s.run_mcmc(2500, np.zeros(4), spread=2.0)
    draws = s.get_chain(discard=500, flat=True)
    # 16 chains × 2000 draws, thinned by the autocorrelation: a few
    # hundred effective draws at the least; bands of ~5 standard errors
    se = np.sqrt(np.diag(COV) / 300.0)
    assert np.all(np.abs(draws.mean(0) - MEAN) < 5 * se)
    np.testing.assert_allclose(draws.var(0), np.diag(COV), rtol=0.25)
    acc = s.acceptance_fraction
    assert acc.shape == (16,) and 0.05 < acc.mean() < 0.9
    assert s.chain.shape == (2500, 4)
    assert 0.0 < np.mean(s._history["snooker"]) < 0.3


def test_run_until_stops_below_tolerance():
    s = _sampler()
    info = s.run_mcmc_until(np.zeros(4), rhat_tol=1.1, chunk=100,
                            max_chunks=40, warmup_chunks=3, spread=2.0)
    assert float(np.max(info["rhat"])) < 1.1
    assert int(info["steps"]) < 40 * 100 and int(info["steps"]) % 100 == 0
    assert info["mean"].shape == (16, 4) and info["var"].shape == (16, 4)
    assert s.final_state.gen == int(info["steps"])


def test_reset_reruns_identically_and_continuation_extends():
    s = _sampler(burnin_gens=20)
    a = s.run_mcmc(60, np.zeros(4)).get_chain()
    b = s.reset().run_mcmc(60, np.zeros(4)).get_chain()
    np.testing.assert_array_equal(a, b)
    s.run_mcmc(40)                              # continue silently
    assert s.get_chain().shape == (16, 100, 4)
    np.testing.assert_array_equal(s.get_chain()[:, :60], a)
    assert s.final_state.gen == 100
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s.run_mcmc(10, np.zeros(4))             # theta_0 is ignored
    assert any("IGNORED" in str(x.message) for x in w)


def test_step_with_explicit_words_is_deterministic():
    """The step is a pure function of (state, words): the same words
    give the same generation."""
    cfg = DreamConfig(n_chains=8, burnin_gens=5)
    step = make_step(_gaussian(), cfg)
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn((8, 4), generator=g)
    z0 = torch.randn((16, 4), generator=g)
    words = torch.randint(-2 ** 31, 2 ** 31, (8, 5 + 6 + 12), generator=g,
                          dtype=torch.int32)
    outs = []
    for _ in range(2):
        state = bt.samplers.dream.init(x0, _gaussian(), cfg, 64, z0)
        outs.append(step(state, words, 0)[0].x)
    assert torch.equal(outs[0], outs[1])


def test_input_probes_raise():
    with pytest.raises(ValueError):
        _sampler().run_mcmc(10, np.zeros((3, 4)))          # wrong rows
    with pytest.raises(RuntimeError):
        _ = _sampler().chain                               # before a run
    with pytest.raises(ValueError):
        _sampler(n_archive_init=2).run_mcmc(10, np.zeros(4))
    with pytest.raises(ValueError):
        _sampler().run_mcmc(10)                            # no theta_0


@pytest.mark.parametrize("kw", [
    {"mesh": object()},
    {"fused_z_update": 2, "fused": True},
    {"fused_gather": "pergen", "fused": True},
    {"log_prob_block": lambda x: x}, {"shard_archive": True}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _sampler(**kw)


@pytest.mark.parametrize("kw,match", [
    ({"fused_z_update": 0, "fused": True}, ">= 1"),
    ({"fused_z_update": 2}, "fused=True")])
def test_invalid_fused_z_update_raises_value_error(kw, match):
    # the JAX package's checks (tests/test_fused_chunk.py pins them)
    with pytest.raises(ValueError, match=match):
        _sampler(**kw)


def test_pallas_proposal_false_raises_at_construction_on_cuda():
    lp = _gaussian()
    with pytest.raises(ValueError, match="pallas_proposal"):
        bt.DreamZs(lp, n_chains=8, device="cuda", pallas_proposal=False)
    s = bt.DreamZs(lp, n_chains=8, device="cpu", pallas_proposal=False)
    s.run_mcmc(5, np.zeros(4))
    assert s.get_chain().shape == (8, 5, 4)


def test_progress_every_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _sampler().run_mcmc(10, np.zeros(4), progress_every=5)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "bipymc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "bipymc_tpu", "benchmarks"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_package_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['bipymc_tpu'] = None; import bipymc_tpu_torch")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
