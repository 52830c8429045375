"""bipymc_tpu_torch — the PyTorch/CUDA port of ``bipymc_tpu``.

A second package beside the JAX one, written for one NVIDIA H100. It
mirrors ``bipymc_tpu``'s module paths, so the counterpart of
``bipymc_tpu/samplers/dream.py`` is ``bipymc_tpu_torch/samplers/dream.py``.
The JAX package stays the reference; the port imports ``torch`` and
``numpy`` and nothing of JAX.

The user's target is a batched ``log_prob(x[n, d]) -> [n]``. Ported:

- DREAM-zs on the per-generation engine: each generation launches two
  hand-written CUDA kernels, ``ops/distinct_idx.py`` (B3) and
  ``ops/dream_proposal.py`` (B2). With ``fused=True`` the generations
  after burn-in run in chunks of ``archive_thin``, one launch of
  ``ops/fused_chunk.py`` (B1) and one of B3 a chunk, on the built-in
  targets ``correlated_gaussian`` and ``gaussian_mixture``.
- The random-walk family (``Metropolis``, ``AdaptiveMetropolis``,
  ``DrMetropolis``, ``Dram``): per-step, or with ``fused=True`` K steps
  per launch of ``ops/fused_rw_chunk.py`` (B4), which evaluates the
  built-in targets ``correlated_gaussian`` and ``gaussian_mixture`` in
  device code.
- The affine-invariant ensemble sampler (``EnsembleSampler``, the
  Goodman–Weare stretch move with emcee's red-black update): per
  generation, or with ``fused=True`` 64 generations per launch of
  ``ops/fused_stretch.py`` (B9), on the built-in targets.
- GP regression (``GpRegressor``: fit, predict and the log marginal
  likelihood, batched over chains), whose Gram matrices go through
  ``ops/pallas_kernels.py`` (B5) and whose batched factor-and-solve goes
  through ``ops/pallas_bchol.py`` (B6). BASELINE config 4 is ``Dram``
  over a batched GP log-ML. ``GpRegressor.optimize`` trains the
  hyperparameters through autograd (every GP kernel has a gradient);
  ``pallas_chol=True`` factors on ``ops/pallas_chol.py`` (B7) and
  ``pallas_solve=True`` solves on ``ops/pallas_solve.py`` (B8);
  ``surrogate_log_like`` makes a fit a batched target (BASELINE config
  5, sampled with ``DreamZs``).

Entry points run on ``device="cuda"`` unless the caller passes another
device::

    import bipymc_tpu_torch as bt
    means = bt.baseline_config3_means(100)
    s = bt.DreamZs(bt.gaussian_mixture(means), n_chains=256, seed=0,
                   burnin_gens=500, archive_capacity=8192, fused=True)
    s.run_mcmc(3000, theta_0)

    lp = bt.correlated_gaussian([1.0, -1.0], [[2.0, 0.8], [0.8, 1.0]])
    s = bt.Dram(lp, seed=1, n_chains=1, fused=True)
    s.run_mcmc(20000, [0.0, 0.0], cov_est=np.eye(2))

    scales = np.linspace(0.5, 3.0, 16)
    lp = bt.correlated_gaussian(np.zeros(16), np.diag(scales ** 2))
    s = bt.EnsembleSampler(lp, n_chains=256, seed=0, fused=True)
    s.run_mcmc(20000, x0)                     # x0 [256, 16]: 313 B9 launches

    gp = bt.GpRegressor()
    def log_post(theta):                                  # [64, 4] → [64]
        p = {"log_lengthscale": theta[:, :2], "log_sigma_f": theta[:, 2],
             "log_sigma_n": theta[:, 3]}
        lml = gp._lml_impl(p, x, y)             # x [512, 2]: one B6 launch
        return lml - 0.5 * ((theta / 2) ** 2).sum(-1)
    s = bt.Dram(log_post, seed=1, n_chains=64)
    s.run_mcmc(2000, np.zeros(4), cov_est=0.05 * np.eye(4))
"""

from bipymc_tpu_torch.gp import (GpFit, GpRegressor, matern32, matern52,
                                 squared_exp)
from bipymc_tpu_torch.models.targets import (baseline_config3_means,
                                             correlated_gaussian,
                                             gaussian_mixture,
                                             stratified_mode_init)
from bipymc_tpu_torch.samplers.api import (AdaptiveMetropolis, Dram,
                                           DreamZs, DrMetropolis,
                                           EnsembleSampler, McmcSampler,
                                           Metropolis)
from bipymc_tpu_torch.utils.diagnostics import (effective_sample_size,
                                                ess_rate, gelman_rubin,
                                                mode_occupancy)
from bipymc_tpu_torch.utils.init import var_ball

__all__ = [
    "AdaptiveMetropolis",
    "DrMetropolis",
    "Dram",
    "DreamZs",
    "EnsembleSampler",
    "GpFit",
    "GpRegressor",
    "McmcSampler",
    "Metropolis",
    "baseline_config3_means",
    "correlated_gaussian",
    "effective_sample_size",
    "ess_rate",
    "gaussian_mixture",
    "gelman_rubin",
    "matern32",
    "matern52",
    "mode_occupancy",
    "squared_exp",
    "stratified_mode_init",
    "var_ball",
]
