"""Port ↔ JAX: streaming R̂ and the host diagnostics on the same arrays.

The JAX functions compute in float32, the port's streaming moments in
float32 and its host diagnostics in float64, so values are held within
rtol 1e-4 (R̂, ESS: float32 sums over a few thousand terms) and
integer results (mode occupancy) exactly.
"""

import jax.numpy as jnp
import numpy as np
import torch

from bipymc_tpu.utils import diagnostics as jdiag
from bipymc_tpu.utils import streaming as jstream
from bipymc_tpu_torch.utils import diagnostics, streaming

torch.set_num_threads(2)


def _chains(m=8, n=400, d=3, seed=0):
    """AR(1) chains with per-chain offsets, [m, n, d] float32."""
    rng = np.random.default_rng(seed)
    x = np.zeros((m, n, d))
    for t in range(1, n):
        x[:, t] = 0.8 * x[:, t - 1] + rng.normal(size=(m, d))
    return (x + 0.3 * rng.normal(size=(m, 1, d))).astype(np.float32)


def test_streaming_rhat_matches_jax():
    xs = _chains()
    jc = jstream.rhat_init(xs.shape[0], xs.shape[2])
    tc = streaming.rhat_init(xs.shape[0], xs.shape[2], device="cpu")
    for t in range(xs.shape[1]):
        jc = jstream.rhat_update(jc, jnp.asarray(xs[:, t]))
        tc = streaming.rhat_update(tc, torch.from_numpy(xs[:, t].copy()))
    np.testing.assert_allclose(tc.mean.numpy(), np.asarray(jc.mean),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tc.m2.numpy(), np.asarray(jc.m2), rtol=1e-4)
    np.testing.assert_allclose(
        streaming.rhat_compute(tc, xs.shape[0]).numpy(),
        np.asarray(jstream.rhat_compute(jc, xs.shape[0])), rtol=1e-4)


def test_gelman_rubin_matches_jax():
    xs = _chains(seed=1)
    for split in (True, False):
        np.testing.assert_allclose(
            diagnostics.gelman_rubin(xs, split=split),
            np.asarray(jdiag.gelman_rubin(jnp.asarray(xs), split=split)),
            rtol=1e-4)


def test_ess_and_ess_rate_match_jax():
    xs = _chains(n=600, seed=2)
    np.testing.assert_allclose(
        diagnostics.effective_sample_size(xs),
        float(jdiag.effective_sample_size(jnp.asarray(xs))), rtol=1e-4)
    np.testing.assert_allclose(
        diagnostics.effective_sample_size(xs, per_dim=True),
        float(jdiag.effective_sample_size(jnp.asarray(xs), per_dim=True)),
        rtol=1e-4)
    for window in (250, 2000):         # a window shorter and longer than N
        ess, rate = diagnostics.ess_rate(xs, 123.0, window=window)
        jess, jrate = jdiag.ess_rate(xs, 123.0, window=window)
        np.testing.assert_allclose([ess, rate], [jess, jrate], rtol=1e-4)


def test_mode_occupancy_matches_jax():
    rng = np.random.default_rng(3)
    means = (5.0 * rng.normal(size=(4, 10))).astype(np.float32)
    pos = (means[rng.integers(0, 4, 300)]
           + rng.normal(size=(300, 10))).astype(np.float32)
    occ = diagnostics.mode_occupancy(pos, means)
    np.testing.assert_array_equal(
        occ, np.asarray(jdiag.mode_occupancy(jnp.asarray(pos), means)))
    assert occ.sum() == 300
