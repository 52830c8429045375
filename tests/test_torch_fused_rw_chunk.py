"""Port ↔ JAX: kernel B4's plain version against ``fused_rw_chunk_pallas``
in interpret mode, on the same NumPy ``x0, logp0, dy1, dy2, scal``.

The JAX kernel evaluates ``block_logp_from_scalar(correlated_gaussian)``,
the port's plain version the batched ``correlated_gaussian``. Accept
decisions and stages must be identical; positions and logp are held
within rtol 1e-5 / atol 1e-6 (the packages sum the quadratic form in
different orders). A target with a +inf region must be rejected
identically by both. On the CPU the wrapper takes the plain version; on
a device with no kernel it raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.models import targets as jtargets
from bipymc_tpu.ops.fused_chunk import block_logp_from_scalar
from bipymc_tpu.ops.fused_rw_chunk import fused_rw_chunk_pallas
from bipymc_tpu_torch.models import targets
from bipymc_tpu_torch.ops.fused_rw_chunk import (fused_rw_chunk,
                                                 fused_rw_chunk_plain)

torch.set_num_threads(2)

KAPPA_ISK = float(np.float32(1.0) / np.sqrt(np.float32(5.0)))


def _operands(n, d, K, seed, scale=0.9):
    """x0, dy1, dy2, scal as the fused runner builds them: z draws against
    one Cholesky factor, the whitened norms, log u."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    L = np.linalg.cholesky(scale * (a @ a.T / d + np.eye(d)))
    z1 = rng.standard_normal((K, n, d))
    z2 = rng.standard_normal((K, n, d))
    u = rng.uniform(1e-7, 1.0, (2, K, n))
    w = z1 - KAPPA_ISK * z2
    scal = np.stack([np.sum(z1 ** 2, -1), np.sum(w ** 2, -1), np.log(u[0]),
                     np.log(u[1])], -1)
    x0 = rng.standard_normal((n, d))
    f32 = lambda v: np.ascontiguousarray(v, dtype=np.float32)
    return (f32(x0), f32(z1 @ L.T), f32(KAPPA_ISK * (z2 @ L.T)), f32(scal))


def _both(x0, dy1, dy2, scal, jblock, port_lp, delayed, lp0):
    jout = fused_rw_chunk_pallas(
        jnp.asarray(x0), jnp.asarray(lp0), jnp.asarray(dy1),
        jnp.asarray(dy2) if delayed else None, jnp.asarray(scal), jblock,
        delayed=delayed, interpret=True)
    t = [torch.from_numpy(a) for a in (x0, lp0, dy1, dy2, scal)]
    out = fused_rw_chunk(t[0], t[1], t[2], t[3] if delayed else None, t[4],
                         port_lp, delayed)
    return [np.asarray(a) for a in jout], [a.numpy() for a in out]


@pytest.mark.parametrize("delayed", [False, True])
@pytest.mark.parametrize("n", [1, 4, 9])
@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("K", [7, 20])
def test_plain_matches_pallas_interpret(delayed, n, d, K):
    rng = np.random.default_rng(d)
    mean = rng.standard_normal(d)
    a = rng.standard_normal((d, d))
    cov = a @ a.T / d + np.eye(d)
    jlp = jtargets.correlated_gaussian(mean, cov)
    lp = targets.correlated_gaussian(mean, cov)
    x0, dy1, dy2, scal = _operands(n, d, K, seed=100 * n + 10 * d + K)
    lp0 = lp(torch.from_numpy(x0)).numpy()
    (jx, jl, ja, js), (x, l, acc, st) = _both(
        x0, dy1, dy2, scal, block_logp_from_scalar(jlp, d), lp, delayed,
        lp0)
    np.testing.assert_array_equal(acc, ja)
    np.testing.assert_array_equal(st, js)
    np.testing.assert_allclose(x, jx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l, jl, rtol=1e-5, atol=1e-6)
    assert x.shape == (K, n, d) and st.dtype == np.int32


def test_stages_covered_at_a_larger_case():
    """One case long enough to hold every outcome: rejects, stage-1 and
    stage-2 accepts, all identical to the Pallas kernel's."""
    d, n, K = 3, 16, 40
    mean, cov = np.zeros(d), np.eye(d) + 0.5
    jlp = jtargets.correlated_gaussian(mean, cov)
    lp = targets.correlated_gaussian(mean, cov)
    x0, dy1, dy2, scal = _operands(n, d, K, seed=5, scale=4.0)
    lp0 = lp(torch.from_numpy(x0)).numpy()
    (jx, _, ja, js), (x, _, acc, st) = _both(
        x0, dy1, dy2, scal, block_logp_from_scalar(jlp, d), lp, True, lp0)
    np.testing.assert_array_equal(st, js)
    assert set(np.unique(st)) == {0, 1, 2}
    np.testing.assert_allclose(x, jx, rtol=1e-5, atol=1e-6)


def test_nonfinite_target_rejects_identically():
    """A +inf region: log_a1 itself is sanitised to −inf, so stage 2's
    Green–Mira denominator stays right, and no chain lands in it."""
    def jscalar(theta):
        base = -0.5 * jnp.sum(theta ** 2)
        return jnp.where((theta[0] > 0.4) & (theta[1] > 0.4), jnp.inf, base)

    def port_lp(x):
        base = -0.5 * torch.sum(x ** 2, dim=-1)
        inside = (x[:, 0] > 0.4) & (x[:, 1] > 0.4)
        return torch.where(inside, torch.inf, base)

    n, d, K = 8, 2, 60
    x0, dy1, dy2, scal = _operands(n, d, K, seed=9)
    x0 = -np.abs(x0)                      # start outside the region
    lp0 = port_lp(torch.from_numpy(x0)).numpy()
    for delayed in (False, True):
        (jx, _, ja, js), (x, lp, acc, st) = _both(
            x0, dy1, dy2, scal, block_logp_from_scalar(jscalar, d), port_lp,
            delayed, lp0)
        np.testing.assert_array_equal(st, js)
        np.testing.assert_allclose(x, jx, rtol=1e-5, atol=1e-6)
        assert not np.any((x[..., 0] > 0.4) & (x[..., 1] > 0.4))
        assert np.all(np.isfinite(lp))
        # the proposals did enter the region, and were all refused
        y1 = x0[None] + dy1
        assert np.any((y1[..., 0] > 0.4) & (y1[..., 1] > 0.4))


def test_wrapper_takes_plain_on_cpu_and_raises_elsewhere():
    lp = targets.correlated_gaussian(np.zeros(2), np.eye(2))
    x0, dy1, dy2, scal = (torch.from_numpy(a) for a in
                          _operands(3, 2, 5, seed=0))
    lp0 = lp(x0)
    for a, b in zip(fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, True),
                    fused_rw_chunk_plain(x0, lp0, dy1, dy2, scal, lp, True)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dy2"):
        fused_rw_chunk(x0, lp0, dy1, None, scal, lp, True)
    with pytest.raises(ValueError, match="divide"):
        fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, True, steps_per_cell=2)
    with pytest.raises(ValueError, match="scal"):
        fused_rw_chunk(x0, lp0, dy1, dy2, scal[..., :3], lp, True)
    meta = [a.to("meta") for a in (x0, lp0, dy1, dy2, scal)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_rw_chunk(*meta, lp, True)
    with pytest.raises(ValueError, match="kernel form"):
        fused_rw_chunk(*meta, lambda x: x.sum(-1), True)
    mix = targets.gaussian_mixture(np.zeros((17, 2)))
    with pytest.raises(ValueError, match="at most 16 modes"):
        fused_rw_chunk(*meta, mix, True)
