"""Port ↔ JAX: kernels B5 (pairwise squared distances) and B6 (the
batched Cholesky with its forward solve), their plain versions on the
CPU against the JAX package on the same NumPy inputs.

B5: the port's ``sqdist_plain`` against ``_sqdist_xla`` within atol 1e-4
(both full-float32 products on the CPU, summed in other orders, on
distances of order 10²) and against the Pallas kernel
``_sqdist_pallas_call`` run in interpret mode, as tests/test_gp.py runs
it, within that test's atol 1e-3, at the CUDA kernel's edge shapes too
(m % 4 ≠ 0, k at and past its last register instance, 8);
``pairwise_sqdist``, batched over a leading chain axis and not, against
the JAX one (vmapped over chains) within atol 1e-4, and float64 kept
within 1e-12 of the exact distances.

B6: the port's ``cholesky_solve_batched`` and ``cholesky_batched`` (the
plain versions on the CPU) against ``cholesky_solve_batched_pallas(...,
interpret=True)``: L within atol 5e-6·max|L| and z within atol
1e-5·max|z| (the JAX package's bounds, tests/test_pallas_bchol.py), and
a matrix that is not positive definite NaN on both sides, the others
finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bipymc_tpu.ops import pallas_kernels as jpk
from bipymc_tpu.ops.pallas_bchol import cholesky_solve_batched_pallas
from bipymc_tpu_torch.ops import pallas_bchol, pallas_kernels

torch.set_num_threads(2)


def _pts(shape, seed, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# the first shape, then the kernel's edges: m % 4 in {1, 2, 3} (its
# scalar-store rows) and k in {1, 8, 9} (its register instances end at 8)
@pytest.mark.parametrize("n,m,k", [(130, 140, 5), (40, 129, 2), (40, 130, 2),
                                   (40, 131, 2), (64, 64, 1), (50, 128, 8),
                                   (50, 132, 9)])
def test_sqdist_plain_matches_xla_and_pallas_interpret(n, m, k):
    a, b = _pts((n, k), 4), _pts((m, k), 5)
    out = pallas_kernels.sqdist_plain(torch.from_numpy(a),
                                      torch.from_numpy(b)).numpy()
    xla = np.asarray(jpk._sqdist_xla(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(out, xla, rtol=0, atol=1e-4)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jpk._sqdist_pallas_call(
            jnp.asarray(a), jnp.asarray(b), bm=128, bn=128))
    np.testing.assert_allclose(out, pallas, rtol=0, atol=1e-3)
    assert out.dtype == np.float32 and np.all(out >= 0)
    # the wrapper takes the plain version for CPU tensors, batched or not
    np.testing.assert_array_equal(pallas_kernels.sqdist(
        torch.from_numpy(a), torch.from_numpy(b)).numpy(), out)
    batched = pallas_kernels.sqdist(torch.from_numpy(a)[None].repeat(3, 1, 1),
                                    torch.from_numpy(b)[None].repeat(3, 1, 1))
    assert batched.shape == (3, n, m)
    np.testing.assert_allclose(batched.numpy()[2], out, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(64, 2), (9, 3)])
def test_pairwise_sqdist_matches_jax(shape):
    x = _pts(shape, 1) + 5.0          # off-centre: the centring matters
    x2 = _pts((17, shape[1]), 2)
    for args in ((x,), (x, x2)):
        ref = np.asarray(jpk.pairwise_sqdist(*map(jnp.asarray, args)))
        out = pallas_kernels.pairwise_sqdist(
            *map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_pairwise_sqdist_batched_over_chains_matches_vmap():
    """[C, n, k] inputs: each chain centred on its own mean, as the
    reference's vmap over chains centres it."""
    x = _pts((64, 2), 3)
    ls = np.exp(0.3 * np.random.default_rng(4).standard_normal((8, 1, 2))
                ).astype(np.float32)
    xs = x[None] / ls
    ref = np.asarray(jax.vmap(jpk.pairwise_sqdist)(jnp.asarray(xs)))
    out = pallas_kernels.pairwise_sqdist(torch.from_numpy(xs)).numpy()
    assert out.shape == (8, 64, 64)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_pairwise_sqdist_keeps_float64():
    x = _pts((20, 3), 5).astype(np.float64) + 100.0
    out = pallas_kernels.pairwise_sqdist(torch.from_numpy(x))
    assert out.dtype == torch.float64
    exact = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(out.numpy(), exact, rtol=0, atol=1e-12)


def test_wrappers_raise_on_a_device_without_kernel():
    a = torch.empty((2, 8, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pallas_kernels.sqdist(a, a)
    with pytest.raises(ValueError, match="no kernel"):
        pallas_bchol.cholesky_batched(torch.empty((2, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        pallas_kernels.sqdist(torch.zeros(3, 4, 2), torch.zeros(3, 4, 3))
    with pytest.raises(ValueError):
        pallas_bchol.cholesky_solve_batched(torch.zeros(3, 4, 4),
                                            torch.zeros(3, 5))


def _spd(b, n, seed):
    """tests/test_pallas_bchol.py's SPD matrices: x xᵀ/24 + 3I."""
    x = np.random.default_rng(seed).standard_normal((b, n, 24)).astype(
        np.float32)
    return x @ np.swapaxes(x, -1, -2) / 24 + 3 * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("b,n", [(3, 64), (8, 128), (5, 200)])
def test_cholesky_solve_matches_pallas_interpret(b, n):
    k = _spd(b, n, seed=n + 2 * b)
    y = np.random.default_rng(n).standard_normal((b, n)).astype(np.float32)
    jl, jz = cholesky_solve_batched_pallas(jnp.asarray(k), jnp.asarray(y),
                                           True)
    jl, jz = np.asarray(jl), np.asarray(jz)
    L, z = pallas_bchol.cholesky_solve_batched(torch.from_numpy(k),
                                               torch.from_numpy(y))
    np.testing.assert_allclose(L.numpy(), jl, rtol=0,
                               atol=5e-6 * np.max(np.abs(jl)))
    np.testing.assert_allclose(z.numpy(), jz, rtol=0,
                               atol=1e-5 * np.max(np.abs(jz)))
    L_only = pallas_bchol.cholesky_batched(torch.from_numpy(k))
    np.testing.assert_array_equal(L_only.numpy(), L.numpy())
    assert np.all(np.triu(L.numpy(), 1) == 0.0)


def test_non_positive_definite_matrix_is_nan_on_both_sides():
    k = _spd(3, 64, seed=1)
    k[1] -= 10.0 * np.eye(64, dtype=np.float32)      # indefinite
    y = np.ones((3, 64), np.float32)
    jl, jz = cholesky_solve_batched_pallas(jnp.asarray(k), jnp.asarray(y),
                                           True)
    jnan = np.isnan(np.asarray(jl)).reshape(3, -1).any(1)
    L, z = pallas_bchol.cholesky_solve_batched(torch.from_numpy(k),
                                               torch.from_numpy(y))
    assert jnan.tolist() == [False, True, False]
    assert torch.isnan(L[1]).all() and torch.isnan(z[1]).all()
    for i in (0, 2):
        assert torch.isfinite(L[i]).all() and torch.isfinite(z[i]).all()
        np.testing.assert_allclose(L[i].numpy(), np.asarray(jl)[i], rtol=0,
                                   atol=5e-6 * np.max(np.abs(jl[i])))
    # the log-ML's ingredients come out NaN, which a sampler rejects
    assert torch.isnan(torch.log(torch.diagonal(L[1])).sum())
