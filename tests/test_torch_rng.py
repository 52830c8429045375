"""Port ↔ JAX: word → uniform / normal conversions (core/rng.py).

``bits_to_uniform`` must be bit-equal on the same 32-bit words.
``uniform_to_normal`` takes the inverse in float64 and rounds once;
``jax.lax.erf_inv`` is a float32 approximation. Against the float64
value (scipy), the port's stays within 1e-6 (half a float32 ulp is
2.4e-7 at the 5.3σ tail) and XLA's CPU one within 5e-5 (both asserted
below), so the two are held within atol 1e-4 of each other. In the
DREAM step these normals are scaled by b* = 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import scipy.special
import torch

from bipymc_tpu.core import rng as jrng
from bipymc_tpu_torch.core import rng

torch.set_num_threads(2)


def _words(n=4096, seed=0):
    w = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64)
    w = w.astype(np.uint32)
    # the extremes: all zero, all one, and the mantissa edges
    w[:6] = [0, 0xFFFFFFFF, 0x1FF, 0x200, 0x7FFFFFFF, 0x80000000]
    return w


def test_bits_to_uniform_bit_equal():
    w = _words()
    ref = np.asarray(jrng.bits_to_uniform(jnp.asarray(w)))
    out = rng.bits_to_uniform(torch.from_numpy(w.view(np.int32))).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    assert out[0] == 0.0 and out[1] == np.float32(1 - 2 ** -23)


def test_uniform_to_normal_matches_jax():
    u = np.array(jrng.bits_to_uniform(jnp.asarray(_words(seed=1))))
    ref = np.asarray(jrng.uniform_to_normal(jnp.asarray(u)))
    out = rng.uniform_to_normal(torch.from_numpy(u)).numpy()
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    v = np.maximum(2 * u - 1, np.float32(-1 + 2 ** -23)).astype(np.float64)
    exact = np.sqrt(2.0) * scipy.special.erfinv(v)
    assert np.max(np.abs(out - exact)) < 1e-6
    assert np.max(np.abs(ref - exact)) < 5e-5


def test_draw_words_full_range_and_reproducible():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = rng.draw_words(g1, 64, 40, "cpu")
    b = rng.draw_words(g2, 64, 40, "cpu")
    assert a.dtype == torch.int32 and a.shape == (64, 40)
    assert torch.equal(a, b)
    # both halves of the unsigned range appear (sign bit set and clear)
    assert (a < 0).any() and (a >= 0).any()
    # the generator advances: the next block differs
    assert not torch.equal(a, rng.draw_words(g1, 64, 40, "cpu"))
