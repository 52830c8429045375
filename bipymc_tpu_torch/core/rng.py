"""Random words and their conversion to uniforms and normals.

Counterpart of ``bipymc_tpu/core/rng.py``. The JAX package folds a key
per (generation, chain) and draws one block of ``uint32`` words per
generation; here an explicit ``torch.Generator`` (Philox on CUDA)
advances instead, and each generation draws its block with
:func:`draw_words`. Only the word→number conversions must agree with the
JAX package, and they do: :func:`bits_to_uniform` bit for bit,
:func:`uniform_to_normal` up to the two libraries' inverse-erf.

Words are carried as **int32 bit patterns**: the same 32 bits as the JAX
``uint32`` word, read through a signed type because torch's ``uint32``
supports few operations. ``np.asarray(jax_words).view(np.int32)`` turns a
JAX block into the port's form, and the CUDA kernels read the buffer as
``uint32`` directly.
"""

import math

import numpy as np
import torch

_MANTISSA = 0x007FFFFF
_ONE_BITS = 0x3F800000


def draw_words(gen: torch.Generator, n: int, n_words: int,
               device) -> torch.Tensor:
    """``[n, n_words]`` uniform 32-bit words as int32 bit patterns."""
    return torch.randint(-2 ** 31, 2 ** 31, (n, n_words), generator=gen,
                         device=device, dtype=torch.int32)


def bits_to_uniform(words: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """32-bit words → U[0, 1) floats, element-wise, bit-exact with JAX.

    Keeps the top 23 bits as the mantissa of a float in [1, 2) and
    subtracts 1 (``jax.random.uniform``'s float32 construction). The
    masked shift is the logical ``w >> 9`` of the unsigned word. A dtype
    narrower than float32 is clamped below 1, as in the JAX package.
    """
    mant = (words.to(torch.int32) >> 9) & _MANTISSA
    u = ((mant | _ONE_BITS).view(torch.float32) - 1.0).to(dtype)
    eps = torch.finfo(dtype).eps
    if eps > torch.finfo(torch.float32).eps:
        u = u.clamp_max(1.0 - eps / 2)
    return u


def uniform_to_normal(u: torch.Tensor, dtype=None) -> torch.Tensor:
    """U[0, 1) floats → standard normals, √2·erf⁻¹(2u − 1).

    ``2u − 1`` is clamped one machine epsilon above −1 in ``u``'s dtype,
    bounding the tail as ``jax.random.normal`` does. torch's ``erfinv``
    and ``jax.lax.erf_inv`` are different float32 approximations; they
    agree to a few float32 ulps (tests/test_torch_rng.py states the
    tolerance).
    """
    lo = -1.0 + torch.finfo(u.dtype).eps
    v = (2.0 * u - 1.0).clamp_min(lo)
    n = math.sqrt(2.0) * torch.special.erfinv(v)
    return n if dtype is None else n.to(dtype)


def seeded_generators(seed: int, n: int, device) -> list:
    """``n`` independent generators on ``device`` derived from one seed.

    The JAX package splits one key into init / archive / run keys; the
    port derives one generator seed per stream from NumPy's
    ``SeedSequence`` so the streams are reproducible and distinct.
    """
    seeds = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]
