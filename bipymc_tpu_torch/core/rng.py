"""Random words and their conversion to uniforms and normals.

Counterpart of ``bipymc_tpu/core/rng.py``. The JAX package folds a key
per (generation, chain) and draws one block of ``uint32`` words per
generation; here a ``torch.Generator`` (Philox on CUDA) draws each
block with :func:`draw_words`, seeded by (key, step) (:class:`StepWords`),
so a step's words do not depend on which engine runs it: DREAM-zs's
per-generation and fused engines read the same words, and so do the
random-walk family's. Only the word→number conversions must agree with
the JAX package, and they do: :func:`bits_to_uniform` bit for bit,
:func:`uniform_to_normal` up to XLA's float32 inverse-erf.

Words are carried as **int32 bit patterns**: the same 32 bits as the JAX
``uint32`` word, read through a signed type because torch's ``uint32``
supports few operations. ``np.asarray(jax_words).view(np.int32)`` turns a
JAX block into the port's form, and the CUDA kernels read the buffer as
``uint32`` directly.

DREAM-zs's fused engine has a second source for the crossover uniforms,
the multiplicative uniforms and the normals, its in-kernel mode:
:func:`philox4x32_10` (Salmon et al., SC'11, "Parallel random numbers:
as easy as 1, 2, 3") keyed per generation by :func:`kernel_seed`, which
kernel B1 computes in device code (``csrc/philox.cuh``) and
:func:`kernel_draw_bits` in torch ops.
"""

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
    bounding the tail as ``jax.random.normal`` does. The inverse is then
    taken in float64 as Φ⁻¹((v + 1)/2) (``torch.special.ndtri``, the
    Cephes rational approximation in ATen's own code) and rounded once,
    so a float32 result is within half an ulp of the exact value. torch's
    float32 ``erfinv`` is not used: on CPU it goes through MKL's vector
    math library in chunks spread over threads, and in one multi-worker
    test run it returned values up to 7.5e-5 from the exact ones in the
    second half of a 4096-element buffer (the cause was not pinned down).
    ``jax.lax.erf_inv`` is a coarser float32 approximation, within 5e-5 of
    the exact value (tests/test_torch_rng.py states both bounds).
    """
    lo = -1.0 + torch.finfo(u.dtype).eps
    v = (2.0 * u - 1.0).clamp_min(lo)
    n = torch.special.ndtri(0.5 * v.to(torch.float64) + 0.5)
    return n.to(u.dtype if dtype is None else dtype)


_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_seed(key: int, t: int) -> int:
    """The 64-bit seed of step t under run key ``key``."""
    return _splitmix64((int(key) & _MASK64) ^ _splitmix64(int(t)))


class StepWords:
    """Words that depend on (key, global step t) alone.

    The JAX package draws step t's words from ``step_key(key, t)``
    whichever engine runs the step. Here step t's ``[n, n_words]`` block
    comes from a generator seeded with a splitmix64 hash of (key, t), so
    the words of (t, chain i) do not depend on which engine runs t or on
    how a run was cut into segments: :meth:`block` of K steps equals K
    calls. Callable as a word source ``(t, n, n_words, device)``.
    """

    def __init__(self, key: int):
        self.key = int(key) & _MASK64
        self._gens = {}

    def _gen(self, device) -> torch.Generator:
        device = torch.device(device)
        if device not in self._gens:
            self._gens[device] = torch.Generator(device=device)
        return self._gens[device]

    def seed_of(self, t: int) -> int:
        return step_seed(self.key, t)

    def __call__(self, t, n, n_words, device) -> torch.Tensor:
        gen = self._gen(device).manual_seed(self.seed_of(t))
        return draw_words(gen, n, n_words, device)

    def block(self, t0, n_steps, n, n_words, device) -> torch.Tensor:
        """``[n_steps, n, n_words]``: the words of steps t0 … t0+n_steps−1."""
        out = torch.empty((n_steps, n, n_words), dtype=torch.int32,
                          device=device)
        gen = self._gen(device)
        for k in range(n_steps):
            gen.manual_seed(self.seed_of(t0 + k))
            torch.randint(-2 ** 31, 2 ** 31, (n, n_words), generator=gen,
                          device=device, dtype=torch.int32, out=out[k])
        return out


def seed_ints(seed: int, n: int) -> list:
    """``n`` distinct 64-bit seeds derived from one seed by NumPy's
    ``SeedSequence``."""
    return [int(s) for s in
            np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)]


# Philox4x32-10's round multipliers and Weyl key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
# folded into a step's seed to key the in-kernel draws, the constant the
# JAX package folds into its kernel-RNG seeds (``_kernel_rng_seeds``)
KERNEL_RNG_FOLD = 0x6B524E47
_M32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m · c`` for c in [0, 2³²) as int64.
    The product reaches 2⁶⁴, past int64, so c is split into 16-bit
    halves whose partial products stay below 2⁴⁸."""
    p_lo = (c & 0xFFFF) * m
    p_hi = (c >> 16) * m
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (s >> 32) + (p_hi >> 16), s & _M32


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding 32-bit values.

    ``ctr``: four counter words and ``key``: two key words, tensors or
    ints that broadcast together. Returns the four output words, int64
    in [0, 2³²). Ten rounds; the key takes its Weyl increment before
    every round but the first, as in Random123's ``philox4x32_R``.
    """
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _M32
            k1 = (k1 + PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def kernel_seed(key: int, t: int) -> int:
    """The 64-bit Philox key of generation t's in-kernel draws: the
    step's seed with ``KERNEL_RNG_FOLD`` folded in, so the draws stand
    apart from the step's words."""
    return _splitmix64(step_seed(key, t) ^ KERNEL_RNG_FOLD)


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """Words in [0, 2³²) as int64 → the same bits as int32."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def kernel_draw_bits(key: int, t0: int, G: int, n: int, d: int,
                     device) -> tuple:
    """The words kernel B1 draws in its in-kernel mode, in torch ops:
    three ``[G, n, d]`` int32 blocks (for u_mask, u_e and eps).

    Word (t, chain i, lane j) of block b is output word b of
    ``philox4x32_10(ctr=(j, i, 0, 0), key=kernel_seed(key, t))``, the
    key's low half first; word 3 is unused. A chain's draws thus depend
    on (key, t, i, j) alone, not on n, G or how a run is cut into
    chunks.
    """
    lane = torch.arange(d, dtype=torch.int64, device=device)
    chain = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    seeds = [kernel_seed(key, t0 + g) for g in range(G)]
    k0 = torch.tensor([s & _M32 for s in seeds], dtype=torch.int64,
                      device=device)[:, None, None]
    k1 = torch.tensor([s >> 32 for s in seeds], dtype=torch.int64,
                      device=device)[:, None, None]
    out = philox4x32_10((lane, chain, 0, 0), (k0, k1))
    shape = (G, n, d)
    return tuple(_as_int32(w.expand(shape)).contiguous() for w in out[:3])
