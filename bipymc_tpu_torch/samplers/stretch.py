"""Affine-invariant ensemble sampler: the Goodman & Weare (2010) stretch
move with emcee's red-black parallel update.

Counterpart of ``bipymc_tpu/samplers/stretch.py`` on one device, stretch
move only. The ensemble splits into two halves; each half moves at once
against walkers of the other half, which keeps detailed balance where an
all-at-once update would not. For walker x_i and partner x_j,

  z ~ g(z) ∝ 1/√z on [1/a, a]   (z = ((a − 1)u + 1)² / a),
  x* = x_j + z (x_i − x_j),
  accept with probability min{1, z^{d−1} π(x*)/π(x_i)}.

The step takes its randomness as an argument: one ``[n, 3]`` block of
int32 words a generation, row i's words being the JAX step's per-walker
block (``fold_in(k1, i)`` for the rows of the first half, ``fold_in(k2,
i)`` for the second, ``bipymc_tpu/samplers/stretch.py:100-104``).
:func:`convert_words` turns them into partner rows, stretch factors and
log u with the JAX package's expressions (``_propose``, ``:70-82``); the
fused engine (``samplers/stretch_fused.py``) calls it too, so both
engines take the same decisions. Only the active half's n/2 targets are
evaluated a half-update (``ops/fused_stretch.half_update``).

Not ported: the walk move (``move="walk"``, ROADMAP Queue A item 20) and
the mesh (item 15); ``samplers/api.EnsembleSampler`` raises for both.
"""

from typing import Callable, NamedTuple

import torch

from bipymc_tpu_torch.core.rng import bits_to_uniform
from bipymc_tpu_torch.ops.fused_stretch import stretch_generation

WALK_ITEM = "ROADMAP Queue A item 20 (the stretch family's walk move)"


class StretchConfig(NamedTuple):
    n_chains: int              # total walkers (even; ≥ 2d+2 recommended)
    a: float = 2.0             # stretch scale
    move: str = "stretch"      # "stretch" ("walk" is not ported)


class StretchState(NamedTuple):
    x: torch.Tensor            # [n, d] walker positions
    logp: torch.Tensor         # [n]
    gen: int                   # generations run


class StretchInfo(NamedTuple):
    accepted: torch.Tensor     # [n] bool, row i's half-update accepted
    logp: torch.Tensor         # [n]


def n_words(d: int) -> int:
    """Random words per walker per generation: the partner, u for z, u
    for the accept."""
    return 3


def init(x0: torch.Tensor, log_prob: Callable) -> StretchState:
    return StretchState(x=x0, logp=log_prob(x0), gen=0)


def check_config(cfg: StretchConfig) -> None:
    """Raise for what the port does not run."""
    if cfg.move == "walk":
        raise NotImplementedError(f"move='walk' is not ported: {WALK_ITEM}")
    if cfg.move != "stretch":
        raise ValueError(f"unknown ensemble move {cfg.move!r}: expected "
                         "'stretch' or 'walk'")
    if cfg.n_chains % 2:
        raise ValueError("stretch move needs an even number of walkers")


def convert_words(words: torch.Tensor, a: float, dtype=torch.float32):
    """Words ``[..., n, 3]`` → (j [..., n] int32, z [..., n], log_u [..., n]).

    ``j = (w₀ & 0x7FFFFFFF) % half``, plus ``half`` for the rows of the
    first half (their partners lie in the second); ``u = bits_to_uniform
    (w₁, w₂)``; ``z = ((a − 1)·u₀ + 1)² / a``; ``log u₁``.
    """
    half = words.shape[-2] // 2
    j = (words[..., 0] & 0x7FFFFFFF) % half
    j[..., :half] += half
    u = bits_to_uniform(words[..., 1:3], dtype)
    z = ((a - 1.0) * u[..., 0] + 1.0) ** 2 / a
    return j.to(torch.int32), z, torch.log(u[..., 1])


def make_step(log_prob: Callable, cfg: StretchConfig) -> Callable:
    """``step(state, words [n, 3], t) -> (state, info)``: one generation,
    the two half-updates."""
    check_config(cfg)

    def step(state: StretchState, words: torch.Tensor, t: int):
        j, z, log_u = convert_words(words, cfg.a, state.x.dtype)
        x, lp, acc, _ = stretch_generation(state.x, state.logp, j, z,
                                           log_u, log_prob)
        return (StretchState(x=x, logp=lp, gen=state.gen + 1),
                StretchInfo(accepted=acc, logp=lp))

    return step
