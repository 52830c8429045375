"""ChainPool: runs a population sampler's generation step on one device.

Counterpart of ``bipymc_tpu/parallel/pool.py`` without a mesh: the whole
population lives on one device and each generation is one call of the
batched step. The pool draws each generation's random words from the
run's generator and hands them to the step, so the step itself is the
same function the tests feed with the JAX package's words.

``run_until`` is a host loop over chunks of generations. The R̂ test
reads one device value per chunk, after the warm-up chunks; no
generation waits for the device.
"""

import math
from typing import Callable

import torch

from bipymc_tpu_torch.core.rng import draw_words
from bipymc_tpu_torch.core.scan import run_scan_thinned
from bipymc_tpu_torch.utils.streaming import (
    rhat_compute, rhat_init, rhat_update)


def _default_position(state):
    return state.x


class ChainPool:
    """step: ``(state, words, t) -> (state, info)``; n_words: ``d ->``
    random words per chain per generation; collect_fn: ``(state, info)
    -> dict`` of tensors kept per collected generation."""

    def __init__(self, step: Callable, n_words: Callable[[int], int],
                 collect_fn: Callable | None = None):
        self.step = step
        self.n_words = n_words
        self.collect_fn = collect_fn

    def _stepper(self, state, generator):
        n, d = state.x.shape
        n_words = self.n_words(d)
        device = state.x.device

        def one(s, t):
            return self.step(s, draw_words(generator, n, n_words, device), t)

        return one

    def run(self, state, generator: torch.Generator, n_steps: int,
            thin: int = 1, collect_fn: Callable | None = None, t0: int = 0):
        """Run ``n_steps`` generations, collecting every ``thin``-th.

        Default collection: the step info's fields per kept generation.
        Returns (final_state, history of [n_kept, ...] tensors).
        """
        collect_fn = collect_fn or self.collect_fn
        return run_scan_thinned(self._stepper(state, generator), state,
                                n_steps, thin, collect_fn, t0)

    def run_until(self, state, generator: torch.Generator, rhat_tol=1.05,
                  chunk=100, max_chunks=200, warmup_chunks=2,
                  position_fn=None, t0: int = 0):
        """Run chunks of ``chunk`` generations until R̂ < rhat_tol.

        The moments restart after ``warmup_chunks`` chunks, so early
        transients stay out of R̂. Returns (final_state, info) with
        ``steps``, the final ``rhat`` [d], and the streamed per-chain
        ``mean`` and ``var`` [n_chains, d].
        """
        position_fn = position_fn or _default_position
        pos0 = position_fn(state)
        n_total, d = pos0.shape[0], pos0.shape[-1]
        if n_total < 2:
            raise ValueError("R-hat early stop needs n_chains >= 2")
        one = self._stepper(state, generator)

        def fresh():
            return rhat_init(n_total, d, pos0.dtype, pos0.device)

        rc = fresh()
        rhat = torch.full((d,), math.inf, dtype=pos0.dtype,
                          device=pos0.device)
        ci = 0
        while ci < max_chunks:
            if ci == warmup_chunks:
                rc = fresh()                 # the monitored window starts
            t_start = t0 + ci * chunk
            for t in range(t_start, t_start + chunk):
                state, _ = one(state, t)
                rc = rhat_update(rc, position_fn(state))
            ci += 1
            if ci > warmup_chunks:
                rhat = rhat_compute(rc, n_total)
                # one sync a chunk; a NaN R̂ stops the run, as in the JAX
                # package's loop condition
                if not float(torch.max(rhat)) >= rhat_tol:
                    break
        var = rc.m2 / max(rc.n - 1.0, 1.0)
        return state, {"steps": ci * chunk, "rhat": rhat, "mean": rc.mean,
                       "var": var}
