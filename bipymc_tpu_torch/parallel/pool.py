"""ChainPool: runs a population sampler's step on one device.

Counterpart of ``bipymc_tpu/parallel/pool.py`` without a mesh: the whole
population lives on one device and each step is one call of the batched
step. The pool takes each step's random words from a word source
``words(t, n, n_words, device) -> [n, n_words]`` and hands them to the
step, so the step itself is the same function the tests feed with the
JAX package's words. Both families draw from ``core/rng.StepWords``,
whose words depend on the global step alone, so a fused engine reads
the same words as the step.

``run_until`` is a host loop over chunks of steps. The R̂ test reads one
device value per chunk, after the warm-up chunks; no step waits for the
device. A fused ``chunk_runner`` may run whole chunks instead of the
step (from step ``fused_after`` on), its history folded into R̂ as one
block, or its own moments merged.
"""

import math
from typing import Callable

import torch

from bipymc_tpu_torch.core.scan import run_scan_thinned
from bipymc_tpu_torch.utils.streaming import (
    rhat_compute, rhat_init, rhat_merge, rhat_update, rhat_update_block)


def _default_position(state):
    return state.x


class ChainPool:
    """step: ``(state, words, t) -> (state, info)``; n_words: ``d ->``
    random words per chain per step; collect_fn: ``(state, info) ->
    dict`` of tensors kept per collected step."""

    def __init__(self, step: Callable, n_words: Callable[[int], int],
                 collect_fn: Callable | None = None):
        self.step = step
        self.n_words = n_words
        self.collect_fn = collect_fn

    def _stepper(self, words: Callable, pos: torch.Tensor):
        n, d = pos.shape
        n_words = self.n_words(d)
        device = pos.device

        def one(s, t):
            return self.step(s, words(t, n, n_words, device), t)

        return one

    def run(self, state, words: Callable, n_steps: int, thin: int = 1,
            collect_fn: Callable | None = None, t0: int = 0,
            position_fn: Callable | None = None):
        """Run ``n_steps`` steps, collecting every ``thin``-th.

        Default collection: the step info's fields per kept step.
        Returns (final_state, history of [n_kept, ...] tensors).
        """
        collect_fn = collect_fn or self.collect_fn
        pos = (position_fn or _default_position)(state)
        return run_scan_thinned(self._stepper(words, pos), state, n_steps,
                                thin, collect_fn, t0)

    def run_until(self, state, words: Callable, rhat_tol=1.05, chunk=100,
                  max_chunks=200, warmup_chunks=2, position_fn=None,
                  t0: int = 0, chunk_runner: Callable | None = None,
                  fused_after: int = 0):
        """Run chunks of ``chunk`` steps until R̂ < rhat_tol.

        The moments restart after ``warmup_chunks`` chunks, so early
        transients stay out of R̂. ``chunk_runner``: a fused runner
        ``(state, words, n_steps, t0) -> (state, history)`` that runs
        every chunk starting at step ``fused_after`` or later in place
        of the step (the step runs the chunks before, e.g. DREAM-zs's
        burn-in); its ``history["rhat"]`` moments are merged by
        ``rhat_merge``, or else its ``history["x"]`` folded by
        ``rhat_update_block``. Its ``position_field`` must be the field
        ``position_fn`` reads, ``chunk`` a multiple of its
        ``chunk_multiple`` and ``t0`` of its ``align``. Returns
        (final_state, info) with ``steps``, the final ``rhat`` [d], and
        the streamed per-chain ``mean`` and ``var`` [n_chains, d].
        """
        position_fn = position_fn or _default_position
        if chunk_runner is not None:
            # fused chunks fold the runner's own history, per-step chunks
            # position_fn(state): they must be the same series
            field = getattr(chunk_runner, "position_field", "x")
            if position_fn(state) is not getattr(state, field):
                raise ValueError(
                    "run_until(chunk_runner=...): position_fn must extract "
                    f"the runner's recorded position (state.{field})")
            mult = getattr(chunk_runner, "chunk_multiple", None)
            if mult and chunk % mult:
                raise ValueError(
                    f"chunk={chunk} must be a multiple of the fused "
                    f"runner's chunk length {mult}")
            align = getattr(chunk_runner, "align", None)
            if align and t0 % align:
                raise ValueError(
                    f"t0={t0} must be aligned to the fused runner's "
                    f"alignment {align}")
        pos0 = position_fn(state)
        n_total, d = pos0.shape[0], pos0.shape[-1]
        if n_total < 2:
            raise ValueError("R-hat early stop needs n_chains >= 2")
        one = self._stepper(words, pos0)

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
            if chunk_runner is not None and t_start >= fused_after:
                state, hist = chunk_runner(state, words, chunk, t_start)
                rc = (rhat_merge(rc, hist["rhat"]) if "rhat" in hist
                      else rhat_update_block(rc, hist["x"]))
            else:
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
