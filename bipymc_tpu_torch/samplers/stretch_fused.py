"""Chunked fused engine for the stretch ensemble sampler.

Counterpart of ``bipymc_tpu/samplers/stretch_fused.py`` on one device: a
host loop over chunks of ``kernel_gens`` generations, each (a) the
chunk's word block from the per-generation engine's source
(``core/rng.StepWords``: the words of generation t depend on t alone),
converted by the step's own :func:`~bipymc_tpu_torch.samplers.stretch.
convert_words`, then (b) ONE launch of kernel B9
(``ops/fused_stretch.py``) for all of the chunk's generations. There is
no archive and no burn-in adaptation, so every generation fuses: the
only constraint is the chunk length: a run of ``n_gens`` takes
``n_gens // kernel_gens`` full chunks and, where ``kernel_gens`` does not
divide ``n_gens``, one shorter chunk.

The fused engine thus takes the per-generation engine's decisions: the
same words, the same partners, stretch factors and log u, and the same
half-update math (the step and B9's plain version share
``ops/fused_stretch.stretch_generation``), up to float re-association of
the target on the card.
"""

from typing import Callable

import torch

from bipymc_tpu_torch.ops.fused_stretch import fused_stretch
from bipymc_tpu_torch.samplers.stretch import (StretchConfig, StretchState,
                                               check_config, convert_words,
                                               n_words)
from bipymc_tpu_torch.utils.streaming import rhat_init, rhat_update_block


def chunk_words(words, t0: int, G: int, n: int, d: int, a: float, dtype,
                device):
    """(j, z, log_u), each [G, n], of generations t0 … t0 + G − 1: the
    words ``words.block`` gives, converted as the step converts them."""
    blk = words.block(t0, G, n, n_words(d), device)
    return convert_words(blk, a, dtype)


def make_chunk_runner(log_prob: Callable, cfg: StretchConfig,
                      kernel_gens: int = 64, collect: str = "all"):
    """Build ``run(state, words, n_gens, t0) -> (state, history)``.

    words: a word source with ``block`` (``core/rng.StepWords``). Any
    n_gens ≥ 1 and any t0. history holds ``logp`` and ``accepted``
    ([n_gens, n]) and, with ``collect="all"``, ``x`` ([n_gens, n, d]);
    ``collect="rhat"`` folds the positions chunk by chunk into per-walker
    moments, returned as ``history["rhat"]`` (what
    ``ChainPool.run_until`` merges).
    """
    check_config(cfg)
    n = cfg.n_chains
    if collect not in ("all", "rhat"):
        raise ValueError(f"collect={collect!r}: expected 'all' or 'rhat'")
    half = n // 2

    def runner(state: StretchState, words, n_gens: int, t0: int):
        d = state.x.shape[1]
        dtype, device = state.x.dtype, state.x.device
        G = max(1, min(int(kernel_gens), n_gens))
        q, r = divmod(n_gens, G)
        st = state
        rc = rhat_init(n, d, dtype, device)
        xs, lps, accs = [], [], []
        for c0, g in [(t0 + c * G, G) for c in range(q)] + (
                [(t0 + q * G, r)] if r else []):
            j, z, log_u = chunk_words(words, c0, g, n, d, cfg.a, dtype,
                                      device)
            xh, lph, acc = fused_stretch(st.x, st.logp, j, z, log_u,
                                         log_prob, half)
            st = StretchState(x=xh[-1], logp=lph[-1], gen=st.gen + g)
            if collect == "all":
                xs.append(xh)
            else:
                rc = rhat_update_block(rc, xh)
            lps.append(lph)
            accs.append(acc)
        hist = {"logp": torch.cat(lps), "accepted": torch.cat(accs)}
        if collect == "all":
            hist["x"] = torch.cat(xs)
        else:
            hist["rhat"] = rc
        return st, hist

    # the contract ChainPool.run_until checks at its entry: no alignment
    # or chunk-length constraint; the history records state.x
    runner.align = 1
    runner.chunk_multiple = 1
    runner.position_field = "x"
    return runner
