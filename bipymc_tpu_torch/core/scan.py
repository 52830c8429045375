"""Time-axis drivers: a host loop over generations.

Counterpart of ``bipymc_tpu/core/scan.py``. The JAX package compiles the
loop into one ``lax.scan`` and folds a key per step; PyTorch runs
eagerly, so the loop is a Python ``for`` and the randomness comes from a
generator that the step function closes over and advances. ``t`` is
still the global step index, offset by ``t0`` for continued runs, and
``thin`` keeps every ``thin``-th collection.

Collected tensors go into a history buffer allocated at the first kept
step, ``[n_kept, *shape]`` on the collected tensor's device, so the loop
copies each kept row once and never synchronises with the device.
"""

from typing import Callable

import torch


def _default_collect(state, info):
    return info._asdict() if hasattr(info, "_asdict") else info


def run_scan(step_fn: Callable, state, n_steps: int, collect_fn=None,
             t0: int = 0):
    """Run ``step_fn(state, t) -> (state, info)`` for ``n_steps`` steps.

    Returns ``(final_state, history)`` with history a dict of
    ``[n_steps, ...]`` tensors from ``collect_fn(state, info)`` (default:
    the info's fields).
    """
    return run_scan_thinned(step_fn, state, n_steps, 1, collect_fn, t0)


def run_scan_thinned(step_fn: Callable, state, n_steps: int, thin: int,
                     collect_fn=None, t0: int = 0):
    """Like :func:`run_scan` but keeps every ``thin``-th collection.

    ``n_steps`` must be a multiple of ``thin``; the history holds
    ``n_steps // thin`` rows, taken after steps ``t0 + thin − 1``,
    ``t0 + 2·thin − 1``, … as in the JAX package.
    """
    if n_steps % thin != 0:
        raise ValueError(f"n_steps={n_steps} not a multiple of thin={thin}")
    collect_fn = collect_fn or _default_collect
    n_kept = n_steps // thin
    hist = None
    for k in range(n_kept):
        for i in range(thin):
            state, info = step_fn(state, t0 + k * thin + i)
        row = collect_fn(state, info)
        if hist is None:
            hist = {name: torch.empty((n_kept,) + tuple(v.shape),
                                      dtype=v.dtype, device=v.device)
                    for name, v in row.items()}
        for name, v in row.items():
            hist[name][k].copy_(v)
    return state, hist if hist is not None else {}
