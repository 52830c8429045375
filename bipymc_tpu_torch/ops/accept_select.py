"""Kernel B10: the DREAM-zs Metropolis tail for every chain, and its
dispatcher.

Counterpart of ``bipymc_tpu/ops/accept_select.py::accept_select_pallas``:
log α = min(0, (logp* − logp) + log_jac), a non-finite logp* rejected,
accept where log u < log α; x and logp selected by the accept bit, and
logp_sum + logp_new. The kernel is
``bipymc_tpu_torch/csrc/accept_select.cu`` (one warp a chain, the kept row
copied as bytes); its plain version is :func:`accept_select_reference`,
the ops the per-generation step runs by default in the same order. Every
op is exact, so the two are bit-equal.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises. ``accept_select.launches`` counts the
kernel's launches. ``n = 0`` gives empty results and launches nothing.
"""

import torch

from bipymc_tpu_torch.ops import _build
from bipymc_tpu_torch.ops.fused_chunk import metropolis_select

DTYPES = (torch.float32, torch.float64)


def accept_select_reference(x, x_star, logp, logp_star, log_jac, log_u,
                            logp_sum):
    """The plain version: ``metropolis_select``, then ``logp_sum +
    logp_new``. Returns (x_new [n, d], logp_new [n], logp_sum_new [n],
    accepted [n] bool)."""
    x_new, logp_new, acc, _ = metropolis_select(x, logp, x_star, logp_star,
                                                log_jac, log_u)
    return x_new, logp_new, logp_sum + logp_new, acc


def accept_select(x, x_star, logp, logp_star, log_jac, log_u, logp_sum):
    """The accept and state update of one generation for all chains.

    x, x_star: [n, d]; logp, logp_star, log_jac, log_u, logp_sum: [n].
    Returns (x_new, logp_new, logp_sum_new, accepted [n] bool); x_new is
    a new tensor. On the card every operand is float32, or every one
    float64; x and x_star may have any row stride with unit stride along
    d, and the [n] vectors must be contiguous.
    """
    vecs = (logp, logp_star, log_jac, log_u, logp_sum)
    _check(x, x_star, vecs)
    if x.device.type == "cpu":
        return accept_select_reference(x, x_star, *vecs)
    _check_cuda(x, x_star, vecs)
    n, d = x.shape
    x_new = torch.empty((n, d), dtype=x.dtype, device=x.device)
    logp_new = torch.empty(n, dtype=x.dtype, device=x.device)
    logp_sum_new = torch.empty_like(logp_new)
    accepted = torch.empty(n, dtype=torch.bool, device=x.device)
    if n == 0:
        return x_new, logp_new, logp_sum_new, accepted
    err = _build.library("accept_select")(
        x.data_ptr(), x.stride(0), x_star.data_ptr(), x_star.stride(0), d,
        x.element_size(), *(v.data_ptr() for v in vecs), n,
        x_new.data_ptr(), logp_new.data_ptr(), logp_sum_new.data_ptr(),
        accepted.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "accept_select")
    accept_select.launches += 1
    return x_new, logp_new, logp_sum_new, accepted


accept_select.launches = 0

_NAMES = ("logp", "logp_star", "log_jac", "log_u", "logp_sum")


def _check(x, x_star, vecs):
    if x.dim() != 2 or x_star.shape != x.shape:
        raise ValueError(f"x and x_star must be the same [n, d], got "
                         f"{tuple(x.shape)} and {tuple(x_star.shape)}")
    n = x.shape[0]
    for name, v in zip(_NAMES, vecs):
        if v.shape != (n,):
            raise ValueError(f"{name} must be [n] = [{n}], got "
                             f"{tuple(v.shape)}")
    for name, t in (("x_star", x_star), *zip(_NAMES, vecs)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device} but x on {x.device}")


def _check_cuda(x, x_star, vecs):
    if x.dtype not in DTYPES:
        raise TypeError(f"x: no kernel for dtype {x.dtype}; takes "
                        f"{', '.join(map(str, DTYPES))}")
    for name, t in (("x_star", x_star), *zip(_NAMES, vecs)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} but x is {x.dtype}: the "
                            "kernel takes every operand in one dtype")
    if x.device.type != "cuda":
        raise ValueError(f"accept_select: no kernel for device {x.device}")
    for name, t in (("x", x), ("x_star", x_star)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} must have unit stride along d")
    for name, v in zip(_NAMES, vecs):
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
