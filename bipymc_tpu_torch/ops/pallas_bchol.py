"""Kernel B6: the batched Cholesky, with the GP's forward solve woven in.

Counterpart of ``bipymc_tpu/ops/pallas_bchol.py``.
:func:`cholesky_solve_batched` returns ``(L, z) = (chol(A), L⁻¹y)`` for a
batch of SPD systems, which is all the GP log-ML needs (``yᵀK⁻¹y =
‖z‖²``, ``log|K| = 2 Σ log L_ii``); :func:`cholesky_batched` returns L
alone. One CUDA source, ``bipymc_tpu_torch/csrc/bchol.cu``, serves both,
and its L is bit-equal between them, as the reference's is.

The plain version, :func:`cholesky_solve_plain`, is B7's plain
``cholesky_ex`` + ``solve_triangular``: the JAX package's own route off
the TPU (``gp/regressor.py:127-136``). A matrix that is not positive
definite comes back all NaN (L and z) on both: the plain version reads
``cholesky_ex``'s ``info`` (``torch.linalg.cholesky`` would raise
instead), and the kernel sets NaN where a pivot is not > 0. The
reference's ``rsqrt`` of a negative pivot gives NaN too, from that column
on, so a sampler rejects the chain either way.

A CPU tensor takes the plain version; a CUDA tensor the kernel, or the
call raises. Both entry points are ``torch.autograd.Function``s with the
reference's gradients: the Cholesky adjoint shared with B7
(:func:`bipymc_tpu_torch.ops.pallas_chol.chol_adjoint`) and, for the
solve, ``_cs_bwd`` (``:301-315``): ȳ = L⁻ᵀ z̄, and L̄ gains −(L⁻ᵀ z̄) zᵀ.
A CPU tensor runs the plain forward through the same Functions.
``cholesky_solve_batched.launches`` counts the kernel's launches through
either entry point, and ``cholesky_solve_batched.last_plan`` is the
:class:`Plan` the last launch took: ``P`` CTAs of a thread-block cluster
a matrix (2 where the batch leaves SMs idle, else 1) and the bytes of
shared memory a CTA, from ``csrc/bchol_plan.cuh``.
:func:`plan` reads the same plan through the card's entry point; there is
no Python copy of it.
"""

import ctypes
from typing import NamedTuple

import torch

from bipymc_tpu_torch.ops import _build
from bipymc_tpu_torch.ops.pallas_chol import (Cholesky, chol_adjoint,
                                              cholesky_plain)

MAX_N = 1600        # the kernel keeps its panel, ~n x 32 floats, in smem


class Plan(NamedTuple):
    """B6's launch (``csrc/bchol_plan.cuh``): CTAs a matrix, dynamic
    shared memory bytes a CTA."""
    P: int
    smem: int


def plan(b: int, n: int) -> Plan:
    """The plan B6 takes for b matrices of n x n on the current card, read
    from the C plan through ``csrc/bchol.cu::bchol_plan``."""
    out = (ctypes.c_int * 2)()
    err = _build.library("bchol_plan")(b, n, ctypes.addressof(out))
    _build.check(err, "bchol")
    return Plan(*out)


_LAST_PLAN = (ctypes.c_int * 2)()      # written by each launch


def cholesky_solve_plain(a: torch.Tensor, y: torch.Tensor | None = None):
    """``chol(a)`` of a [..., n, n] batch, and ``L⁻¹y`` for y [..., n]
    when given: ``(L, z)``, or L alone. Non-PD matrices → all NaN."""
    L = cholesky_plain(a)
    if y is None:
        return L
    z = torch.linalg.solve_triangular(L, y[..., None], upper=False)[..., 0]
    return L, z


def _bchol_kernel(a: torch.Tensor, y: torch.Tensor | None):
    """Launch ``csrc/bchol.cu`` on a float32 CUDA batch."""
    a = a.contiguous()
    b, n, _ = a.shape
    L = torch.empty_like(a)
    z = None
    if y is not None:
        y = y.contiguous()
        z = torch.empty_like(y)
    if L.numel():
        err = _build.library("bchol")(
            a.data_ptr(), 0 if y is None else y.data_ptr(), L.data_ptr(),
            0 if z is None else z.data_ptr(), b, n,
            torch.cuda.current_stream(a.device).cuda_stream,
            ctypes.addressof(_LAST_PLAN))
        _build.check(err, "bchol")
        cholesky_solve_batched.launches += 1
        cholesky_solve_batched.last_plan = Plan(*_LAST_PLAN)
    return L, z


def _forward(a, y):
    if a.device.type == "cpu":
        out = cholesky_solve_plain(a, y)
        return (out, None) if y is None else out
    return _bchol_kernel(a, y)


class _CholeskySolveBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, y):
        L, z = _forward(a, y)
        ctx.save_for_backward(L, z)
        return L, z

    @staticmethod
    def backward(ctx, Lbar, zbar):
        # z = L⁻¹y: dz = L⁻¹(dy − dL z) ⇒ ȳ = L⁻ᵀ z̄, and the Cholesky
        # cotangent gains −(L⁻ᵀ z̄) zᵀ (the adjoint's Φ keeps its lower part)
        L, z = ctx.saved_tensors
        w = torch.linalg.solve_triangular(L.transpose(-1, -2),
                                          zbar[..., None], upper=True)
        return chol_adjoint(L, Lbar - w * z[..., None, :]), w[..., 0]


def _check(a: torch.Tensor, y: torch.Tensor | None) -> None:
    if a.dim() != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"B6 takes a [b, n, n] batch, got "
                         f"{tuple(a.shape)}")
    if y is not None and y.shape != a.shape[:2]:
        raise ValueError(f"y must be {tuple(a.shape[:2])}, got "
                         f"{tuple(y.shape)}")
    if a.device.type == "cpu" and (y is None or y.device.type == "cpu"):
        return
    if a.device.type != "cuda" or (y is not None and y.device != a.device):
        raise ValueError(f"B6: no kernel for device {a.device}")
    if a.dtype != torch.float32 or (y is not None
                                    and y.dtype != torch.float32):
        raise TypeError("B6 takes float32 on the card")
    if a.shape[-1] > MAX_N:
        raise ValueError(f"B6 takes n <= {MAX_N} on the card, got "
                         f"{a.shape[-1]}")


def cholesky_solve_batched(a: torch.Tensor, y: torch.Tensor | None = None):
    """Kernel B6 on a float32 batch a [b, n, n] (only the lower triangle
    is read), and y [b, n] when given: ``(L, z) = (chol(a), L⁻¹y)``, or L
    alone (``cholesky_solve_batched_pallas``). Differentiable."""
    _check(a, y)
    if y is None:
        return Cholesky.apply(a, lambda a: _forward(a, None)[0])
    return _CholeskySolveBatched.apply(a, y)


cholesky_solve_batched.launches = 0
cholesky_solve_batched.last_plan = None


def cholesky_batched(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a batch of SPD matrices [b, n, n]
    (``cholesky_batched_pallas``)."""
    return cholesky_solve_batched(a)
