"""Kernel B8: blocked triangular solves with a lower-triangular L.

Counterpart of ``bipymc_tpu/ops/pallas_solve.py``: :func:`tri_solve`
(``x = L⁻¹ b``, forward substitution), :func:`tri_solve_t` (``y = L⁻ᵀ c``,
backward substitution) and :func:`solve_chol` (``(L Lᵀ)⁻¹ b``, the two
composed). L is ``[n, n]`` or ``[B, n, n]``; the right-hand side is
``[n]``, ``[n, m]`` or, with a batch, ``[B, n]`` or ``[B, n, m]`` (an
``[n, n]`` L is shared by a ``[B, n, m]`` batch). One CUDA source,
``bipymc_tpu_torch/csrc/trisolve.cu``, serves both directions, and
``tri_solve.launches`` counts its launches through either.

The plain versions, :func:`tri_solve_plain` and :func:`tri_solve_t_plain`,
are ``torch.linalg.solve_triangular``. A CPU tensor takes them; a CUDA
tensor the kernel (float32, n ≤ 4096), or the call raises. The kernel's
entry point sizes its launch from n and m: the right-hand-side columns a
block takes, and the tiles of L it holds in shared memory at once (all
of the lower triangle's off-diagonal tiles up to n = 256, a ring of them
refilled as the steps consume them above); :func:`plan` mirrors it, for
the CPU tests of the fit.

Both directions are differentiable through ``torch.autograd.Function``s
with the reference's gradients (``:194-223``), and each direction's
backward is the other direction's kernel, as on the TPU:
``tri_solve``: b̄ = L⁻ᵀ x̄, L̄ = −tril(b̄ xᵀ); ``tri_solve_t``: c̄ = w =
L⁻¹ ȳ, L̄ = −tril(y wᵀ). On the CPU both run through the same Functions
with the plain forward, so the CPU tests run the backward the card runs.
"""

import functools
from typing import NamedTuple

import torch

from bipymc_tpu_torch.ops import _build
from bipymc_tpu_torch.ops.pallas_kernels import require_full_float32

MAX_N = 4096        # the kernel keeps n x 8 floats of b in shared memory
TILE = 32           # the kernel's block rows
TILE_BYTES = TILE * (TILE + 4) * 4      # a tile in shared memory (rows of 36)
SMEM_PER_BLOCK = 232448                 # what an H100 block may take
WARPS = 8           # a block's warps, and its diagonal inverses at a time
MAX_COLS = 8        # right-hand-side columns a block


class Plan(NamedTuple):
    """B8's launch for L [n, n] and m right-hand-side columns: the columns
    a block takes (``cols``, a template argument of the kernel), its
    blocks along m, the tiles of L in its shared memory at once
    (``ring``), the tiles a step reads between refills (``chunk``), and
    its shared memory in bytes."""
    cols: int
    blocks: int
    ring: int
    chunk: int
    smem: int


@functools.cache
def plan(n: int, m: int) -> Plan:
    """B8's launch for L [n, n] and m columns, a function of n and m, as
    ``csrc/trisolve.cu::trisolve_launch`` derives it.

    A block takes one column at m = 1 and eight otherwise (2 ≤ m < 8,
    which no path sends, pads to eight with columns of zeros). It holds
    its columns' n rows of b (rows of ``cols`` floats), eight diagonal
    blocks and their inverses, the warps' partial sums and as many of the
    lower triangle's nb(nb−1)/2 off-diagonal tiles as fit beside them,
    each with an 8-byte mbarrier: all of them where they fit (n ≤ 256;
    then no refill, ``chunk`` = nb), else a ring refilled half at a
    time."""
    nb = -(-n // TILE)
    cols = 1 if m == 1 else MAX_COLS
    tiles = nb * (nb - 1) // 2
    fixed = (2 * WARPS * TILE_BYTES + nb * TILE * cols * 4
             + WARPS * cols * TILE * 4)
    ring = min(tiles, (SMEM_PER_BLOCK - fixed - 16) // (TILE_BYTES + 8))
    chunk = max(nb, 1) if ring == tiles else max(ring // 2, 1)
    smem = (ring + 1) // 2 * 16 + ring * TILE_BYTES + fixed
    return Plan(cols, -(-m // cols), ring, chunk, smem)


def tri_solve_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L⁻¹ b by ``torch.linalg.solve_triangular`` (a vector b [n] is
    broadcast over a batch of L)."""
    vec = b.dim() == 1 or b.dim() == L.dim() - 1
    out = torch.linalg.solve_triangular(L, b[..., None] if vec else b,
                                        upper=False)
    return out[..., 0] if vec else out


def tri_solve_t_plain(L: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """L⁻ᵀ c by ``torch.linalg.solve_triangular``."""
    vec = c.dim() == 1 or c.dim() == L.dim() - 1
    out = torch.linalg.solve_triangular(L.transpose(-1, -2),
                                        c[..., None] if vec else c,
                                        upper=True)
    return out[..., 0] if vec else out


def _check(L: torch.Tensor, b: torch.Tensor) -> None:
    n = L.shape[-1]
    ok = L.dim() in (2, 3) and L.shape[-2] == n and b.dim() >= 1
    if ok and b.dim() == L.dim() - 1:                 # vectors
        ok = b.shape == L.shape[:-1]
    elif ok:
        ok = (b.dim() == 3 if L.dim() == 3 else b.dim() in (2, 3)) and \
            b.shape[-2] == n and (L.dim() == 2 or b.shape[0] == L.shape[0])
    if not ok:
        raise ValueError(f"B8 takes L [n, n] with b [n], [n, m] or "
                         f"[B, n, m], or L [B, n, n] with b [B, n] or "
                         f"[B, n, m]; got {tuple(L.shape)} and "
                         f"{tuple(b.shape)}")
    if L.device.type == "cpu" and b.device.type == "cpu":
        return
    if L.device.type != "cuda" or b.device != L.device:
        raise ValueError(f"B8: no kernel for devices {L.device} and "
                         f"{b.device}")
    if L.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"B8 takes float32 on the card, got {L.dtype} and "
                        f"{b.dtype}")
    if n > MAX_N:
        raise ValueError(f"B8 takes n <= {MAX_N}, got {n}")


def _solve(L: torch.Tensor, b: torch.Tensor,
           transposed: bool) -> torch.Tensor:
    """One direction: the plain version on the CPU, the kernel on CUDA."""
    if L.device.type == "cpu":
        return (tri_solve_t_plain if transposed else tri_solve_plain)(L, b)
    vec = b.dim() == L.dim() - 1
    b3 = b[..., None] if vec else b
    b3 = (b3 if b3.dim() == 3 else b3[None]).contiguous()
    L = L.contiguous()
    batch, n, m = b3.shape
    x = torch.empty_like(b3)
    if x.numel():
        err = _build.library("trisolve")(
            L.data_ptr(), b3.data_ptr(), x.data_ptr(), batch, n, m,
            n * n if L.dim() == 3 else 0, int(transposed),
            torch.cuda.current_stream(L.device).cuda_stream)
        _build.check(err, "trisolve")
        tri_solve.launches += 1
    return x.reshape(b.shape)


def _outer(u: torch.Tensor, v: torch.Tensor, vec: bool) -> torch.Tensor:
    """u vᵀ per batch entry: outer products of vectors, or u @ vᵀ."""
    if vec:
        return u[..., :, None] * v[..., None, :]
    return u @ v.transpose(-1, -2)


class _TriSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, b, transposed):
        x = _solve(L, b, transposed)
        ctx.save_for_backward(L, x)
        ctx.transposed = transposed
        return x

    @staticmethod
    def backward(ctx, x_bar):
        L, x = ctx.saved_tensors
        require_full_float32(L)
        vec = x.dim() == L.dim() - 1
        # the cotangent of the right-hand side is the other direction's
        # solve; L's is minus the lower triangle of an outer product
        w = _solve(L, x_bar.contiguous(), not ctx.transposed)
        outer = _outer(x, w, vec) if ctx.transposed else _outer(w, x, vec)
        L_bar = -torch.tril(outer)
        if L_bar.dim() > L.dim():            # one L shared by the batch
            L_bar = L_bar.sum(0)
        return L_bar, w, None


def tri_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel B8, forward substitution: x = L⁻¹ b. Differentiable.
    ``tri_solve.launches`` counts the kernel's launches, both
    directions."""
    _check(L, b)
    return _TriSolve.apply(L, b, False)


def tri_solve_t(L: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Kernel B8, backward substitution: y = L⁻ᵀ c. Differentiable."""
    _check(L, c)
    return _TriSolve.apply(L, c, True)


def solve_chol(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ b from the lower Cholesky factor: two B8 launches."""
    return tri_solve_t(L, tri_solve(L, b))


tri_solve.launches = 0
