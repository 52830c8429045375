"""Kernel B7: the Cholesky factor of one SPD matrix, and the Cholesky
adjoint that B6 and B7 share.

Counterpart of ``bipymc_tpu/ops/pallas_chol.py``. :func:`cholesky_pallas`
is the kernel's wrapper: ``chol(a)`` of a float32 ``[n, n]`` matrix, or of
a ``[C, n, n]`` batch (the reference ``vmap``s onto its grid; here the
batch is a grid axis of the same launch), n ≤ 1024 (the reference's gate,
``gp/regressor.py:277-279``). Unlike B6, which gives one matrix one
block, B7 spreads each matrix over many blocks, by one of two routes that
:func:`plan` picks from n before the launch: for n ≤ 480,
``bipymc_tpu_torch/csrc/chol.cu``, one thread-block cluster a matrix with
the factor in the cluster's shared memory; above, where the cluster's
shared memory does not hold it, ``csrc/chol_coop.cu``, one cooperative
launch with a grid barrier between panel steps, L factored in place in
device memory.

:func:`cholesky_plain` is the plain version: ``torch.linalg.cholesky_ex``
with the whole matrix NaN where ``info`` ≠ 0, as B6's plain version does
(``torch.linalg.cholesky`` would raise); the kernel sets NaN from a flag
read after the last column, so it never traps.

Both go through one ``torch.autograd.Function``, :class:`Cholesky`,
which B6's L-only entry shares; its backward is :func:`chol_adjoint`,
the reference's ``_chol_bwd_impl`` (Murray 2016) batched over leading
axes, which B6's solving entry uses too. A CPU tensor
takes the plain forward through the same Function, so the CPU tests run
the backward the card runs. ``cholesky_pallas.launches`` counts the
kernel's launches.
"""

import functools
from typing import NamedTuple

import torch

from bipymc_tpu_torch.ops import _build
from bipymc_tpu_torch.ops.pallas_kernels import require_full_float32

MAX_N = 1024        # the reference's gate for the single-matrix kernel
TILE = 32           # the kernels' tile and panel width
TILE_BYTES = TILE * (TILE + 4) * 4      # a tile in shared memory (rows of 36)
SMEM_PER_BLOCK = 232448                 # what an H100 block may take
CLUSTER_MAX = 8                         # the portable cluster size
CLUSTER_MAX_N = 480                     # the cluster route's largest n
COOP_SMEM = 3 * TILE * (TILE + 1) * 4 + TILE * 4 + 4   # chol_coop.cu's static


class Plan(NamedTuple):
    """B7's launch for one n: the route ("cluster" or "cooperative"), the
    CTAs of a cluster (1 on the cooperative route), the most tiles one CTA
    holds and the shared memory of a CTA in bytes."""
    route: str
    cluster: int
    own_tiles: int
    smem: int


def owner(i: int, p: int) -> int:
    """The CTA of a p-CTA cluster that holds block row i: the rows dealt
    in a snake, 0..p-1 then p-1..0, as ``csrc/chol.cu::owner``."""
    g, r = divmod(i, p)
    return p - 1 - r if g % 2 else r


@functools.cache
def plan(n: int) -> Plan:
    """B7's route for an [n, n] matrix, a function of n alone. The
    cluster route takes n ≤ 480: P = min(nb, 8) CTAs (nb = ⌈n/32⌉ block
    rows), each holding its block rows' tiles of the lower triangle, two
    slots (by the step's parity) for each panel tile the others push to
    it, and two tiles and 64 floats for the diagonal tile's Lᵀ and
    reciprocals; at n = 512 that would be 235 KB, more than a block may
    take. ``csrc/chol.cu::chol_launch`` derives the cluster and the
    shared memory itself from n, with the kernel's own ``owner``; the
    plan's copy picks the route and lets the CPU tests check the fit."""
    nb = -(-n // TILE)
    if n <= CLUSTER_MAX_N:
        p = min(nb, CLUSTER_MAX)
        own = max(sum(i + 1 for i in range(nb) if owner(i, p) == c)
                  for c in range(p))
        return Plan("cluster", p, own,
                    (own + 2 * nb + 2) * TILE_BYTES + 2 * TILE * 4)
    return Plan("cooperative", 1, 0, COOP_SMEM)


def _phi(x: torch.Tensor) -> torch.Tensor:
    """Φ(X) = tril(X) with the diagonal halved, over the last two axes."""
    return torch.tril(x) - 0.5 * torch.diag_embed(
        torch.diagonal(x, dim1=-2, dim2=-1))


def chol_adjoint(L: torch.Tensor, Lbar: torch.Tensor) -> torch.Tensor:
    """Ā of L = chol(A), batched over leading axes (Murray 2016):
    ¼ · sym(L⁻ᵀ (Φ(LᵀL̄) + Φ(LᵀL̄)ᵀ) L⁻¹), as two triangular solves.

    The ¼ (not ½) is the reference's convention, which matches JAX's
    cotangent for ``jnp.linalg.cholesky``: symmetric, with half the
    sensitivity on each of the (i, j) / (j, i) mirror entries. The solves
    are ``torch.linalg.solve_triangular``, as the reference leaves them to
    XLA; the product LᵀL̄ runs in full float32."""
    require_full_float32(L)
    Lt = L.transpose(-1, -2)
    p = _phi(Lt @ Lbar)
    sym = p + p.transpose(-1, -2)
    # S = L⁻ᵀ sym L⁻¹: solve Lᵀ X = sym, then Lᵀ Sᵀ = Xᵀ
    x = torch.linalg.solve_triangular(Lt, sym, upper=True)
    s = torch.linalg.solve_triangular(Lt, x.transpose(-1, -2),
                                      upper=True).transpose(-1, -2)
    return 0.25 * (s + s.transpose(-1, -2))


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """``chol(a)`` of [..., n, n]; a matrix that is not positive definite
    comes back all NaN."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _chol_kernel(a: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """Launch B7 on a float32 CUDA [C, n, n] batch, by :func:`plan`'s route
    (``route="cooperative"`` forces that route at any n, to time the two
    in turns)."""
    a = a.contiguous()
    c, n, _ = a.shape
    L = torch.empty_like(a)
    if not L.numel():
        return L
    p = plan(n)
    route = route or p.route
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if route == "cluster" and p.route == "cluster":
        err = _build.library("chol")(a.data_ptr(), L.data_ptr(), c, n,
                                     stream)
        _build.check(err, "chol")
    elif route == "cooperative":
        # scratch of the launch's groups of blocks (at most one a matrix):
        # the solved panel, double-buffered, and the grid barrier's two
        # counters, which start at 0
        panel = torch.empty((c, 2, n, 32), dtype=torch.float32,
                            device=a.device)
        bar = torch.zeros((c, 2), dtype=torch.int32, device=a.device)
        err = _build.library("chol_coop")(
            a.data_ptr(), L.data_ptr(), panel.data_ptr(), bar.data_ptr(), c,
            n, stream)
        _build.check(err, "chol_coop")
    else:
        raise ValueError(f"B7 has no {route!r} route at n={n}")
    cholesky_pallas.launches += 1
    return L


def _check(a: torch.Tensor) -> None:
    if a.dim() not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"B7 takes [n, n] or [C, n, n], got "
                         f"{tuple(a.shape)}")
    if a.device.type == "cpu":
        return
    if a.device.type != "cuda":
        raise ValueError(f"B7: no kernel for device {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"B7 takes float32 on the card, got {a.dtype}")
    if a.shape[-1] > MAX_N:
        raise ValueError(f"B7 takes n <= {MAX_N}, got {a.shape[-1]}")


class Cholesky(torch.autograd.Function):
    """``L = forward(a)``, a Cholesky factor, differentiated by
    :func:`chol_adjoint`: B6's L-only entry and B7 differ only in the
    forward they pass."""

    @staticmethod
    def forward(ctx, a, forward):
        L = forward(a)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        return chol_adjoint(L, Lbar), None


def _forward(a: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return cholesky_plain(a)
    L = _chol_kernel(a if a.dim() == 3 else a[None])
    return L if a.dim() == 3 else L[0]


def cholesky_pallas(a: torch.Tensor) -> torch.Tensor:
    """Kernel B7: the lower Cholesky factor of SPD ``a`` [n, n] or of each
    matrix of ``a`` [C, n, n] (only the lower triangle is read); all NaN
    for a matrix that is not positive definite. Differentiable."""
    _check(a)
    return Cholesky.apply(a, _forward)


cholesky_pallas.launches = 0
