"""Kernel B5: pairwise squared distances for the GP's Gram matrix.

Counterpart of ``bipymc_tpu/ops/pallas_kernels.py``. ``‖a‖² + ‖b‖² −
2 a·bᵀ``, clamped at 0, in full float32: the cross term must not go
through TF32 (the reference asks for ``Precision.HIGHEST``), because the
cancellation in the expansion turns a 1e-3 relative error of the product
into absolute distance errors of ~0.1, enough to ruin a Gram matrix.

:func:`sqdist_plain` is the plain PyTorch version (the reference's
``_sqdist_xla``); the kernel is ``bipymc_tpu_torch/csrc/sqdist.cu``.
Both take an optional leading batch axis, ``[C, n, k] × [C, m, k] →
[C, n, m]``: the port's form of the reference's ``vmap`` over chains.
:func:`sqdist` is the kernel's wrapper (a CPU tensor takes the plain
version, a CUDA tensor the kernel, or the call raises);
:func:`pairwise_sqdist` is the dispatcher the GP kernels call.

:func:`sqdist` goes through a ``torch.autograd.Function`` whose backward
is the reference's ``_sqdist_pallas_bwd``: dA = 2(A ⊙ Σⱼg − gB), dB =
2(B ⊙ Σᵢg − gᵀA), two matrix products that the reference leaves to XLA
and the port to ``torch.matmul``, in full float32 (TF32 off:
:func:`require_full_float32` raises otherwise). A CPU tensor takes the
plain forward through the same Function.
"""

import torch

from bipymc_tpu_torch.ops import _build

MIN_KERNEL_ELEMS = 128 * 128    # the reference's gate: n·m ≥ 128²


def sqdist_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``max(‖a‖² + ‖b‖² − 2 a·bᵀ, 0)``: A [..., n, k], B [..., m, k] →
    [..., n, m], in A's dtype (the matrix product in full precision)."""
    a_nrm = torch.sum(A * A, dim=-1, keepdim=True)
    b_nrm = torch.sum(B * B, dim=-1, keepdim=True)
    cross = torch.matmul(A, B.transpose(-1, -2))
    return torch.clamp_min(a_nrm + b_nrm.transpose(-1, -2) - 2.0 * cross,
                           0.0)


def require_full_float32(t: torch.Tensor) -> None:
    """Raise where a float32 matrix product on ``t``'s device may run in
    TF32: the gradients of B5 to B8 need full float32 products, as the
    reference's ``Precision.HIGHEST`` gives them (PyTorch's default)."""
    if t.device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matrix products are on (torch.backends.cuda.matmul."
            "allow_tf32 or set_float32_matmul_precision); the GP kernels' "
            "gradients need full float32")


def _sqdist_kernel(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/sqdist.cu`` on float32 CUDA [C, n, k] × [C, m, k]."""
    A, B = A.contiguous(), B.contiguous()
    c, n, k = A.shape
    m = B.shape[1]
    out = torch.empty((c, n, m), dtype=torch.float32, device=A.device)
    if out.numel():
        err = _build.library("sqdist")(
            A.data_ptr(), B.data_ptr(), out.data_ptr(), c, n, m, k,
            torch.cuda.current_stream(A.device).cuda_stream)
        _build.check(err, "sqdist")
        sqdist.launches += 1
    return out


class _Sqdist(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B):
        ctx.save_for_backward(A, B)
        if A.device.type == "cpu":
            return sqdist_plain(A, B)
        batched = A.dim() == 3
        out = _sqdist_kernel(A if batched else A[None],
                             B if batched else B[None])
        return out if batched else out[0]

    @staticmethod
    def backward(ctx, g):
        # r²_ij = Σ_k (A_ik − B_jk)² ⇒ dA = 2 (A ⊙ Σ_j g_ij − g B),
        # dB = 2 (B ⊙ Σ_i g_ij − gᵀ A); the clamp at 0 is not
        # differentiated, as in the reference
        A, B = ctx.saved_tensors
        require_full_float32(g)
        dA = 2.0 * (A * torch.sum(g, dim=-1)[..., None] - g @ B)
        dB = 2.0 * (B * torch.sum(g, dim=-2)[..., None]
                    - g.transpose(-1, -2) @ A)
        return dA, dB


def sqdist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kernel B5: :func:`sqdist_plain` of float32 A [n, k] or [C, n, k]
    and B [m, k] or [C, m, k], differentiable. ``sqdist.launches`` counts
    the kernel's launches."""
    if A.dim() != B.dim() or A.dim() not in (2, 3) or \
            A.shape[-1] != B.shape[-1] or A.shape[:-2] != B.shape[:-2]:
        raise ValueError(f"sqdist takes [n, k] × [m, k] or [C, n, k] × "
                         f"[C, m, k], got {tuple(A.shape)} and "
                         f"{tuple(B.shape)}")
    if not (A.device.type == "cpu" and B.device.type == "cpu"):
        if A.device.type != "cuda" or B.device != A.device:
            raise ValueError(f"sqdist: no kernel for devices {A.device} "
                             f"and {B.device}")
        if A.dtype != torch.float32 or B.dtype != torch.float32:
            raise TypeError(f"sqdist takes float32 on the card, got "
                            f"{A.dtype} and {B.dtype}")
    return _Sqdist.apply(A, B)


sqdist.launches = 0


def pairwise_sqdist(X: torch.Tensor,
                    X2: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise squared Euclidean distances: X [..., n, k], X2 [..., m, k]
    → [..., n, m].

    Centres both inputs on the mean of X (distance-invariant) to tame the
    float32 cancellation of the expansion. float64 inputs keep their
    precision on the plain path. Kernel B5 takes a CUDA problem with
    n·m ≥ 128² (the reference's gate, "tpu" read as "cuda"; its VMEM
    budget has no counterpart here), the plain version the rest.
    """
    X2 = X if X2 is None else X2
    mu = torch.mean(X, dim=-2, keepdim=True)
    A = X - mu
    B = X2 - mu
    if A.dtype == torch.float64:
        return sqdist_plain(A, B)
    A = A.to(torch.float32)
    B = B.to(torch.float32)
    if A.device.type == "cuda" and \
            A.shape[-2] * B.shape[-2] >= MIN_KERNEL_ELEMS:
        return sqdist(A, B)
    return sqdist_plain(A, B)
