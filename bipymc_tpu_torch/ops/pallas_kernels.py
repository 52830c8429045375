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

Forward only: the reference's custom VJP (``_sqdist_pallas_bwd``) is not
ported, so autograd through the kernel raises.
"""

import torch

from bipymc_tpu_torch.ops import _build

VJP_ITEM = "ROADMAP Queue A item 12 (GP: the B5/B6 VJPs that optimize needs)"
MIN_KERNEL_ELEMS = 128 * 128    # the reference's gate: n·m ≥ 128²


def sqdist_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``max(‖a‖² + ‖b‖² − 2 a·bᵀ, 0)``: A [..., n, k], B [..., m, k] →
    [..., n, m], in A's dtype (the matrix product in full precision)."""
    a_nrm = torch.sum(A * A, dim=-1, keepdim=True)
    b_nrm = torch.sum(B * B, dim=-1, keepdim=True)
    cross = torch.matmul(A, B.transpose(-1, -2))
    return torch.clamp_min(a_nrm + b_nrm.transpose(-1, -2) - 2.0 * cross,
                           0.0)


def sqdist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kernel B5: :func:`sqdist_plain` of float32 A [n, k] or [C, n, k]
    and B [m, k] or [C, m, k]. ``sqdist.launches`` counts the kernel's
    launches."""
    if A.dim() != B.dim() or A.dim() not in (2, 3) or \
            A.shape[-1] != B.shape[-1] or A.shape[:-2] != B.shape[:-2]:
        raise ValueError(f"sqdist takes [n, k] × [m, k] or [C, n, k] × "
                         f"[C, m, k], got {tuple(A.shape)} and "
                         f"{tuple(B.shape)}")
    if A.device.type == "cpu" and B.device.type == "cpu":
        return sqdist_plain(A, B)
    if A.device.type != "cuda" or B.device != A.device:
        raise ValueError(f"sqdist: no kernel for devices {A.device} and "
                         f"{B.device}")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError(f"sqdist takes float32 on the card, got {A.dtype} "
                        f"and {B.dtype}")
    if torch.is_grad_enabled() and (A.requires_grad or B.requires_grad):
        raise NotImplementedError(
            f"kernel B5 is forward only: its VJP is {VJP_ITEM}")
    batched = A.dim() == 3
    A3 = (A if batched else A[None]).contiguous()
    B3 = (B if batched else B[None]).contiguous()
    c, n, k = A3.shape
    m = B3.shape[1]
    out = torch.empty((c, n, m), dtype=torch.float32, device=A.device)
    if out.numel():
        err = _build.library("sqdist")(
            A3.data_ptr(), B3.data_ptr(), out.data_ptr(), c, n, m, k,
            torch.cuda.current_stream(A.device).cuda_stream)
        _build.check(err, "sqdist")
        sqdist.launches += 1
    return out if batched else out[0]


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
