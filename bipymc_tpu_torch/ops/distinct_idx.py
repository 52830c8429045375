"""Kernel B3: k distinct row indices per chain, and its dispatcher.

Counterpart of ``bipymc_tpu/ops/distinct_idx.py::distinct_idx_pallas``.
The kernel is ``bipymc_tpu_torch/csrc/distinct_idx.cu`` (one thread per
chain, the sorted-insert bookkeeping unrolled into registers); its plain
version is ``ensemble/indices.py::distinct_from_bits``, which it matches
bit for bit.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises. ``distinct_idx.launches`` counts the kernel's
launches.
"""

import torch

from bipymc_tpu_torch.ensemble.indices import distinct_from_bits
from bipymc_tpu_torch.ops import _build

MAX_K = 8


def distinct_idx(bits: torch.Tensor, k: int, n: int,
                 exclude: torch.Tensor | None = None) -> torch.Tensor:
    """k distinct int32 per chain, uniform on [0, n) (optionally ≠ exclude).

    bits: [n_chains, ≥k] int32 word bit patterns (the first k columns are
    used; on the card, any row stride with unit column stride, so a slice
    of the generation's word block needs no copy). n: host int, the
    archive fill or the population size. exclude: optional [n_chains]
    int32. Returns int32 [n_chains, k].
    """
    if bits.dim() != 2 or bits.shape[1] < k:
        raise ValueError(f"bits must be [n_chains, >= {k}], got "
                         f"{tuple(bits.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the kernel supports 1 <= k <= {MAX_K}")
    n_excl = 0 if exclude is None else 1
    if n - n_excl < k:
        raise ValueError(f"cannot draw {k} distinct values from {n} "
                         f"(excluding {n_excl})")
    if bits.device.type == "cpu":
        return distinct_from_bits(bits, k, n, exclude)
    _check_cuda(bits, exclude)
    n_chains = bits.shape[0]
    out = torch.empty((n_chains, k), dtype=torch.int32, device=bits.device)
    err = _build.library("distinct_idx")(
        bits.data_ptr(), bits.stride(0), n_chains, k, int(n),
        None if exclude is None else exclude.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(bits.device).cuda_stream)
    _build.check(err, "distinct_idx")
    distinct_idx.launches += 1
    return out


distinct_idx.launches = 0


def _check_cuda(bits, exclude):
    if bits.device.type != "cuda":
        raise ValueError(f"distinct_idx: no kernel for device {bits.device}")
    if bits.dtype != torch.int32:
        raise TypeError(f"bits must be int32 bit patterns, got {bits.dtype}")
    if bits.stride(1) != 1:
        raise ValueError("bits must have unit stride along the words")
    if exclude is not None:
        if (exclude.device != bits.device or exclude.dtype != torch.int32
                or exclude.shape != (bits.shape[0],)
                or not exclude.is_contiguous()):
            raise ValueError("exclude must be a contiguous int32 "
                             "[n_chains] tensor on the device of bits")
