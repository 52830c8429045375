"""Kernel B11: the archive row gather, and its dispatcher.

Counterpart of ``bipymc_tpu/ops/gather_rows.py::gather_rows_pallas``:
``out[..., :] = buf[clip(idx[...], 0, cap − 1)]``. The clamp is the
reference's (``gather_rows.py:80-82``); plain indexing, ``buf[idx]``,
would wrap a negative index instead. The kernel is
``bipymc_tpu_torch/csrc/gather_rows.cu`` (one warp a row, the row copied
as bytes in the widest vectors the operands allow); its plain version is
:func:`gather_rows_reference`, which it matches bit for bit.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises. ``gather_rows.launches`` counts the kernel's
launches. An empty index set gives an empty ``[*idx.shape, d]`` result
and launches nothing.
"""

import torch

from bipymc_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int64)


def gather_rows_reference(buf: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """The plain version: clamp the indices to [0, cap − 1], then
    ``index_select`` the rows. buf: [cap, d]; idx: any integer shape."""
    cap, d = buf.shape
    flat = torch.clamp(idx.reshape(-1), 0, cap - 1)
    return torch.index_select(buf, 0, flat).reshape(*idx.shape, d)


def gather_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``buf[clip(idx, 0, cap − 1)]``: rows of buf [cap, d] at indices of
    any shape, int32 or int64; returns ``[*idx.shape, d]`` in buf's dtype.

    On the card buf may have any row stride with unit stride along d (a
    view of a larger buffer needs no copy) and idx must be contiguous.
    """
    _check(buf, idx)
    cap, d = buf.shape
    if idx.numel() == 0:
        return torch.empty((*idx.shape, d), dtype=buf.dtype,
                           device=buf.device)
    if buf.device.type == "cpu":
        return gather_rows_reference(buf, idx)
    _check_cuda(buf, idx)
    out = torch.empty((*idx.shape, d), dtype=buf.dtype, device=buf.device)
    err = _build.library("gather_rows")(
        buf.data_ptr(), buf.stride(0), cap, d, buf.element_size(),
        idx.data_ptr(), int(idx.dtype == torch.int64), idx.numel(),
        out.data_ptr(), torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def _check(buf, idx):
    if buf.dim() != 2:
        raise ValueError(f"buf must be [cap, d], got {tuple(buf.shape)}")
    if buf.dtype not in DTYPES:
        raise TypeError(f"buf: no kernel for dtype {buf.dtype}; takes "
                        f"{', '.join(map(str, DTYPES))}")
    if idx.dtype not in INDEX_DTYPES:
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if idx.device != buf.device:
        raise ValueError(f"idx on {idx.device} but buf on {buf.device}")
    if buf.shape[0] == 0 and idx.numel() > 0:
        raise ValueError("cannot gather rows from an empty buf")


def _check_cuda(buf, idx):
    if buf.device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for device {buf.device}")
    if buf.stride(1) != 1:
        raise ValueError("buf must have unit stride along d")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
