"""Kernel B4: K random-walk (MH / DR) steps in one launch, and its plain
version.

Counterpart of ``bipymc_tpu/ops/fused_rw_chunk.py``. θ and logp stay on
the device across a chunk of K steps; the randomness, the proposal
displacements ``dy1 = L z₁`` and ``dy2 = (L/√κ) z₂`` and the whitened
norms come in precomputed (``samplers/rw_fused.py``), and the target is
evaluated inside the kernel.

:func:`rw_select` is one step's two-stage acceptance; the per-step engine
(``samplers/rw.py``) and :func:`fused_rw_chunk_plain` both call it, so
the two engines share one formula. :func:`fused_rw_chunk` has the
signature and returns of ``fused_rw_chunk_pallas``: a tensor on the CPU
goes to the plain version, which takes any batched target; a CUDA tensor
goes to ``csrc/fused_rw_chunk.cu``, which evaluates the built-in
targets' kernel forms (``models/targets.py``, ``csrc/target.cuh``), or
the call raises.
``fused_rw_chunk.launches`` counts the kernel's launches.
"""

import torch

from bipymc_tpu_torch.core.numerics import log1mexp
from bipymc_tpu_torch.models.targets import MAX_MODES, kernel_operands
from bipymc_tpu_torch.ops import _build

# lanes of the packed per-step scalars [K, n, 4]
S_SZ1, S_SW, S_LU1, S_LU2 = 0, 1, 2, 3
N_SCAL = 4
_MAX_WARPS = 4                   # kMaxWarps in csrc/block_reduce.cuh
# bytes of dynamic shared memory a block may use: the card's 232448 less
# the kernel's static reduction scratch, float[kMaxWarps * kMaxModes]
_MAX_SMEM = 232448 - 4 * _MAX_WARPS * MAX_MODES


def rw_select(x, lp, y1, l1, log_u1, y2=None, l2=None, log_u2=None,
              sz1=None, sw=None):
    """One step's acceptance for every chain: Metropolis on y₁ and, when
    ``y2`` is given, the Green–Mira second stage on y₂ (κ enters through
    the whitened norms ``sz1`` = ‖z₁‖² and ``sw`` = ‖z₁ − z₂/√κ‖²).

    x, y1, y2 [n, d]; lp, l1, l2, log_u1, log_u2, sz1, sw [n]. A
    non-finite target value sets its stage's log acceptance to −inf.
    Returns (x_new [n, d], lp_new [n], accepted [n] bool, stage [n]
    int32: 0 reject, 1 stage 1, 2 stage 2).
    """
    log_a1 = torch.clamp_max(l1 - lp, 0.0)
    log_a1 = torch.where(torch.isfinite(l1), log_a1, -torch.inf)
    acc1 = log_u1 < log_a1
    if y2 is None:
        return (torch.where(acc1[:, None], y1, x), torch.where(acc1, l1, lp),
                acc1, acc1.to(torch.int32))
    log_a1_rev = torch.clamp_max(l1 - l2, 0.0)
    lq_diff = -0.5 * (sw - sz1)
    log_num = l2 + log1mexp(log_a1_rev)
    log_den = lp + log1mexp(log_a1)
    log_a2 = torch.clamp_max(log_num + lq_diff - log_den, 0.0)
    log_a2 = torch.where(torch.isfinite(l2), log_a2, -torch.inf)
    # a NaN log_a2 (stage 1 accepted with α₁ = 1) compares False
    acc2 = ~acc1 & (log_u2 < log_a2)
    x_new = torch.where(acc1[:, None], y1,
                        torch.where(acc2[:, None], y2, x))
    lp_new = torch.where(acc1, l1, torch.where(acc2, l2, lp))
    stage = torch.where(acc1, 1, torch.where(acc2, 2, 0)).to(torch.int32)
    return x_new, lp_new, acc1 | acc2, stage


def fused_rw_chunk_plain(x0, logp0, dy1, dy2, scal, log_prob, delayed):
    """The K steps in torch ops; ``log_prob`` is any batched target."""
    K, n, d = dy1.shape
    x_hist = torch.empty((K, n, d), dtype=x0.dtype, device=x0.device)
    lp_hist = torch.empty((K, n), dtype=x0.dtype, device=x0.device)
    acc_hist = torch.empty((K, n), dtype=torch.bool, device=x0.device)
    stage_hist = torch.empty((K, n), dtype=torch.int32, device=x0.device)
    x, lp = x0, logp0
    for k in range(K):
        y1 = x + dy1[k]
        l1 = log_prob(y1)
        sc = scal[k]
        if delayed:
            y2 = x + dy2[k]
            x, lp, acc, stage = rw_select(
                x, lp, y1, l1, sc[:, S_LU1], y2, log_prob(y2), sc[:, S_LU2],
                sc[:, S_SZ1], sc[:, S_SW])
        else:
            x, lp, acc, stage = rw_select(x, lp, y1, l1, sc[:, S_LU1])
        x_hist[k], lp_hist[k], acc_hist[k], stage_hist[k] = x, lp, acc, stage
    return x_hist, lp_hist, acc_hist, stage_hist


def fused_rw_chunk(x0, logp0, dy1, dy2, scal, log_prob, delayed,
                   steps_per_cell=1):
    """Advance K random-walk steps: returns (x_hist [K, n, d], logp_hist
    [K, n], accepted [K, n] bool, stage [K, n] int32).

    x0 [n, d]; logp0 [n]; dy1 / dy2 [K, n, d] the stage-1 / stage-2
    displacements (pass ``dy2=None`` with ``delayed=False``); scal
    [K, n, 4] packed (‖z₁‖², ‖z₁ − z₂/√κ‖², log u₁, log u₂), of which
    only log u₁ is read without ``delayed``. ``steps_per_cell`` is kept
    for the JAX signature: it must divide K and changes nothing here.
    On the card every operand is float32 and contiguous, and
    ``log_prob`` must carry a kernel form.
    """
    K, n, d = dy1.shape
    if K % int(steps_per_cell) != 0:
        raise ValueError(f"steps_per_cell={steps_per_cell} must divide "
                         f"K={K}")
    if x0.shape != (n, d) or logp0.shape != (n,):
        raise ValueError(f"x0 must be [{n}, {d}] and logp0 [{n}], got "
                         f"{tuple(x0.shape)} and {tuple(logp0.shape)}")
    if scal.shape != (K, n, N_SCAL):
        raise ValueError(f"scal must be [{K}, {n}, {N_SCAL}], got "
                         f"{tuple(scal.shape)}")
    if delayed and (dy2 is None or dy2.shape != dy1.shape):
        raise ValueError(f"delayed=True needs dy2 [{K}, {n}, {d}]")
    if x0.device.type == "cpu":
        return fused_rw_chunk_plain(x0, logp0, dy1, dy2, scal, log_prob,
                                    delayed)
    kind, c0, c1, n_modes, f0, f1 = kernel_operands(
        log_prob, x0.device, d, "fused_rw_chunk")
    operands = [x0, logp0, dy1, scal, c0, c1] + ([dy2] if delayed else [])
    _check_cuda(x0, operands)
    n_const = d * d + d if kind == 0 else n_modes * d
    if 4 * (n_const + 4 * d) > _MAX_SMEM:
        raise ValueError(f"d={d}: the target's constants and the chain's "
                         "rows do not fit the kernel's shared memory")
    dev = x0.device
    x_hist = torch.empty((K, n, d), dtype=torch.float32, device=dev)
    lp_hist = torch.empty((K, n), dtype=torch.float32, device=dev)
    acc_hist = torch.empty((K, n), dtype=torch.bool, device=dev)
    stage_hist = torch.empty((K, n), dtype=torch.int32, device=dev)
    threads = min(128, 32 * ((d + 31) // 32))
    err = _build.library("fused_rw_chunk")(
        x0.data_ptr(), logp0.data_ptr(), dy1.data_ptr(),
        dy2.data_ptr() if delayed else None, scal.data_ptr(), K, n, d,
        int(bool(delayed)), kind, c0.data_ptr(), c1.data_ptr(), n_modes, f0,
        f1, threads, x_hist.data_ptr(), lp_hist.data_ptr(),
        acc_hist.data_ptr(), stage_hist.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_rw_chunk")
    fused_rw_chunk.launches += 1
    return x_hist, lp_hist, acc_hist, stage_hist


fused_rw_chunk.launches = 0


def _check_cuda(x0, operands):
    if x0.device.type != "cuda":
        raise ValueError(f"fused_rw_chunk: no kernel for device {x0.device}")
    for a in operands:
        if a.device != x0.device:
            raise ValueError(f"an operand is on {a.device}, x0 on "
                             f"{x0.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"operands must be float32 on the card, got "
                            f"{a.dtype}")
        if not a.is_contiguous():
            raise ValueError("operands must be contiguous")
