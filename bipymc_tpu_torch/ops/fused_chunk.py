"""Kernel B1: G DREAM-zs generations in one launch, and its plain version.

Counterpart of ``bipymc_tpu/ops/fused_chunk.py`` in stream mode: x and
logp stay on the device across a chunk of G = ``archive_thin``
generations, while the uniforms, the normals, the archive rows and the
per-chain scalars come in precomputed (``samplers/dream_fused.py``).
Each generation is the proposal (B2's math), the target, and the
Metropolis accept with the snooker Jacobian, where a non-finite target
value rejects.

Three functions:

- :func:`fused_chunk` launches ``csrc/fused_chunk.cu``, which evaluates
  the built-in targets' kernel forms (``models/targets.py``,
  ``csrc/target.cuh``). It raises ``ValueError`` for a tensor that is not
  on a CUDA device, a target with no kernel form or a mixture of more
  than 16 modes, and a dtype other than float32; it never takes the plain
  version. ``fused_chunk.launches`` counts its launches.
- :func:`fused_chunk_plain` is the same function in torch ops, a loop
  over G of ``ops/dream_proposal.propose_plain``, the target and
  :func:`metropolis_select`, which is also the per-generation engine's
  accept (``samplers/dream.py``).
- :func:`run_fused_chunk` dispatches: the kernel for CUDA tensors, the
  plain version for CPU tensors. The fused runner calls only it.

The Pallas kernel's TPU workarounds are not carried over:
``hoist_target_consts`` and ``lp_block_cache``
(``bipymc_tpu/ops/fused_chunk.py:110-159``) lift a jaxpr's closure
constants into kernel operands and keep a jit cache stable; here the
kernel reads the target's constants from its kernel form. The
in-kernel-RNG mode (``rng="kernel"``) is not ported (ROADMAP Queue A).
"""

import torch

from bipymc_tpu_torch.models.targets import MAX_MODES, kernel_operands
from bipymc_tpu_torch.ops import _build
from bipymc_tpu_torch.ops.dream_proposal import propose_plain

# lanes of the packed per-chain scalars [G, n, 6]
S_DELTA, S_CR, S_GS, S_SNK, S_GJUMP, S_LOGU = 0, 1, 2, 3, 4, 5
N_SCAL = 6
_MAX_WARPS = 4                   # kMaxWarps in csrc/block_reduce.cuh
# bytes of dynamic shared memory a block may use: the card's 232448 less
# the kernel's static scratch, float[kMaxWarps * kMaxModes] for the
# target and six [kMaxWarps] arrays for the proposal
_MAX_SMEM = 232448 - 4 * _MAX_WARPS * MAX_MODES - 4 * 6 * _MAX_WARPS


def metropolis_select(x, lp, x_star, lp_star, log_jac, log_u):
    """The DREAM-zs accept for every chain: log α = min(0, (lp* − lp) +
    log_jac), −inf where lp* is not finite; accept where log u < log α.

    x, x_star [n, d]; lp, lp_star, log_jac, log_u [n]. Returns (x_new,
    lp_new, accepted [n] bool, log_alpha [n]).
    """
    log_alpha = torch.clamp_max(lp_star - lp + log_jac, 0.0)
    log_alpha = torch.where(torch.isfinite(lp_star), log_alpha, -torch.inf)
    acc = log_u < log_alpha
    return (torch.where(acc[:, None], x_star, x),
            torch.where(acc, lp_star, lp), acc, log_alpha)


def fused_chunk_plain(x0, logp0, rows, u_mask, u_e, eps, scal, log_prob, *,
                      n_pairs, d_true, b, b_star):
    """The G generations in torch ops; ``log_prob`` is any batched target.

    Returns (x_hist [G, n, d], logp_hist [G, n], accepted [G, n] bool).
    """
    G, n = scal.shape[:2]
    d = x0.shape[1]
    x_hist = torch.empty((G, n, d), dtype=x0.dtype, device=x0.device)
    lp_hist = torch.empty((G, n), dtype=x0.dtype, device=x0.device)
    acc_hist = torch.empty((G, n), dtype=torch.bool, device=x0.device)
    x, lp = x0, logp0
    for g in range(G):
        x_star, log_jac = propose_plain(
            x, rows[g], u_mask[g], u_e[g], eps[g], scal[g], n_pairs, d_true,
            b, b_star)
        x, lp, acc, _ = metropolis_select(x, lp, x_star, log_prob(x_star),
                                          log_jac, scal[g][:, S_LOGU])
        x_hist[g], lp_hist[g], acc_hist[g] = x, lp, acc
    return x_hist, lp_hist, acc_hist


def fused_chunk(x0, logp0, rows, u_mask, u_e, eps, scal, log_prob, *,
                n_pairs, d_true, b, b_star):
    """Advance G generations in one launch of kernel B1: returns (x_hist
    [G, n, d], logp_hist [G, n], accepted [G, n] bool).

    x0 [n, d]; logp0 [n]; rows [G, n, k, d] the gathered archive rows
    (k ≥ max(2·n_pairs, 3)); u_mask, u_e, eps [G, n, d] (any row stride
    with unit stride along d, so slices of the generations' uniform
    block need no copy); scal [G, n, 6] packed (delta, cr, gamma_s,
    is_snooker, gamma_jump, log u). Every operand is float32 on one CUDA
    device; ``log_prob`` must carry a kernel form.
    """
    G, n, k, d = _check_shapes(x0, logp0, rows, u_mask, u_e, eps, scal,
                               n_pairs)
    kind, c0, c1, n_modes, f0, f1 = kernel_operands(log_prob, x0.device, d,
                                                    "fused_chunk")
    lds = _check_operands(x0, logp0, rows, u_mask, u_e, eps, scal)
    n_const = d * d + d if kind == 0 else n_modes * d
    if 4 * (n_const + 3 * d) > _MAX_SMEM:
        raise ValueError(f"d={d}: the target's constants and the chain's "
                         "rows do not fit the kernel's shared memory")
    dev = x0.device
    x_hist = torch.empty((G, n, d), dtype=torch.float32, device=dev)
    lp_hist = torch.empty((G, n), dtype=torch.float32, device=dev)
    acc_hist = torch.empty((G, n), dtype=torch.bool, device=dev)
    err = _build.library("fused_chunk")(
        x0.data_ptr(), logp0.data_ptr(), rows.data_ptr(), k,
        u_mask.data_ptr(), lds[0], u_e.data_ptr(), lds[1], eps.data_ptr(),
        lds[2], scal.data_ptr(), G, n, d, n_pairs, (d_true - 1) * 0.5, b,
        b_star, kind, c0.data_ptr(), c1.data_ptr(), n_modes, f0, f1,
        x_hist.data_ptr(), lp_hist.data_ptr(), acc_hist.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_chunk")
    fused_chunk.launches += 1
    return x_hist, lp_hist, acc_hist


fused_chunk.launches = 0


def run_fused_chunk(x0, logp0, rows, u_mask, u_e, eps, scal, log_prob, *,
                    n_pairs, d_true, b, b_star):
    """:func:`fused_chunk` for CUDA tensors, :func:`fused_chunk_plain`
    for CPU tensors; the same arguments and returns."""
    kw = dict(n_pairs=n_pairs, d_true=d_true, b=b, b_star=b_star)
    if x0.device.type == "cpu":
        _check_shapes(x0, logp0, rows, u_mask, u_e, eps, scal, n_pairs)
        return fused_chunk_plain(x0, logp0, rows, u_mask, u_e, eps, scal,
                                 log_prob, **kw)
    return fused_chunk(x0, logp0, rows, u_mask, u_e, eps, scal, log_prob,
                       **kw)


def _check_shapes(x0, logp0, rows, u_mask, u_e, eps, scal, n_pairs):
    if rows.dim() != 4:
        raise ValueError(f"rows must be [G, n, k, d], got "
                         f"{tuple(rows.shape)}")
    G, n, k, d = rows.shape
    if k < max(2 * n_pairs, 3):
        raise ValueError(f"rows must hold >= {max(2 * n_pairs, 3)} archive "
                         f"rows a chain, got {k}")
    if x0.shape != (n, d) or logp0.shape != (n,):
        raise ValueError(f"x0 must be [{n}, {d}] and logp0 [{n}], got "
                         f"{tuple(x0.shape)} and {tuple(logp0.shape)}")
    for name, a in (("u_mask", u_mask), ("u_e", u_e), ("eps", eps)):
        if a.shape != (G, n, d):
            raise ValueError(f"{name} must be [{G}, {n}, {d}], got "
                             f"{tuple(a.shape)}")
    if scal.shape != (G, n, N_SCAL):
        raise ValueError(f"scal must be [{G}, {n}, {N_SCAL}], got "
                         f"{tuple(scal.shape)}")
    return G, n, k, d


def _check_operands(x0, logp0, rows, u_mask, u_e, eps, scal):
    """Raise ``ValueError`` unless every operand is a float32 tensor on
    x0's CUDA device in a layout the kernel reads; returns the row
    strides of u_mask, u_e and eps."""
    named = (("x0", x0), ("logp0", logp0), ("rows", rows),
             ("u_mask", u_mask), ("u_e", u_e), ("eps", eps), ("scal", scal))
    for name, a in named:
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (the kernel computes "
                             f"in float32), got {a.dtype}")
    if x0.device.type != "cuda":
        raise ValueError(f"fused_chunk: no kernel for device {x0.device}")
    for name, a in named:
        if a.device != x0.device:
            raise ValueError(f"{name} is on {a.device}, x0 on {x0.device}")
    for name, a in (("x0", x0), ("logp0", logp0), ("rows", rows),
                    ("scal", scal)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lds = []
    n = x0.shape[0]
    for name, a in (("u_mask", u_mask), ("u_e", u_e), ("eps", eps)):
        if a.stride(2) != 1 or a.stride(0) != n * a.stride(1):
            raise ValueError(f"{name} must be rows of unit stride along d, "
                             "generation after generation")
        lds.append(a.stride(1))
    return lds
