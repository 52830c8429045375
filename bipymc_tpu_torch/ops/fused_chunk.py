"""Kernel B1: G DREAM-zs generations in one launch, and its plain version.

Counterpart of ``bipymc_tpu/ops/fused_chunk.py`` in both of its modes:
x and logp stay on the device across a chunk of G = ``archive_thin``
generations, while the archive rows and the per-chain scalars come in
precomputed (``samplers/dream_fused.py``). In stream mode the crossover
uniforms, the multiplicative uniforms and the normals come in too; in
kernel-RNG mode (``rng="kernel"``) the kernel draws them itself from
Philox4x32-10 keyed by the run key and the generation
(``core/rng.kernel_draw_bits``). Each generation is the proposal (B2's
math), the target, and the Metropolis accept with the snooker Jacobian,
where a non-finite target value rejects.

Four functions:

- :func:`fused_chunk` launches ``csrc/fused_chunk.cu``, which evaluates
  the built-in targets' kernel forms (``models/targets.py``,
  ``csrc/target.cuh``). It raises ``ValueError`` for a tensor that is not
  on a CUDA device, a target with no kernel form or a mixture of more
  than 16 modes, and a dtype other than float32; it never takes the plain
  version. ``fused_chunk.launches`` counts its launches in either mode,
  ``fused_chunk.kernel_rng_launches`` those in kernel-RNG mode.
- :func:`fused_chunk_plain` is the same function in torch ops, a loop
  over G of ``ops/dream_proposal.propose_plain``, the target and
  :func:`metropolis_select`, which is also the per-generation engine's
  accept (``samplers/dream.py``).
- :func:`fused_chunk_kernel_rng_plain` is kernel-RNG mode in torch ops:
  the kernel's words (:func:`kernel_rng_draws`), then
  :func:`fused_chunk_plain`.
- :func:`run_fused_chunk` dispatches: the kernel for CUDA tensors, the
  plain version for CPU tensors. The fused runner calls only it.

In kernel-RNG mode ``test_bits`` (three ``[G, n, d]`` int32 blocks)
replace the Philox words and go through the same conversions, so a test
can feed both modes the same words, as with the JAX package's
``test_bits``; only the tests and the card checks pass them.

The Pallas kernel's TPU workarounds are not carried over:
``hoist_target_consts`` and ``lp_block_cache``
(``bipymc_tpu/ops/fused_chunk.py:110-159``) lift a jaxpr's closure
constants into kernel operands and keep a jit cache stable; here the
kernel reads the target's constants from its kernel form.
"""

import torch

from bipymc_tpu_torch.core.rng import (bits_to_uniform, kernel_draw_bits,
                                       uniform_to_normal)
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


def shared_bytes(kind: int, d: int, n_modes: int, rng="stream") -> int:
    """Bytes of dynamic shared memory a block of B1 takes: the target's
    constants (d² + d floats for the correlated Gaussian, kind 0;
    ``n_modes``·d for the mixture, kind 1) and a chain's rows (3·d floats,
    6·d in kernel-RNG mode)."""
    n_const = d * d + d if kind == 0 else n_modes * d
    return 4 * (n_const + (6 * d if rng == "kernel" else 3 * d))


def check_target_fits(kind: int, d: int, n_modes: int, rng="stream"):
    """Raise ``ValueError`` where B1 cannot hold the target's constants
    and a chain's rows in shared memory, naming the bytes and the largest
    d it takes; the wrapper's own check and ``DreamZs(fused=True)`` on a
    CUDA device both call it. The plain version takes any d."""
    need = shared_bytes(kind, d, n_modes, rng)
    if need <= _MAX_SMEM:
        return
    lo, hi = 0, d                  # fits at lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if shared_bytes(kind, mid, n_modes, rng) <= _MAX_SMEM:
            lo = mid
        else:
            hi = mid
    raise ValueError(
        f"kernel B1 ({rng} mode) keeps the target's constants and a "
        f"chain's rows in shared memory: at d={d} they take {need} bytes, "
        f"more than the {_MAX_SMEM} a block may use; it takes this target "
        f"up to d={lo} (the plain version, on the CPU, takes any d)")


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


def kernel_rng_draws(run_key, t0, G, n, d, device, test_bits=None):
    """Kernel-RNG mode's u_mask, u_e and eps ([G, n, d] float32) as the
    kernel makes them: ``core/rng.kernel_draw_bits`` (or ``test_bits``)
    through ``bits_to_uniform`` and ``uniform_to_normal``."""
    if test_bits is None:
        test_bits = kernel_draw_bits(run_key, t0, G, n, d, device)
    m, e, nb = test_bits
    return (bits_to_uniform(m), bits_to_uniform(e),
            uniform_to_normal(bits_to_uniform(nb)))


def fused_chunk_kernel_rng_plain(x0, logp0, rows, scal, log_prob, *,
                                 n_pairs, d_true, b, b_star, run_key, t0,
                                 test_bits=None):
    """Kernel-RNG mode in torch ops: the same returns as
    :func:`fused_chunk_plain`, on the draws of :func:`kernel_rng_draws`."""
    G, n = scal.shape[:2]
    draws = kernel_rng_draws(run_key, t0, G, n, x0.shape[1], x0.device,
                             test_bits)
    return fused_chunk_plain(x0, logp0, rows, *draws, scal, log_prob,
                             n_pairs=n_pairs, d_true=d_true, b=b,
                             b_star=b_star)


def fused_chunk(x0, logp0, rows, u_mask, u_e, eps, scal, log_prob, *,
                n_pairs, d_true, b, b_star, rng="stream", run_key=None,
                t0=None, test_bits=None):
    """Advance G generations in one launch of kernel B1: returns (x_hist
    [G, n, d], logp_hist [G, n], accepted [G, n] bool).

    x0 [n, d]; logp0 [n]; rows [G, n, k, d] the gathered archive rows
    (k ≥ max(2·n_pairs, 3)); scal [G, n, 6] packed (delta, cr, gamma_s,
    is_snooker, gamma_jump, log u). Every operand is float32 on one CUDA
    device; ``log_prob`` must carry a kernel form.

    ``rng="stream"``: u_mask, u_e, eps [G, n, d] (any row stride with
    unit stride along d, so slices of the generations' uniform block
    need no copy). ``rng="kernel"``: u_mask, u_e and eps are None; the
    kernel draws generation g's from Philox keyed by ``run_key`` (the
    run's 64-bit key) and ``t0 + g`` (``core/rng.kernel_draw_bits``), or
    converts ``test_bits`` (three contiguous [G, n, d] int32 blocks)
    where given.
    """
    G, n, k, d = _check_shapes(x0, logp0, rows, u_mask, u_e, eps, scal,
                               n_pairs, rng, run_key, t0, test_bits)
    kind, c0, c1, n_modes, f0, f1 = kernel_operands(log_prob, x0.device, d,
                                                    "fused_chunk")
    kernel_rng = rng == "kernel"
    check_target_fits(kind, d, n_modes, rng)
    lds = _check_operands(x0, logp0, rows, u_mask, u_e, eps, scal,
                          test_bits)
    dev = x0.device
    x_hist = torch.empty((G, n, d), dtype=torch.float32, device=dev)
    lp_hist = torch.empty((G, n), dtype=torch.float32, device=dev)
    acc_hist = torch.empty((G, n), dtype=torch.bool, device=dev)
    ptr = lambda a: None if a is None else a.data_ptr()
    tb = test_bits or (None, None, None)
    err = _build.library("fused_chunk")(
        x0.data_ptr(), logp0.data_ptr(), rows.data_ptr(), k, ptr(u_mask),
        lds[0], ptr(u_e), lds[1], ptr(eps), lds[2], int(kernel_rng),
        int(run_key or 0), int(t0 or 0), *(ptr(a) for a in tb),
        scal.data_ptr(), G, n, d, n_pairs, (d_true - 1) * 0.5, b, b_star,
        kind, c0.data_ptr(), c1.data_ptr(), n_modes, f0, f1,
        x_hist.data_ptr(), lp_hist.data_ptr(), acc_hist.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_chunk")
    fused_chunk.launches += 1
    fused_chunk.kernel_rng_launches += kernel_rng
    return x_hist, lp_hist, acc_hist


fused_chunk.launches = 0
fused_chunk.kernel_rng_launches = 0


def run_fused_chunk(x0, logp0, rows, u_mask, u_e, eps, scal, log_prob, *,
                    n_pairs, d_true, b, b_star, rng="stream", run_key=None,
                    t0=None, test_bits=None):
    """:func:`fused_chunk` for CUDA tensors; for CPU tensors
    :func:`fused_chunk_plain` (stream mode) or
    :func:`fused_chunk_kernel_rng_plain` (kernel-RNG mode). The same
    arguments and returns."""
    kw = dict(n_pairs=n_pairs, d_true=d_true, b=b, b_star=b_star)
    if x0.device.type != "cpu":
        return fused_chunk(x0, logp0, rows, u_mask, u_e, eps, scal,
                           log_prob, rng=rng, run_key=run_key, t0=t0,
                           test_bits=test_bits, **kw)
    _check_shapes(x0, logp0, rows, u_mask, u_e, eps, scal, n_pairs, rng,
                  run_key, t0, test_bits)
    if rng == "kernel":
        return fused_chunk_kernel_rng_plain(
            x0, logp0, rows, scal, log_prob, run_key=run_key, t0=t0,
            test_bits=test_bits, **kw)
    return fused_chunk_plain(x0, logp0, rows, u_mask, u_e, eps, scal,
                             log_prob, **kw)


def _check_shapes(x0, logp0, rows, u_mask, u_e, eps, scal, n_pairs,
                  rng="stream", run_key=None, t0=None, test_bits=None):
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
    if rng == "stream":
        if test_bits is not None:
            raise ValueError("test_bits is for rng='kernel'")
        draws = (("u_mask", u_mask), ("u_e", u_e), ("eps", eps))
    elif rng == "kernel":
        if any(a is not None for a in (u_mask, u_e, eps)):
            raise ValueError("rng='kernel' draws u_mask, u_e and eps in the "
                             "kernel: pass None for each")
        if run_key is None or t0 is None:
            raise ValueError("rng='kernel' needs run_key and t0")
        if test_bits is not None and len(test_bits) != 3:
            raise ValueError("test_bits must be three [G, n, d] blocks")
        draws = tuple(zip(("test_bits[0]", "test_bits[1]", "test_bits[2]"),
                          test_bits or ()))
    else:
        raise ValueError(f"rng={rng!r}: expected 'stream' or 'kernel'")
    for name, a in draws:
        if a.shape != (G, n, d):
            raise ValueError(f"{name} must be [{G}, {n}, {d}], got "
                             f"{tuple(a.shape)}")
    if scal.shape != (G, n, N_SCAL):
        raise ValueError(f"scal must be [{G}, {n}, {N_SCAL}], got "
                         f"{tuple(scal.shape)}")
    return G, n, k, d


def _check_operands(x0, logp0, rows, u_mask, u_e, eps, scal,
                    test_bits=None):
    """Raise ``ValueError`` unless every operand is a tensor on x0's
    CUDA device of the type and layout the kernel reads; returns the row
    strides of u_mask, u_e and eps (0 where they are None)."""
    draws = [(name, a) for name, a in (("u_mask", u_mask), ("u_e", u_e),
                                       ("eps", eps)) if a is not None]
    named = [("x0", x0), ("logp0", logp0), ("rows", rows), *draws,
             ("scal", scal)]
    for name, a in named:
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (the kernel computes "
                             f"in float32), got {a.dtype}")
    bits = list(zip(("test_bits[0]", "test_bits[1]", "test_bits[2]"),
                    test_bits or ()))
    for name, a in bits:
        if a.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 words, got {a.dtype}")
    if x0.device.type != "cuda":
        raise ValueError(f"fused_chunk: no kernel for device {x0.device}")
    for name, a in named + bits:
        if a.device != x0.device:
            raise ValueError(f"{name} is on {a.device}, x0 on {x0.device}")
    for name, a in [("x0", x0), ("logp0", logp0), ("rows", rows),
                    ("scal", scal)] + bits:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lds = []
    n = x0.shape[0]
    for name, a in (("u_mask", u_mask), ("u_e", u_e), ("eps", eps)):
        if a is None:
            lds.append(0)
            continue
        if a.stride(2) != 1 or a.stride(0) != n * a.stride(1):
            raise ValueError(f"{name} must be rows of unit stride along d, "
                             "generation after generation")
        lds.append(a.stride(1))
    return lds
