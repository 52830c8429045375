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
  ``csrc/target.cuh``) at any d. It raises ``ValueError`` for a tensor
  that is not on a CUDA device, a target with no kernel form or a mixture
  of more than 16 modes, and a dtype other than float32; it never takes
  the plain version. ``fused_chunk.launches`` counts its launches in
  either mode, ``fused_chunk.kernel_rng_launches`` those in kernel-RNG
  mode.
- :func:`fused_chunk_plain` is the same function in torch ops, a loop
  over G of ``ops/dream_proposal.propose_plain``, the target and
  :func:`metropolis_select`, which is also the per-generation engine's
  accept (``samplers/dream.py``).
- :func:`fused_chunk_kernel_rng_plain` is kernel-RNG mode in torch ops:
  the kernel's words (:func:`kernel_rng_draws`), then
  :func:`fused_chunk_plain`.
- :func:`run_fused_chunk` dispatches: the kernel for CUDA tensors, the
  plain version for CPU tensors. The fused runner calls only it.

The kernel has two routes, chosen in one place in C
(``csrc/fused_chunk_plan.cuh::chunk_plan``): the shared route (the
target's constants in shared memory once a block, every generation's
inputs staged there before the generations run; config 3's) and the
global route (the constants read from device memory, the Gaussian's
inverse through a ring in shared memory: the Gaussian past d = 192 at
G = 10, the mixture where its means and the staged inputs do not fit). :func:`plan` mirrors the choice,
for the CPU tests and for printing, and ``fused_chunk.last_plan`` is
what the last launch took. The routes compute in one order, so their
outputs are equal bit for bit.

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

import ctypes

import torch

from bipymc_tpu_torch.core.rng import (bits_to_uniform, kernel_draw_bits,
                                       uniform_to_normal)
from bipymc_tpu_torch.models.targets import MAX_MODES, kernel_operands
from bipymc_tpu_torch.ops import _build
from bipymc_tpu_torch.ops.dream_proposal import propose_plain

# lanes of the packed per-chain scalars [G, n, 6]
S_DELTA, S_CR, S_GS, S_SNK, S_GJUMP, S_LOGU = 0, 1, 2, 3, 4, 5
N_SCAL = 6

ROUTES = ("shared", "global")
# The H100's shared memory a block may opt in to, bytes (the entry point
# reads the card's own figure)
MAX_SHARED_BYTES = 232_448
# csrc/fused_chunk_plan.cuh's constants (kThreads, kMaxCpb, kCpbN,
# kGlobalCpb, kTJ, kTiles, kGroup, kScalPad, kDraws, kWorkVecs)
_THREADS = 256
_MAX_CPB, _CPB_N, _GLOBAL_CPB = 8, 128, 4   # chains a block: n // 128
_TJ, _TILES, _GROUP = 8, 8, 128   # the global route's ring of inv tiles
_SCAL_PAD, _DRAWS, _WORK_VECS = 8, 3, 3


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def plan(n: int, d: int, G: int, n_pairs: int, kind: int, n_modes: int = 0,
         route=None):
    """The launch ``csrc/fused_chunk_plan.cuh::chunk_plan`` makes for n
    chains in d dimensions, G generations, ``n_pairs`` DE pairs, on target
    ``kind`` (0 the correlated Gaussian, 1 the mixture of ``n_modes``):
    ``(route, chains a block, threads, shared bytes)``. The shared route
    keeps the target's constants and every generation's inputs in shared
    memory; the global route reads them from device memory.
    ``route=None`` takes the shared route where it fits
    :data:`MAX_SHARED_BYTES`, else the global one. None where the route
    asked for does not take the shape, or for a mixture of more than
    ``MAX_MODES`` modes."""
    if kind == 1 and not 1 <= n_modes <= MAX_MODES:
        return None
    ld = _round_up(d, 4)
    # rows, the prepared vector, the draws (4 floats over), scal
    slot = (max(2 * n_pairs, 3) + 1 + _DRAWS) * ld + 4 * _DRAWS + _SCAL_PAD
    room = MAX_SHARED_BYTES // 4
    if route != "global":
        consts = (d + 1) * ld if kind == 0 else n_modes * ld
        vecs = 3 if kind == 0 else 2       # x, y (and r, the Gaussian)
        for cpb in range(min(max(n // _CPB_N, 1), _MAX_CPB), 0, -1):
            smem = MAX_MODES + consts + cpb * vecs * ld + cpb * G * slot
            if smem <= room:
                return ("shared", cpb, _THREADS, 4 * smem)
        if route == "shared":
            return None
    ring = _TILES * _TJ * _GROUP if kind == 0 else 0
    for cpb in range(min(max(n // _CPB_N, 1), _GLOBAL_CPB), 0, -1):
        if MAX_MODES + cpb * ring <= room:
            return ("global", cpb, _THREADS, 4 * (MAX_MODES + cpb * ring))
    return None


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
                t0=None, test_bits=None, route=None):
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

    ``route`` forces one of :data:`ROUTES`, for the checks that hold the
    routes together and for timings in turns; a forced route that does
    not take the shape raises ``ValueError``. The samplers never pass it.
    """
    G, n, k, d = _check_shapes(x0, logp0, rows, u_mask, u_e, eps, scal,
                               n_pairs, rng, run_key, t0, test_bits)
    if route not in (None, *ROUTES):
        raise ValueError(f"route={route!r}: expected None or one of "
                         f"{ROUTES}")
    kind, c0, c1, n_modes, f0, f1 = kernel_operands(log_prob, x0.device, d,
                                                    "fused_chunk")
    kernel_rng = rng == "kernel"
    lds = _check_operands(x0, logp0, rows, u_mask, u_e, eps, scal,
                          test_bits)
    force = -1 if route is None else ROUTES.index(route)
    chosen = (ctypes.c_int * 5)()
    err = _build.library("fused_chunk_plan")(
        n, d, G, n_pairs, kind, n_modes, force, ctypes.addressof(chosen))
    if err == _build.ERR_SHARED_MEMORY:
        raise ValueError(f"route={route!r} does not take n={n}, d={d}, "
                         f"G={G} on this target (see ops/fused_chunk.plan)")
    _build.check(err, "fused_chunk")
    dev = x0.device
    x_hist = torch.empty((G, n, d), dtype=torch.float32, device=dev)
    lp_hist = torch.empty((G, n), dtype=torch.float32, device=dev)
    acc_hist = torch.empty((G, n), dtype=torch.bool, device=dev)
    # the global route's workspace: a chain's x, y, r and each
    # generation's draws and prepared vector
    work = (torch.empty((n, _WORK_VECS + _DRAWS * G, chosen[4]),
                        dtype=torch.float32, device=dev)
            if ROUTES[chosen[0]] == "global" else None)
    ptr = lambda a: None if a is None else a.data_ptr()
    tb = test_bits or (None, None, None)
    err = _build.library("fused_chunk")(
        x0.data_ptr(), logp0.data_ptr(), rows.data_ptr(), k, ptr(u_mask),
        lds[0], ptr(u_e), lds[1], ptr(eps), lds[2], int(kernel_rng),
        int(run_key or 0), int(t0 or 0), *(ptr(a) for a in tb),
        scal.data_ptr(), G, n, d, n_pairs, (d_true - 1) * 0.5, b, b_star,
        kind, c0.data_ptr(), c1.data_ptr(), n_modes, f0, f1, chosen[0],
        ptr(work), x_hist.data_ptr(), lp_hist.data_ptr(),
        acc_hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_chunk")
    fused_chunk.last_plan = (ROUTES[chosen[0]], *chosen[1:4])
    fused_chunk.launches += 1
    fused_chunk.kernel_rng_launches += kernel_rng
    return x_hist, lp_hist, acc_hist


fused_chunk.launches = 0
fused_chunk.kernel_rng_launches = 0
fused_chunk.last_plan = None


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
