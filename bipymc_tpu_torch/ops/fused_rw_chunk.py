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

The kernel has three routes, chosen in one place in C
(``csrc/fused_rw_plan.cuh::rw_plan``): the latency route (d ≤ 32, one
warp a chain, config 1's shape), the throughput route (the Gaussian up to
d = 128, its inverse in registers, the wide shape) and the global route
(the inverse streamed from device memory: the Gaussian up to d = 20,832,
the mixture at any d). :func:`plan` mirrors the choice, for the CPU tests
and for printing, and ``fused_rw_chunk.last_plan`` is what the last
launch took. The routes compute the target in one order, so their
outputs are equal bit for bit.
"""

import ctypes

import torch

from bipymc_tpu_torch.core.numerics import log1mexp
from bipymc_tpu_torch.models.targets import MAX_MODES, kernel_operands
from bipymc_tpu_torch.ops import _build

# lanes of the packed per-step scalars [K, n, 4]
S_SZ1, S_SW, S_LU1, S_LU2 = 0, 1, 2, 3
N_SCAL = 4

ROUTES = ("latency", "throughput", "global")
STAGING = ("none", "ring", "whole")
# The H100's shared memory a block may opt in to, bytes (the entry point
# reads the card's own figure)
MAX_SHARED_BYTES = 232_448
# csrc/fused_rw_plan.cuh's constants (kLatD, kThrD, kMaxCpb, kCpbN, kRing,
# kWholeBytes, kTJ, kTiles, kGlobalThreads, kVecs, kGlobalCpb)
_LAT_D, _THR_D = 32, 128         # the latency and throughput routes' d
_MAX_CPB, _CPB_N = 8, 128        # chains a block: n // 128, 1 to 8
_RING, _WHOLE_BYTES = 4, 96 * 1024
_TJ, _TILES, _GLOBAL_THREADS = 8, 8, 256
_VECS = 7                        # a chain's x, y1, y2 and four s halves
_GLOBAL_CPB = 4                  # the global route's chains a block, at most


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def plan(n: int, d: int, K: int, kind: int, n_modes: int = 0, route=None):
    """The launch ``csrc/fused_rw_plan.cuh::rw_plan`` makes for n chains
    in d dimensions, K steps, on target ``kind`` (0 the correlated
    Gaussian, 1 the mixture of ``n_modes``): ``(route, chains a block,
    threads, shared bytes, staging)``, staging ``"whole"`` (all K steps'
    inputs in shared memory from the start), ``"ring"`` (``_RING`` steps
    ahead) or ``"none"`` (read from device memory). ``route=None`` takes
    the latency route for d ≤ 32, the throughput route for the Gaussian up
    to d = 128, else the global route. None where the route asked for does
    not take the shape (latency above d = 32, throughput for the mixture
    or above d = 128), for a mixture of more than ``MAX_MODES`` modes, or
    where even one chain a block does not fit :data:`MAX_SHARED_BYTES`."""
    if kind == 1 and not 1 <= n_modes <= MAX_MODES:
        return None
    lat, thr = d <= _LAT_D, kind == 0 and d <= _THR_D
    chosen = route or ("latency" if lat else
                       "throughput" if thr else "global")
    if (chosen == "latency" and not lat) or (chosen == "throughput"
                                             and not thr):
        return None
    ld = cols = _round_up(d, 32)
    cap = _GLOBAL_CPB if chosen == "global" else _MAX_CPB
    for cpb in range(min(cap, max(1, n // _CPB_N)), 0, -1):
        threads = 32 * cpb
        floats = MAX_MODES                   # the mixture's log weights
        if chosen == "throughput":
            threads = max(threads, 2 * cols)   # two threads a column
            floats += ld + cpb * _VECS * ld  # the mean; a chain's vectors
        if chosen != "latency" and kind == 0:
            floats += 2 * cpb * ld           # r1, r2 a chain
        if chosen == "global" and kind == 0:   # a thread a column of inv
            threads = max(threads, min(cols, _GLOBAL_THREADS))
            floats += _TILES * _TJ * threads       # the ring of inv tiles
        staging = "none"
        if chosen != "global":
            slot = cpb * (2 * d + 4)
            staging = "whole" if 4 * slot * K <= _WHOLE_BYTES else "ring"
            floats += (K if staging == "whole" else _RING) * slot
        if 4 * floats <= MAX_SHARED_BYTES:
            return chosen, cpb, threads, 4 * floats, staging
    return None


def max_d(kind: int, n_modes: int = 0) -> int | None:
    """The largest d for which :func:`plan` finds a launch for one chain
    (20,832 for the correlated Gaussian), or None for the mixture, which
    the global route takes at any d."""
    if kind == 1:
        return None
    lo, hi = 1, 1 << 20            # plans at lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if plan(1, mid, 1, kind, n_modes) is None:
            hi = mid
        else:
            lo = mid
    return lo


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
                   steps_per_cell=1, route=None):
    """Advance K random-walk steps: returns (x_hist [K, n, d], logp_hist
    [K, n], accepted [K, n] bool, stage [K, n] int32).

    x0 [n, d]; logp0 [n]; dy1 / dy2 [K, n, d] the stage-1 / stage-2
    displacements (pass ``dy2=None`` with ``delayed=False``); scal
    [K, n, 4] packed (‖z₁‖², ‖z₁ − z₂/√κ‖², log u₁, log u₂), of which
    only log u₁ is read without ``delayed``. ``steps_per_cell`` is kept
    for the JAX signature: it must divide K and changes nothing here.
    On the card every operand is float32 and contiguous, and
    ``log_prob`` must carry a kernel form: a correlated Gaussian up to
    d = :func:`max_d` (20,832; ``ValueError`` above) or a mixture of at
    most 16 modes at any d. ``route`` forces one of
    :data:`ROUTES`, for the checks that hold the routes together; a
    forced route that does not take the shape raises ``ValueError``. The
    samplers never pass it.
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
    if route not in (None, *ROUTES):
        raise ValueError(f"route={route!r}: expected None or one of "
                         f"{ROUTES}")
    if x0.device.type == "cpu":
        return fused_rw_chunk_plain(x0, logp0, dy1, dy2, scal, log_prob,
                                    delayed)
    kind, c0, c1, n_modes, f0, f1 = kernel_operands(
        log_prob, x0.device, d, "fused_rw_chunk")
    operands = [x0, logp0, dy1, scal, c0, c1] + ([dy2] if delayed else [])
    _check_cuda(x0, operands)
    force = -1 if route is None else ROUTES.index(route)
    chosen = (ctypes.c_int * 6)()
    err = _build.library("fused_rw_chunk_plan")(
        n, d, K, kind, n_modes, force, ctypes.addressof(chosen))
    if err == _build.ERR_SHARED_MEMORY:
        if route is not None:
            raise ValueError(f"route={route!r} does not take n={n}, d={d}, "
                             f"K={K} on this target (see "
                             "ops/fused_rw_chunk.plan)")
        raise ValueError(f"fused_rw_chunk: the global route keeps the "
                         f"Gaussian's residuals, 8·d bytes a chain, in "
                         f"shared memory and takes d up to {max_d(kind)}; "
                         f"d={d} (the plain version, on the CPU, takes any d)")
    _build.check(err, "fused_rw_chunk")
    dev = x0.device
    x_hist = torch.empty((K, n, d), dtype=torch.float32, device=dev)
    lp_hist = torch.empty((K, n), dtype=torch.float32, device=dev)
    acc_hist = torch.empty((K, n), dtype=torch.bool, device=dev)
    stage_hist = torch.empty((K, n), dtype=torch.int32, device=dev)
    # the global route's workspace: a chain's x, y1, y2 and s
    work = (torch.empty((n, _VECS, chosen[5]), dtype=torch.float32,
                        device=dev)
            if ROUTES[chosen[0]] == "global" else None)
    err = _build.library("fused_rw_chunk")(
        x0.data_ptr(), logp0.data_ptr(), dy1.data_ptr(),
        dy2.data_ptr() if delayed else None, scal.data_ptr(), K, n, d,
        int(bool(delayed)), kind, c0.data_ptr(), c1.data_ptr(), n_modes, f0,
        f1, chosen[0], None if work is None else work.data_ptr(),
        x_hist.data_ptr(), lp_hist.data_ptr(), acc_hist.data_ptr(),
        stage_hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_rw_chunk")
    fused_rw_chunk.last_plan = (ROUTES[chosen[0]], *chosen[1:4],
                                STAGING[chosen[4]])
    fused_rw_chunk.launches += 1
    return x_hist, lp_hist, acc_hist, stage_hist


fused_rw_chunk.launches = 0
fused_rw_chunk.last_plan = None


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
