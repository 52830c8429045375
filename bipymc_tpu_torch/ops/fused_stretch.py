"""Kernel B9: G stretch-move generations in one launch, and its plain
version.

Counterpart of ``bipymc_tpu/ops/fused_stretch.py``. The walker population
(x, logp) stays on the device across a chunk of G generations, each two
red-black half-updates (emcee's parallel scheme): the walkers of the
first half move against the second half as it stood, then the second
half against the first half's new positions. The per-walker randomness
comes in precomputed (``samplers/stretch_fused.py``): for generation g
and walker i, its partner row ``j[g, i]`` (in the other half), its
stretch factor ``z[g, i]`` and ``log_u[g, i]``; rows ``< half`` are read
in the first half-update and rows ``>= half`` in the second. The partner
index is int32, not a float lane: the JAX kernel packs it among the
floats only because Mosaic takes its scalars as one array.

:func:`half_update` is one half-update; the per-generation engine
(``samplers/stretch.py``) and :func:`fused_stretch_plain` both call it,
so the two engines share one formula. :func:`fused_stretch` has the
plain version's signature and returns: a tensor on the CPU goes to the
plain version, which takes any batched target; a CUDA tensor goes to
``csrc/fused_stretch.cu``, which evaluates the built-in targets' kernel
forms (``models/targets.py``, ``csrc/target.cuh``), or the call raises.
``fused_stretch.launches`` counts the kernel's launches.

The kernel makes two choices: the population in shared memory for the
whole launch where it fits, else in ``x_hist`` itself (global memory)
(its route); the target's constants in shared memory where they fit,
else read from device memory, the Gaussian's inverse streamed through a
ring of tiles (so either target at any d, the Gaussian up to
:func:`max_d`). One C function chooses both
(``csrc/fused_stretch_plan.cuh``); :func:`plan` mirrors it, for the CPU
tests and for printing, and ``fused_stretch.last_plan`` is what the last
launch chose.
"""

import ctypes

import torch

from bipymc_tpu_torch.models.targets import kernel_operands
from bipymc_tpu_torch.ops import _build

# The API's cap on the fused engine's population, as in the JAX package.
# There it bounds the kernel's one-hot n² partner gather; here the gather
# is a direct index and the cap is kept as the contract only (ROADMAP A16).
MAX_WALKERS = 1024


# The H100's shared memory a block may opt in to, bytes (the entry point
# reads the card's own figure)
MAX_SHARED_BYTES = 232_448
ROUTES = ("shared", "global")          # where the population lives
CONSTS = ("shared", "device")          # where the target's constants are
# csrc/fused_stretch_plan.cuh's constants (kThreads, kRegD, kRegL,
# kRegThreads, kRingE, kRingTJ + 4 = kRingLdt, kRingSlots)
_THREADS = 1024
_REG_D, _REG_L, _REG_THREADS = 16, 4, 512
_RING_E, _RING_LDT, _RING_SLOTS = 4, 68, 2


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def plan(n: int, d: int, kind: int, n_modes: int = 0, route=None,
         consts=None):
    """The launch ``csrc/fused_stretch_plan.cuh::fused_stretch_plan`` makes
    for n walkers in d dimensions on target ``kind`` (0 the correlated
    Gaussian, 1 the mixture of ``n_modes``): ``(route, consts, L, threads,
    shared bytes)``. ``route``: ``"shared"`` (the population in shared
    memory) or ``"global"`` (in ``x_hist``); ``consts``: ``"shared"`` (the
    target's constants copied into shared memory) or ``"device"`` (read
    from device memory, the Gaussian's inverse through a ring of tiles);
    L the lanes a walker. Unforced (None), each is shared where it fits,
    the constants first. None where a forced choice does not fit
    :data:`MAX_SHARED_BYTES`, or where not even one walker's residual does
    (the Gaussian past :func:`max_d`)."""
    half = n // 2
    reg_shape = kind == 0 and d <= _REG_D and _REG_L * half <= _REG_THREADS
    L = 1
    while L < d and L < 32:
        L *= 2
    while L > 1 and L * half > _THREADS:
        L //= 2
    if reg_shape:
        L = _REG_L
    ldc = _round_up(max(d, _REG_D), 4)
    if ldc % 8 == 0:
        ldc += 4
    ld = _round_up(d, L)
    if ld // L % 2 == 0:
        ld += L
    cap = MAX_SHARED_BYTES // 4
    words = 6 * _round_up(n, 4)
    state = n * ld + _round_up(n, 4)
    r_per_group = ldc if kind == 0 else 0
    n_const = _round_up(d * ldc + ldc if kind == 0 else n_modes * d, 4)
    const_fits = n_const + words + r_per_group <= cap
    if consts == "shared" and not const_fits:
        return None
    c_place = "device" if consts == "device" or not const_fits else "shared"
    if c_place == "shared":
        front = n_const
    else:
        front = _RING_SLOTS * _RING_E * L * _RING_LDT if kind == 0 else 0
    fixed = front + words
    if fixed + r_per_group > cap:
        return None
    groups = min(half, _THREADS // L)
    shared_fits = fixed + groups * r_per_group + state <= cap
    if route == "shared" and not shared_fits:
        return None
    chosen = "global" if route == "global" or not shared_fits else "shared"
    if chosen == "global" and r_per_group:
        groups = min(groups, (cap - fixed) // r_per_group)
    smem = 4 * (fixed + _round_up(groups * r_per_group, 4)
                + (state if chosen == "shared" else 0))
    return chosen, c_place, L, _round_up(groups * L, 32), smem


def max_d(n: int, kind: int, n_modes: int = 0):
    """The largest d for which :func:`plan` finds a launch for n walkers
    on the correlated Gaussian (its walkers' residuals in shared memory:
    40,316 at n = 64, the least over even n up to :data:`MAX_WALKERS`),
    or None for the mixture, which B9 takes at any d."""
    if kind == 1:
        return None
    lo, hi = 1, 1 << 20            # plans at lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if plan(n, mid, kind, n_modes) is None:
            hi = mid
        else:
            lo = mid
    return lo


def check_walkers(n: int) -> None:
    """Raise ``ValueError`` for a population the fused engine does not
    take: an odd n, or more than :data:`MAX_WALKERS` walkers."""
    if n % 2:
        raise ValueError("the stretch move needs an even number of "
                         f"walkers, got {n}")
    if n > MAX_WALKERS:
        raise ValueError(f"the fused stretch engine takes at most "
                         f"{MAX_WALKERS} walkers, got {n}")


def stretch_accept(lp, lps, z, log_u, d: int):
    """The Goodman–Weare acceptance of a half-update's walkers:
    ``log α = (d − 1)·log z + logπ(x*) − logπ(x)``, capped at 0, −inf
    where ``lps`` is not finite. Returns (accepted, log α)."""
    log_alpha = (d - 1.0) * torch.log(z) + lps - lp
    log_alpha = torch.where(torch.isfinite(lps),
                            torch.clamp_max(log_alpha, 0.0), -torch.inf)
    return log_u < log_alpha, log_alpha


def half_update(x, lp, j, z, log_u, log_prob, lo: int, hi: int):
    """Move the walkers of rows ``lo … hi−1`` against their partners
    ``x[j]`` (rows of the other half, which do not move), evaluating only
    their ``hi − lo`` target values. j, z, log_u: [n], of which rows
    lo … hi−1 are read. Returns (x, lp, accepted [hi − lo], log α
    [hi − lo]); x and lp are new tensors."""
    x_i = x[lo:hi]
    x_j = x[j[lo:hi].long()]
    # x_j + z (x_i − x_j) with one rounding, as XLA contracts it and as
    # the kernel computes it (__fmaf_rn)
    x_star = torch.addcmul(x_j, z[lo:hi, None], x_i - x_j)
    lps = log_prob(x_star)
    acc, log_alpha = stretch_accept(lp[lo:hi], lps, z[lo:hi],
                                    log_u[lo:hi], x.shape[1])
    x = torch.cat([x[:lo], torch.where(acc[:, None], x_star, x_i), x[hi:]])
    lp = torch.cat([lp[:lo], torch.where(acc, lps, lp[lo:hi]), lp[hi:]])
    return x, lp, acc, log_alpha


def stretch_generation(x, lp, j, z, log_u, log_prob):
    """One generation, both half-updates. Returns (x, lp, accepted [n],
    log α [n]); row i's bit and log α are its own half-update's."""
    n = x.shape[0]
    half = n // 2
    x, lp, a1, la1 = half_update(x, lp, j, z, log_u, log_prob, 0, half)
    x, lp, a2, la2 = half_update(x, lp, j, z, log_u, log_prob, half, n)
    return x, lp, torch.cat([a1, a2]), torch.cat([la1, la2])


def fused_stretch_plain(x0, logp0, j, z, log_u, log_prob, half):
    """The G generations in torch ops; ``log_prob`` is any batched
    target. Returns (x_hist [G, n, d], logp_hist [G, n], accepted [G, n]
    bool)."""
    _check_shapes(x0, logp0, j, z, log_u, half)
    G = j.shape[0]
    x, lp = x0, logp0
    xs, lps, accs = [], [], []
    for g in range(G):
        x, lp, acc, _ = stretch_generation(x, lp, j[g], z[g], log_u[g],
                                           log_prob)
        xs.append(x)
        lps.append(lp)
        accs.append(acc)
    return torch.stack(xs), torch.stack(lps), torch.stack(accs)


def fused_stretch(x0, logp0, j, z, log_u, log_prob, half, route=None,
                  consts=None):
    """Advance G stretch generations (2G half-updates) in one launch.

    x0 [n, d]; logp0 [n]; j [G, n] int32 partner rows (rows < half point
    into the upper half, rows >= half into the lower); z, log_u [G, n].
    Returns (x_hist [G, n, d], logp_hist [G, n], accepted [G, n] bool,
    either half-update accepted). On the card every float operand is
    float32 and ``log_prob`` must carry a kernel form; the correlated
    Gaussian past :func:`max_d` raises ``ValueError``.
    ``route="shared"`` or ``"global"`` forces where the population lives,
    ``consts="shared"`` or ``"device"`` where the target's constants are
    read, for the checks that hold the routes together; a forced choice
    that does not fit raises ``ValueError``. The samplers pass neither.
    """
    if route not in (None, *ROUTES):
        raise ValueError(f"route={route!r}: expected None or one of "
                         f"{ROUTES}")
    if consts not in (None, *CONSTS):
        raise ValueError(f"consts={consts!r}: expected None or one of "
                         f"{CONSTS}")
    if x0.device.type == "cpu":
        return fused_stretch_plain(x0, logp0, j, z, log_u, log_prob, half)
    _check_shapes(x0, logp0, j, z, log_u, half)
    G, n = j.shape
    d = x0.shape[1]
    if x0.device.type != "cuda":
        raise ValueError(f"fused_stretch: no kernel for device {x0.device}")
    kind, c0, c1, n_modes, f0, f1 = kernel_operands(
        log_prob, x0.device, d, "fused_stretch")
    for a in (x0, logp0, z, log_u, j, c0, c1):
        if a.device != x0.device:
            raise ValueError(f"an operand is on {a.device}, x0 on "
                             f"{x0.device}")
        if not a.is_contiguous():
            raise ValueError("operands must be contiguous")
    if any(a.dtype != torch.float32 for a in (x0, logp0, z, log_u)):
        raise ValueError("fused_stretch takes float32 x0, logp0, z and "
                         "log_u on the card")
    if j.dtype != torch.int32:
        raise ValueError(f"j must be int32, got {j.dtype}")
    dev = x0.device
    x_hist = torch.empty((G, n, d), dtype=torch.float32, device=dev)
    lp_hist = torch.empty((G, n), dtype=torch.float32, device=dev)
    acc_hist = torch.empty((G, n), dtype=torch.bool, device=dev)
    chosen = (ctypes.c_int * 5)()
    err = _build.library("fused_stretch")(
        x0.data_ptr(), logp0.data_ptr(), j.data_ptr(), z.data_ptr(),
        log_u.data_ptr(), G, n, d, kind, c0.data_ptr(), c1.data_ptr(),
        n_modes, f0, f1, x_hist.data_ptr(), lp_hist.data_ptr(),
        acc_hist.data_ptr(), -1 if route is None else ROUTES.index(route),
        -1 if consts is None else CONSTS.index(consts),
        ctypes.addressof(chosen), torch.cuda.current_stream(dev).cuda_stream)
    if err == _build.ERR_SHARED_MEMORY and route is None and consts is None:
        raise ValueError(
            f"fused_stretch: kernel B9 keeps each walker's residual, "
            f"4·d bytes, in shared memory and takes the correlated "
            f"Gaussian up to d={max_d(n, kind)} at n={n}; d={d} (the plain "
            f"version, on the CPU, takes any d)")
    _build.check(err, "fused_stretch")
    fused_stretch.last_plan = (ROUTES[chosen[0]], CONSTS[chosen[1]],
                               *chosen[2:])
    fused_stretch.launches += 1
    return x_hist, lp_hist, acc_hist


fused_stretch.launches = 0
fused_stretch.last_plan = None


def _check_shapes(x0, logp0, j, z, log_u, half):
    if x0.dim() != 2:
        raise ValueError(f"x0 must be [n, d], got {tuple(x0.shape)}")
    n = x0.shape[0]
    check_walkers(n)
    if half != n // 2:
        raise ValueError(f"half={half}, but n={n}")
    G = j.shape[0]
    if logp0.shape != (n,) or any(a.shape != (G, n) for a in (j, z, log_u)):
        raise ValueError(
            f"logp0 must be [{n}] and j, z, log_u [G, {n}], got "
            f"{tuple(logp0.shape)}, {tuple(j.shape)}, {tuple(z.shape)}, "
            f"{tuple(log_u.shape)}")
