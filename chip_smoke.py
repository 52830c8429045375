#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; a phase that fails raises and the script exits
non-zero:

1. The card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel of the path from ``bipymc_tpu_torch/csrc/``.
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge shapes: B3 (``distinct_idx``) exactly
   equal, B2 (``dream_propose``) within x_star rtol 1e-5 / atol 1e-6 and
   log_jac rtol 1e-5 / atol 1e-4. Each kernel and its plain version are
   timed two ways at the main path's shapes: device time per call (the
   sum of the kernels' own durations from ``torch.profiler`` over 200
   calls; ``ms`` and ``plain_ms`` in the kernels line) and time per call
   as the stream sees it (CUDA events around each call, median of 300
   after a warm-up, so the host's launch overhead is inside; ``call_ms``
   and ``plain_call_ms``), beside a one-element torch op timed the same
   way as the floor of any launch. (The whole DREAM-zs step on the card
   is held against the same step on the CPU by
   ``tests/test_torch_cuda.py::test_step_on_card_matches_step_on_cpu``.)
2b. B4 (``fused_rw_chunk``) against its plain version
   on the card: ``delayed`` in {False, True} × the two targets with a
   kernel form × (n, d, K) in {(1, 2, 50), (4, 2, 20), (37, 129, 7),
   (256, 100, 50)}, and a non-finite ``dy1`` row that must be rejected.
   Accept decisions and stages exactly equal, x and logp within rtol
   1e-5 / atol 1e-6. Timed at the config-1 shape (the kernels line) and
   at the wide shape.
2c. B5 (``sqdist``) and B6 (``bchol``: ``cholesky_batched`` and
   ``cholesky_solve_batched``) against their plain versions on the card:
   B5 at config 4's [64, 512, 2] x [64, 512, 2] and at odd shapes within
   atol 1e-3; B6 at config 4's [64, 512, 512] and at (b, n) in {(3, 64),
   (5, 200), (12, 256), (8, 1000)}, L within atol 5e-6·max|L| and z
   within atol 1e-5·max|z|, L bit-equal between the two entry points, and
   a batch with a matrix that is not positive definite: NaN in the same
   matrices on both sides. B6 also on config 4's own Gram matrices
   (``GpRegressor._gram`` at 64 θ from phase 7's start to where its
   chains end), where both float32 routes are held to a float64 factor:
   the kernel within 1.5 x the plain version's distance from it, and
   within ``GRAM_TOL`` of it and of the plain version. Both kernels timed
   at config 4's shapes on the device clock, with a library call beside
   them (``torch.cdist``, distances; ``torch.linalg.cholesky_ex``, L
   alone, beside the kernel's L alone).
3. The main path: BASELINE config 3 at full width through ``DreamZs``
   (256 chains, the 100-d four-mode mixture, archive 8192, burn-in 500),
   2,500 warm-up generations then a timed window of 5,000. Both kernels
   must have launched once per generation, and every mode must still hold
   a chain. Then 200 more generations, timed alone and then under
   ``torch.profiler``, give the device's busy share and time by kernel.
4. The R̂ stop: 256 chains in one basin, ``run_mcmc_until`` to R̂ < 1.1,
   one warm call, ``reset()``, one timed call. Both kernels must have
   launched once per generation of the two calls.
5. The config-1 main path as ``benchmarks/run_all.py`` runs it:
   ``Dram(correlated_gaussian([1, -1], [[2, .8], [.8, 1]]), seed=1,
   n_chains=1, fused=True)``, 20,000 steps, a warm continuation of
   20,000, a timed continuation of 20,000. B4 must have launched
   3 × 20,000 / 50 = 1,200 times, and the posterior must match the truth
   (mean within 0.15, every covariance entry within 0.3). Then 10 chunks
   timed alone and 10 under the profiler, and the Welford replay's share
   of a chunk.
6. The R̂ stop on the fused RW path: ``Dram(fused=True)``, 4 chains,
   ``run_mcmc_until`` to R̂ < 1.1, one warm call, ``reset()``, one timed
   call; B4 must have launched once per fused chunk of the two calls.
7. BASELINE config 4 at full width as ``benchmarks/run_all.py`` runs it:
   ``Dram(seed=1, n_chains=64)`` over the GP log-ML of 512 points in 2-d
   plus a Gaussian prior, 2,000 steps from 0 with ``cov_est = 0.05 I``,
   then a timed continuation of 2,000. B5 and B6 must each have launched
   1 + 2 x 2,000 times in the first run and 2 x 2,000 in the timed one;
   every final logp must be finite, and the card's log-ML at 4 of the
   final θ must be within rtol 1e-4 of a float64 NumPy log-ML. Then 50
   steps timed alone and under the profiler.
8. One JSON line of the kernels, the card's line, and the result line.

Exits non-zero, printing no result, where ``torch.cuda.is_available()``
is false or the ``bipymc_tpu_torch`` package is not beside this file.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_CHAINS, D, CAPACITY = 256, 100, 8192
WARM_GENS, TIMED_GENS = 2500, 5000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, CUDA cores (also taken for int32)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, reps=300, warmup=20):
    """Median time of one call of ``fn`` as the stream sees it: CUDA
    events recorded around each call, host launch overhead included."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def device_times(fn, reps):
    """{kernel name: (µs, calls)} of what ``reps`` calls of ``fn`` ran on
    the card, from the profiler's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {e.key: (e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0}
    if not out:
        raise AssertionError("the profiler recorded no device time")
    return out


def device_ms(fn, reps=200, warmup=20):
    """Device time of one call of ``fn``: the summed durations of the
    kernels it runs, over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    return sum(us for us, _ in device_times(fn, reps).values()) / reps / 1e3


# ---------------------------------------------------------------- phase 2
def b3_case(n_chains, k, n, with_exclude, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    block = torch.randint(-2 ** 31, 2 ** 31, (n_chains, k + 9), generator=g,
                          device=dev, dtype=torch.int32)
    words = block[:, 5:5 + k]           # strided, as the step passes them
    ex = (torch.randperm(n_chains, generator=g, device=dev).to(torch.int32)
          % n if with_exclude else None)
    return words, ex


def check_b3(dev):
    from bipymc_tpu_torch.ensemble.indices import distinct_from_bits
    from bipymc_tpu_torch.ops.distinct_idx import distinct_idx

    cases = [(N_CHAINS, 6, CAPACITY, False)]
    for k in (3, 6):
        for n in (k, k + 1, 17, CAPACITY):
            for ex in (False, True):
                for n_chains in (5, 37):
                    cases.append((n_chains, k, max(n, k + ex), ex))
    for i, (n_chains, k, n, ex) in enumerate(cases):
        words, exclude = b3_case(n_chains, k, n, ex, seed=i, dev=dev)
        out = distinct_idx(words, k, n, exclude)
        ref = distinct_from_bits(words, k, n, exclude)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"B3 differs from its plain version at "
                                 f"n_chains={n_chains} k={k} n={n} "
                                 f"exclude={ex}")
    log(f"B3 distinct_idx: bit-equal to the plain version in {len(cases)} "
        "cases")

    words, _ = b3_case(N_CHAINS, 6, CAPACITY, False, seed=99, dev=dev)
    kernel = lambda: distinct_idx(words, 6, CAPACITY)
    plain = lambda: distinct_from_bits(words, 6, CAPACITY)
    times = (device_ms(kernel), device_ms(plain), call_ms(kernel),
             call_ms(plain))
    k, m = 6, 6
    n_bytes = N_CHAINS * k * 4 * 2              # words in, indices out
    n_ops = N_CHAINS * k * (1 + 6 * m)          # rem, shift, insert (int32)
    return kernel_record(
        "distinct_idx", "bipymc_tpu_torch/csrc/distinct_idx.cu",
        "bipymc_tpu/ops/distinct_idx.py:65", 0.0, times, n_bytes, n_ops)


def b2_operands(n, d, snooker, jump, ties, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(generator=g, device=dev, dtype=torch.float32)
    k = 6
    x = torch.randn((n, d), **f32)
    rows = x[:, None, :] + 2.0 * torch.randn((n, k, d), **f32)
    block = torch.rand((n, 3 * d + 11), **f32)
    u_mask, u_e = block[:, 11:11 + d], block[:, 11 + d:11 + 2 * d]
    if ties:
        u_mask[:, ::2] = 0.0625
        u_mask[:, 1::2] = torch.clamp_min(u_mask[:, 1::2], 0.5)
    eps = torch.randn((n, d), **f32)
    delta = torch.clamp_max(1.0 + torch.floor(torch.rand(n, **f32) * 3), 3.0)
    cr = torch.randint(1, 4, (n,), generator=g, device=dev).float() / 3.0
    gamma_s = 1.2 + torch.rand(n, **f32)
    is_snk = {"all": torch.ones(n, device=dev),
              "none": torch.zeros(n, device=dev),
              "mixed": (torch.rand(n, **f32) < 0.5).float()}[snooker]
    gj = torch.full((n,), float(jump), device=dev)
    scal = torch.stack([delta, cr, gamma_s, is_snk, gj], dim=1)
    return x, rows, u_mask, u_e, eps, scal


def check_b2(dev):
    from bipymc_tpu_torch.ops.dream_proposal import (dream_propose,
                                                     propose_plain)

    kw = dict(n_pairs=3, b=1e-4, b_star=1e-6)
    main_err = None
    cases = [(N_CHAINS, D, "mixed", False, False),
             (N_CHAINS, D, "mixed", True, False)]
    for d in (1, 3, 8, 100, 129):
        for n in (5, 32):
            for snooker in ("all", "none", "mixed"):
                for jump in (False, True):
                    for ties in (False, True):
                        cases.append((n, d, snooker, jump, ties))
    for i, (n, d, snooker, jump, ties) in enumerate(cases):
        ops = b2_operands(n, d, snooker, jump, ties, seed=i, dev=dev)
        x_star, log_jac = dream_propose(*ops, d_true=d, **kw)
        ref_x, ref_j = propose_plain(*ops, d_true=d, **kw)
        torch.cuda.synchronize()
        ex = (x_star - ref_x).abs()
        ej = (log_jac - ref_j).abs()
        if not (bool(torch.all(ex <= 1e-6 + 1e-5 * ref_x.abs()))
                and bool(torch.all(ej <= 1e-4 + 1e-5 * ref_j.abs()))
                and bool(torch.all(torch.isfinite(x_star)))):
            raise AssertionError(
                f"B2 differs from its plain version at n={n} d={d} "
                f"snooker={snooker} jump={jump} ties={ties}: max |dx| "
                f"{float(ex.max()):.3g}, max |d log_jac| "
                f"{float(ej.max()):.3g}")
        if i < 2:
            err = max(float(ex.max()), float(ej.max()))
            main_err = err if main_err is None else max(main_err, err)
    log(f"B2 dream_propose: within tolerance of the plain version in "
        f"{len(cases)} cases; main-shape max abs error {main_err:.3g}")

    ops = b2_operands(N_CHAINS, D, "mixed", False, False, seed=99, dev=dev)
    kernel = lambda: dream_propose(*ops, d_true=D, **kw)
    plain = lambda: propose_plain(*ops, d_true=D, **kw)
    times = (device_ms(kernel), device_ms(plain), call_ms(kernel),
             call_ms(plain))
    n, d, k = N_CHAINS, D, 6
    n_bytes = 4 * (n * d * (1 + k + 3 + 1) + n * 5 + n)
    n_snk = int(ops[5][:, 3].sum())
    # pass 1: 7 flops a dim; pass 2: 6 (snooker) or 3·δ_max + 10 (parallel)
    n_ops = n * d * 7 + n_snk * d * 6 + (n - n_snk) * d * (3 * 3 + 10)
    return kernel_record(
        "dream_propose", "bipymc_tpu_torch/csrc/dream_proposal.cu",
        "bipymc_tpu/ops/dream_proposal.py:123", main_err, times, n_bytes,
        n_ops)


def kernel_record(name, source, replaces, err, times, n_bytes, n_ops,
                  library_ms=None):
    ms, plain_ms, k_call, p_call = times
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    log(f"{name}: device ms per call: kernel {ms:.6f}, plain "
        f"{plain_ms:.6f}; stream ms per call: kernel {k_call:.6f}, plain "
        f"{p_call:.6f}; bound {max(t_bytes, t_ops):.2e} ms ({n_bytes} B, "
        f"{n_ops} ops)")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "call_ms": k_call,
            "plain_call_ms": p_call, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def launch_floor(dev):
    """The floor for any one launch from Python: a one-element torch op,
    timed as the kernels are."""
    one, out = torch.ones(1, device=dev), torch.empty(1, device=dev)
    op = lambda: torch.neg(one, out=out)
    log("launch floor:", json.dumps({"device_ms": device_ms(op),
                                     "call_ms": call_ms(op)}))


# ---------------------------------------------------------------- phase 3
def main_path(dev):
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
    from bipymc_tpu_torch.ops.dream_proposal import dream_propose

    means = bt.baseline_config3_means(D)
    log_prob = bt.gaussian_mixture(means, sigma=1.0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    theta0 = bt.stratified_mode_init(g, means, N_CHAINS, var=4.0, device=dev)
    s = bt.DreamZs(log_prob, n_chains=N_CHAINS, seed=SEED, burnin_gens=500,
                   archive_capacity=CAPACITY, device=dev)
    distinct_idx.launches = dream_propose.launches = 0
    t0 = time.perf_counter()
    s.run_mcmc(WARM_GENS, theta0)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.run_mcmc(TIMED_GENS)
    elapsed = time.perf_counter() - t0
    launches = {"distinct_idx": distinct_idx.launches,
                "dream_propose": dream_propose.launches}
    n_gens = WARM_GENS + TIMED_GENS
    for name, count in launches.items():
        if count != n_gens:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{n_gens} generations")

    chains = s.get_chain(discard=WARM_GENS)          # [256, 5000, 100]
    if chains.shape != (N_CHAINS, TIMED_GENS, D) or \
            not np.all(np.isfinite(chains)):
        raise AssertionError(f"history: shape {chains.shape} or non-finite")
    gens_per_sec = TIMED_GENS / elapsed
    ess, ess_per_sec = bt.ess_rate(chains, gens_per_sec)
    acc = float(np.mean(s._history["accepted"][WARM_GENS:]))
    occ = bt.mode_occupancy(chains[:, -1], means)
    result = {
        "gens_per_sec": gens_per_sec,
        "chain_steps_per_sec": gens_per_sec * N_CHAINS,
        "ess_window": ess, "ess_per_sec": ess_per_sec,
        "acceptance": acc, "mode_occupancy": occ.tolist(),
        "warmup_s": warm_s, "timed_s": elapsed, "launches": launches}
    log("main path:", json.dumps(result))
    if occ.min() == 0:
        raise AssertionError(f"a mode lost all its chains: {occ.tolist()}")
    busy_share(s)
    return launches


def busy_share(s, n_units=200, per_unit=1, unit="gen"):
    """The device's busy share of a unit of work, and its time by kernel:
    ``n_units`` units of ``per_unit`` steps timed alone, then as many
    under the profiler (which slows the host, not the kernels)."""
    n_steps = n_units * per_unit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_mcmc(n_steps)
    wall_us = (time.perf_counter() - t0) / n_units * 1e6
    rows = device_times(lambda: s.run_mcmc(n_steps), 1)
    busy_us = sum(us for us, _ in rows.values()) / n_units
    log("device:", json.dumps({f"wall_us_per_{unit}": wall_us,
                               f"busy_us_per_{unit}": busy_us,
                               "busy_share": busy_us / wall_us,
                               f"kernels_per_{unit}": sum(
                                   c for _, c in rows.values()) / n_units}))
    for key, (us, count) in sorted(rows.items(),
                                   key=lambda r: -r[1][0])[:15]:
        log(f"  {us / n_units:8.3f} us/{unit} {count / n_units:6.1f}/{unit}"
            f"  {key[:100]}")
    return wall_us


# ---------------------------------------------------------------- phase 4
def rhat_stop(dev):
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
    from bipymc_tpu_torch.ops.dream_proposal import dream_propose

    means = bt.baseline_config3_means(D)
    log_prob = bt.gaussian_mixture(means, sigma=1.0)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    theta0 = bt.var_ball(g, torch.full((D,), 4.0), N_CHAINS,
                         center=means[2], device=dev)
    s = bt.DreamZs(log_prob, n_chains=N_CHAINS, seed=SEED, burnin_gens=1000,
                   archive_capacity=CAPACITY, fused=False, device=dev)
    kw = dict(rhat_tol=1.1, chunk=200, max_chunks=150, warmup_chunks=6)
    distinct_idx.launches = dream_propose.launches = 0
    warm = s.run_mcmc_until(theta0, **kw)
    s.reset()
    t0 = time.perf_counter()
    info = s.run_mcmc_until(theta0, **kw)
    wall = time.perf_counter() - t0
    steps, rhat = int(info["steps"]), float(np.max(info["rhat"]))
    launches = {"distinct_idx": distinct_idx.launches,
                "dream_propose": dream_propose.launches}
    n_gens = int(warm["steps"]) + steps
    for name, count in launches.items():
        if count != n_gens:
            raise AssertionError(f"R-hat runs: {name} launched {count} "
                                 f"times in {n_gens} generations")
    log("rhat stop:", json.dumps({"wall_s": wall, "gens": steps,
                                  "rhat_max": rhat, "launches": launches}))
    if not rhat < 1.1:
        raise AssertionError(f"R-hat stop not reached: max R-hat {rhat}")


# ---------------------------------------------------------------- phase 2b
C1_MEAN, C1_COV = [1.0, -1.0], [[2.0, 0.8], [0.8, 1.0]]
C1_STEPS, C1_K = 20000, 50


def b4_target(kind, d):
    import bipymc_tpu_torch as bt
    rng = np.random.default_rng(d)
    if kind == "gaussian":
        a = rng.standard_normal((d, d))
        return bt.correlated_gaussian(rng.standard_normal(d),
                                      a @ a.T / d + np.eye(d))
    return bt.gaussian_mixture(2.0 * rng.standard_normal((4, d)))


def b4_operands(n, d, K, seed, dev):
    """x0, dy1, dy2, scal as the fused runner builds them (z draws, a
    2.4/√d step, the whitened norms, log u)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(generator=g, device=dev, dtype=torch.float32)
    isk = float(np.float32(1.0) / np.sqrt(np.float32(5.0)))
    step = 2.4 / math.sqrt(d)
    z1, z2 = torch.randn((K, n, d), **f32), torch.randn((K, n, d), **f32)
    u = torch.rand((2, K, n), **f32).clamp_min(1e-7)
    w = z1 - isk * z2
    scal = torch.stack([(z1 * z1).sum(-1), (w * w).sum(-1), u[0].log(),
                        u[1].log()], -1).contiguous()
    return (torch.randn((n, d), **f32), step * z1, isk * step * z2, scal)


def check_b4(dev):
    from bipymc_tpu_torch.ops.fused_rw_chunk import (fused_rw_chunk,
                                                     fused_rw_chunk_plain)

    cases = [(n, d, K, kind, delayed)
             for n, d, K in ((1, 2, 50), (4, 2, 20), (37, 129, 7),
                             (256, 100, 50))
             for kind in ("gaussian", "mixture")
             for delayed in (False, True)]
    errs = {}
    # the last case has a non-finite dy1 row, which must be rejected
    for i, (n, d, K, kind, delayed) in enumerate(
            cases + [(8, 2, 20, "gaussian", True)]):
        nonfinite = i == len(cases)
        lp = b4_target(kind, d)
        x0, dy1, dy2, scal = b4_operands(n, d, K, seed=i, dev=dev)
        if nonfinite:
            dy1[5, 3] = torch.inf
        dy2 = dy2 if delayed else None
        lp0 = lp(x0)
        out = fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, delayed)
        ref = fused_rw_chunk_plain(x0, lp0, dy1, dy2, scal, lp, delayed)
        torch.cuda.synchronize()
        ex = (out[0] - ref[0]).abs()
        el = (out[1] - ref[1]).abs()
        if not (torch.equal(out[2], ref[2]) and torch.equal(out[3], ref[3])
                and bool(torch.all(ex <= 1e-6 + 1e-5 * ref[0].abs()))
                and bool(torch.all(el <= 1e-6 + 1e-5 * ref[1].abs()))):
            raise AssertionError(
                f"B4 differs from its plain version at n={n} d={d} K={K} "
                f"{kind} delayed={delayed} nonfinite={nonfinite}: accepts "
                f"equal {torch.equal(out[2], ref[2])}, stages equal "
                f"{torch.equal(out[3], ref[3])}, max |dx| "
                f"{float(ex.max()):.3g}, max |dlogp| {float(el.max()):.3g}")
        if nonfinite and int(out[3][5, 3]) == 1:
            raise AssertionError("B4 accepted a non-finite proposal")
        errs[(n, d, K, kind, delayed)] = max(float(ex.max()),
                                             float(el.max()))
    log(f"B4 fused_rw_chunk: same decisions as the plain version, x and "
        f"logp within tolerance, in {len(cases) + 1} cases")

    def timed(n, d, K):
        lp = b4_target("gaussian", d)
        x0, dy1, dy2, scal = b4_operands(n, d, K, seed=99, dev=dev)
        lp0 = lp(x0)
        kernel = lambda: fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, True)
        plain = lambda: fused_rw_chunk_plain(x0, lp0, dy1, dy2, scal, lp,
                                             True)
        times = (device_ms(kernel), device_ms(plain, reps=20, warmup=3),
                 call_ms(kernel), call_ms(plain, reps=30, warmup=3))
        stage = kernel()[3]
        n_evals = K * n + int((stage != 1).sum())    # stage 2 where needed
        n_bytes = 4 * (n * d + n + 3 * K * n * d + 4 * K * n + d * d + d
                       + 2 * K * n) + K * n
        n_ops = n_evals * (2 * d * d + 3 * d) + 2 * K * n * d + 30 * K * n
        return times, n_bytes, n_ops

    times, n_bytes, n_ops = timed(256, 100, 50)
    wide = kernel_record("fused_rw_chunk", "", "", None, times, n_bytes,
                         n_ops)
    times, n_bytes, n_ops = timed(1, 2, C1_K)
    rec = kernel_record(
        "fused_rw_chunk", "bipymc_tpu_torch/csrc/fused_rw_chunk.cu",
        "bipymc_tpu/ops/fused_rw_chunk.py:148",
        errs[(1, 2, 50, "gaussian", True)], times, n_bytes, n_ops)
    rec["wide_shape"] = {k: wide[k] for k in (
        "ms", "plain_ms", "call_ms", "plain_call_ms", "bound_ms",
        "bound_by")}
    rec["wide_shape"]["shape"] = "K=50 n=256 d=100, DR, correlated Gaussian"
    rec["wide_shape"]["max_abs_err"] = errs[(256, 100, 50, "gaussian", True)]
    return rec


# ---------------------------------------------------------------- phase 5
def config1_path(dev):
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.fused_rw_chunk import fused_rw_chunk
    from bipymc_tpu_torch.samplers import rw

    lp = bt.correlated_gaussian(C1_MEAN, C1_COV)
    s = bt.Dram(lp, seed=1, n_chains=1, fused=True, device=dev)
    n = C1_STEPS
    fused_rw_chunk.launches = 0
    t0 = time.perf_counter()
    s.run_mcmc(n, np.zeros(2), cov_est=np.eye(2))
    first_s = time.perf_counter() - t0
    s.run_mcmc(n)
    t0 = time.perf_counter()
    s.run_mcmc(n)
    elapsed = time.perf_counter() - t0
    launches = fused_rw_chunk.launches
    if launches != 3 * n // C1_K:
        raise AssertionError(f"B4 launched {launches} times in {3 * n} "
                             f"steps, not {3 * n // C1_K}")
    kept = s.get_chain(discard=2 * n + n // 4)
    if kept.shape != (1, n - n // 4, 2) or not np.all(np.isfinite(kept)):
        raise AssertionError(f"history: shape {kept.shape} or non-finite")
    ess, ess_per_sec = bt.ess_rate(kept, n / elapsed)
    draws = s.get_chain(discard=n // 4, flat=True)
    mean, cov = draws.mean(0), np.cov(draws.T)
    result = {"steps_per_sec": n / elapsed, "ess_window": ess,
              "ess_per_sec": ess_per_sec,
              "acceptance": float(np.mean(s.acceptance_fraction)),
              "mean": mean.tolist(), "cov": cov.tolist(),
              "first_run_s": first_s, "timed_s": elapsed,
              "launches": {"fused_rw_chunk": launches}}
    log("config 1:", json.dumps(result))
    if not (np.all(np.abs(mean - np.array(C1_MEAN)) < 0.15)
            and np.all(np.abs(cov - np.array(C1_COV)) < 0.3)):
        raise AssertionError(f"config 1 posterior off the truth: mean "
                             f"{mean.tolist()}, cov {cov.tolist()}")
    wall_us = busy_share(s, n_units=10, per_unit=C1_K, unit="chunk")

    # the Welford replay and refresh of one chunk, alone
    st = s.final_state
    xh = st.theta.expand(C1_K, 1, 2).contiguous()

    def replay():
        mean_, m2, count = st.mean, st.m2, st.count
        for k in range(C1_K):
            mean_, m2, count = rw.welford(mean_, m2, count, xh[k])
        return rw.refresh(s.cfg, rw.proposal_scale(s.cfg, 2), m2, count,
                          st.chol)

    for _ in range(3):
        replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        replay()
    torch.cuda.synchronize()
    replay_us = (time.perf_counter() - t0) / 20 * 1e6
    log("welford replay:", json.dumps({
        "us_per_chunk": replay_us, "chunk_wall_us": wall_us,
        "share_of_chunk": replay_us / wall_us}))
    return launches


# ---------------------------------------------------------------- phase 6
def rw_rhat_stop(dev):
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.fused_rw_chunk import fused_rw_chunk

    lp = bt.correlated_gaussian(C1_MEAN, C1_COV)
    s = bt.Dram(lp, seed=1, n_chains=4, fused=True, t0=60,
                adapt_interval=20, device=dev)
    kw = dict(cov_est=0.5 * np.eye(2), rhat_tol=1.1, chunk=40,
              max_chunks=50)
    fused_rw_chunk.launches = 0
    warm = s.run_mcmc_until(np.zeros(2), **kw)
    s.reset()
    t0 = time.perf_counter()
    info = s.run_mcmc_until(np.zeros(2), **kw)
    wall = time.perf_counter() - t0
    steps, rhat = int(info["steps"]), float(np.max(info["rhat"]))
    n_chunks = (int(warm["steps"]) + steps) // 20
    log("rw rhat stop:", json.dumps({
        "wall_s": wall, "steps": steps, "rhat_max": rhat,
        "launches": {"fused_rw_chunk": fused_rw_chunk.launches}}))
    if fused_rw_chunk.launches != n_chunks:
        raise AssertionError(f"R-hat runs: B4 launched "
                             f"{fused_rw_chunk.launches} times in "
                             f"{n_chunks} fused chunks")
    if not rhat < 1.1:
        raise AssertionError(f"R-hat stop not reached: max R-hat {rhat}")


# ---------------------------------------------------------------- phase 2c
C4_CHAINS, C4_N = 64, 512


def config4_data():
    """Config 4's training set, as ``benchmarks/run_all.py:298-303``
    makes it."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-4, 4, (C4_N, 2)).astype(np.float32)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    y = (f + rng.normal(0, 0.2, C4_N)).astype(np.float32)
    return x, y


def b5_operands(c, n, m, k, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    A = 3.0 * torch.randn((c, n, k), generator=g, device=dev)
    B = 3.0 * torch.randn((c, m, k), generator=g, device=dev)
    return A, B


def check_b5(dev):
    from bipymc_tpu_torch.ops.pallas_kernels import sqdist, sqdist_plain

    # config 4: each chain's inputs scaled by its length-scales, centred
    x, _ = config4_data()
    g = torch.Generator(device=dev).manual_seed(5)
    ls = torch.exp(0.3 * torch.randn((C4_CHAINS, 1, 2), generator=g,
                                     device=dev))
    xs = torch.as_tensor(x, device=dev) / ls
    xs = xs - xs.mean(-2, keepdim=True)
    cases = [("config 4", xs, xs)]
    for c, n, m, k in ((1, 130, 140, 5), (3, 17, 9, 4), (2, 1000, 200, 33),
                       (5, 64, 64, 1), (7, 33, 300, 2)):
        A, B = b5_operands(c, n, m, k, seed=n + m + k, dev=dev)
        cases.append((f"c={c} n={n} m={m} k={k}", A, B))
    A, B = b5_operands(1, 40, 50, 3, seed=1, dev=dev)
    cases.append(("unbatched [40, 3] x [50, 3]", A[0], B[0]))
    A, B = b5_operands(2, 40, 50, 3, seed=2, dev=dev)
    A[1, 7, 0] = torch.nan
    cases.append(("a NaN input row", A, B))
    errs = []
    for label, A, B in cases:
        out, ref = sqdist(A, B), sqdist_plain(A, B)
        torch.cuda.synchronize()
        same_nan = torch.equal(torch.isnan(out), torch.isnan(ref))
        ok = torch.isfinite(ref)
        err = float((out[ok] - ref[ok]).abs().max()) if ok.any() else 0.0
        if not (same_nan and out.shape == ref.shape and err <= 1e-3):
            raise AssertionError(f"B5 differs from its plain version at "
                                 f"{label}: max |d| {err:.3g}, NaN in the "
                                 f"same places {same_nan}")
        errs.append(err)
    main_err = errs[0]
    log(f"B5 sqdist: within atol 1e-3 of the plain version in {len(cases)} "
        f"cases; config-4 max abs error {main_err:.3g}")

    kernel = lambda: sqdist(xs, xs)
    plain = lambda: sqdist_plain(xs, xs)
    library = lambda: torch.cdist(xs, xs)
    times = (device_ms(kernel), device_ms(plain), call_ms(kernel),
             call_ms(plain))
    c, n, k = C4_CHAINS, C4_N, 2
    n_bytes = 4 * (2 * c * n * k + c * n * n)
    n_ops = c * n * n * (2 * k + 3) + 2 * c * 2 * n * k
    return kernel_record(
        "sqdist", "bipymc_tpu_torch/csrc/sqdist.cu",
        "bipymc_tpu/ops/pallas_kernels.py:73", main_err, times, n_bytes,
        n_ops, library_ms=device_ms(library))


def spd_batch(b, n, seed, dev):
    """SPD test matrices as ``tests/test_pallas_bchol.py`` makes them:
    x xᵀ/24 + 3I with x [b, n, 24], and y [b, n]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, n, 24), generator=g, device=dev)
    a = x @ x.transpose(-1, -2) / 24 + 3 * torch.eye(n, device=dev)
    return a, torch.randn((b, n), generator=g, device=dev)


# about where phase 7's chains end (its posterior mean)
C4_THETA_END = (-0.18, 0.45, -0.26, -1.57)
GRAM_TOL = (1e-5, 1e-4)       # max|dL|/max|L|, max|dz|/max|z| per matrix


def config4_grams(dev):
    """Config 4's Gram matrices as phase 7 factors them:
    ``GpRegressor._gram`` (B5 inside) over the config-4 data at 64 θ spread
    from phase 7's start, 0, to where its chains end, each moved by
    N(0, 0.3²) per coordinate; and y [64, 512]."""
    import bipymc_tpu_torch as bt

    x, y = config4_data()
    rng = np.random.default_rng(11)
    theta = (np.linspace(0.0, 1.0, C4_CHAINS)[:, None]
             * np.array(C4_THETA_END)
             + 0.3 * rng.standard_normal((C4_CHAINS, 4)))
    t = torch.as_tensor(theta.astype(np.float32), device=dev)
    gp = bt.GpRegressor(device=dev)
    p = {"log_lengthscale": t[:, 0:2], "log_sigma_f": t[:, 2],
         "log_sigma_n": t[:, 3]}
    a = gp._gram(p, torch.as_tensor(x, device=dev))
    yn = gp._normalize(torch.as_tensor(y, device=dev))[0]
    return a, yn.expand(C4_CHAINS, C4_N).contiguous()


def rel_errors(L, z, L_ref, z_ref):
    """max |L − L_ref| / max |L_ref| and the same of z, each per matrix,
    the largest over the batch."""
    def worst(u, v):
        u, v = u.double().flatten(1), v.double().flatten(1)
        return float(((u - v).abs().amax(1) / v.abs().amax(1)).max())
    return worst(L, L_ref), worst(z, z_ref)


def check_b6_gram(dev):
    """B6 and its plain version on config 4's Gram matrices, each against
    a float64 factor of the same float32 matrices."""
    from bipymc_tpu_torch.ops.pallas_bchol import (cholesky_solve_batched,
                                                   cholesky_solve_plain)

    a, y = config4_grams(dev)
    L, z = cholesky_solve_batched(a, y)
    L_p, z_p = cholesky_solve_plain(a, y)
    L64, info = torch.linalg.cholesky_ex(a.double())
    if bool(torch.any(info != 0)):
        raise AssertionError("a config-4 Gram matrix is not positive "
                             "definite in float64")
    z64 = torch.linalg.solve_triangular(L64, y.double()[..., None],
                                        upper=False)[..., 0]
    ev = torch.linalg.eigvalsh(a.double())
    cond = (ev[:, -1] / ev[:, 0]).cpu().numpy()
    k_l, k_z = rel_errors(L, z, L64, z64)
    p_l, p_z = rel_errors(L_p, z_p, L64, z64)
    d_l, d_z = rel_errors(L, z, L_p, z_p)
    readings = {"cond_min": float(cond.min()),
                "cond_median": float(np.median(cond)),
                "cond_max": float(cond.max()),
                "kernel_vs_f64": [k_l, k_z], "plain_vs_f64": [p_l, p_z],
                "kernel_vs_plain": [d_l, d_z]}
    log("B6 on config-4 Gram matrices, the batch's worst max|dL|/max|L| "
        "and max|dz|/max|z|:", json.dumps(readings))
    # Both float32 routes stand ~cond·ε from the float64 factor, so the
    # SPD cases' 1e-5 z bound between them does not hold here. The limits:
    # the kernel no further from float64 than 1.5 x the plain version,
    # and within GRAM_TOL (L, z) of float64 and of the plain version.
    ok = (k_l <= 1.5 * p_l and k_z <= 1.5 * p_z
          and max(k_l, d_l) <= GRAM_TOL[0] and max(k_z, d_z) <= GRAM_TOL[1])
    if not ok:
        raise AssertionError(f"B6 on config-4 Gram matrices is off: "
                             f"{readings}, limits {GRAM_TOL} and 1.5 x the "
                             f"plain version's distance from float64")
    return readings


def check_b6(dev):
    from bipymc_tpu_torch.ops.pallas_bchol import (cholesky_batched,
                                                   cholesky_solve_batched,
                                                   cholesky_solve_plain)

    cases = [(C4_CHAINS, C4_N, False), (3, 64, False), (5, 200, False),
             (12, 256, False), (8, 1000, False), (8, 128, True)]
    errs = {}
    for i, (b, n, non_pd) in enumerate(cases):
        a, y = spd_batch(b, n, seed=i, dev=dev)
        if non_pd:                     # matrices 2 and 5: indefinite
            a[2] -= 10.0 * torch.eye(n, device=dev)
            a[5, n // 2, n // 2] = -1.0
        L, z = cholesky_solve_batched(a, y)
        L_only = cholesky_batched(a)
        L_ref, z_ref = cholesky_solve_plain(a, y)
        torch.cuda.synchronize()
        bad = torch.isnan(L).flatten(1).any(1)
        bad_ref = torch.isnan(L_ref).flatten(1).any(1)
        good = ~bad_ref
        e_l = float((L[good] - L_ref[good]).abs().max())
        e_z = float((z[good] - z_ref[good]).abs().max())
        s_l = float(L_ref[good].abs().max())
        s_z = float(z_ref[good].abs().max())
        ok = (torch.equal(bad, bad_ref)
              and bool(torch.isnan(L[bad]).all())
              and bool(torch.isnan(z[bad]).all())
              and torch.equal(L.nan_to_num(), L_only.nan_to_num())
              and torch.equal(torch.isnan(L), torch.isnan(L_only))
              and e_l <= 5e-6 * s_l and e_z <= 1e-5 * s_z
              and bool(torch.all(torch.triu(L[good], 1) == 0)))
        if non_pd and bad.tolist() != [j in (2, 5) for j in range(b)]:
            ok = False
        if not ok:
            raise AssertionError(
                f"B6 differs from its plain version at b={b} n={n} "
                f"non_pd={non_pd}: max |dL| {e_l:.3g} (bound "
                f"{5e-6 * s_l:.3g}), max |dz| {e_z:.3g} (bound "
                f"{1e-5 * s_z:.3g}), NaN matrices {bad.tolist()} vs "
                f"{bad_ref.tolist()}, L of the two entry points bit-equal "
                f"{torch.equal(L.nan_to_num(), L_only.nan_to_num())}")
        errs[(b, n)] = max(e_l, e_z)
    log(f"B6 bchol: L within 5e-6·max|L| and z within 1e-5·max|z| of the "
        f"plain version, L bit-equal between its two entry points, NaN in "
        f"the same matrices, in {len(cases)} cases")
    check_b6_gram(dev)

    a, y = spd_batch(C4_CHAINS, C4_N, seed=99, dev=dev)
    kernel = lambda: cholesky_solve_batched(a, y)
    plain = lambda: cholesky_solve_plain(a, y)
    # the one library call of the two: L alone, beside the kernel's L alone
    library = lambda: torch.linalg.cholesky_ex(a)
    times = (device_ms(kernel, reps=50, warmup=5),
             device_ms(plain, reps=50, warmup=5),
             call_ms(kernel, reps=100, warmup=5),
             call_ms(plain, reps=100, warmup=5))
    library_ms = device_ms(library, reps=50, warmup=5)
    log(f"B6 L alone, device ms per call: kernel "
        f"{device_ms(lambda: cholesky_batched(a), reps=50, warmup=5):.6f}, "
        f"torch.linalg.cholesky_ex {library_ms:.6f}")
    b, n = C4_CHAINS, C4_N
    n_bytes = 4 * (2 * b * n * n + 2 * b * n)   # a in, L out, y in, z out
    n_ops = b * (2 * n ** 3 // 3 + 2 * n * n)   # factor + forward solve
    return kernel_record(
        "bchol", "bipymc_tpu_torch/csrc/bchol.cu",
        "bipymc_tpu/ops/pallas_bchol.py:274", errs[(b, n)], times, n_bytes,
        n_ops, library_ms=library_ms)


# ---------------------------------------------------------------- phase 7
C4_STEPS = 2000


def np_log_ml(theta, x, y):
    """The GP log-ML in float64 NumPy (``benchmarks/run_all.py:329-340``,
    with the port's jitter floor 4·n·ε_f32·σ_f² for its 1e-5·σ_f²)."""
    x64, y64, t = (np.asarray(v, np.float64) for v in (x, y, theta))
    n = len(y64)
    ls, sf2, sn2 = np.exp(t[0:2]), np.exp(2.0 * t[2]), np.exp(2.0 * t[3])
    sq = ((x64[:, None, :] - x64[None, :, :]) / ls) ** 2
    jitter = 4 * n * float(np.finfo(np.float32).eps)
    kmat = sf2 * np.exp(-0.5 * sq.sum(-1)) + (sn2 + jitter * sf2) * np.eye(n)
    L = np.linalg.cholesky(kmat)
    v = np.linalg.solve(L, y64)
    return (-0.5 * v @ v - np.sum(np.log(np.diag(L)))
            - 0.5 * n * np.log(2.0 * np.pi))


def config4_path(dev):
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.pallas_bchol import cholesky_solve_batched
    from bipymc_tpu_torch.ops.pallas_kernels import sqdist

    x, y = config4_data()
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    gp = bt.GpRegressor(device=dev)

    def params(theta):
        return {"log_lengthscale": theta[:, 0:2], "log_sigma_f": theta[:, 2],
                "log_sigma_n": theta[:, 3]}

    def log_post(theta):
        return (gp.log_marginal_likelihood(params(theta), xt, yt)
                - 0.5 * torch.sum((theta / 2.0) ** 2, dim=-1))

    n = C4_STEPS
    s = bt.Dram(log_post, seed=1, n_chains=C4_CHAINS, device=dev)
    sqdist.launches = cholesky_solve_batched.launches = 0
    t0 = time.perf_counter()
    s.run_mcmc(n, np.zeros(4), cov_est=np.eye(4) * 0.05)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = {"sqdist": sqdist.launches,
             "bchol": cholesky_solve_batched.launches}
    t0 = time.perf_counter()
    s.run_mcmc(n)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"sqdist": sqdist.launches,
                "bchol": cholesky_solve_batched.launches}
    for name in launches:
        if first[name] != 1 + 2 * n or launches[name] - first[name] != 2 * n:
            raise AssertionError(
                f"{name} launched {first[name]} times in the first {n} "
                f"steps (want {1 + 2 * n}: the start and two DR stages a "
                f"step) and {launches[name] - first[name]} in the timed "
                f"{n} (want {2 * n})")

    final = s.final_state
    if not bool(torch.all(torch.isfinite(final.logp))):
        raise AssertionError("a final logp is not finite")
    kept = s.get_chain(discard=n + n // 4)
    if kept.shape != (C4_CHAINS, n - n // 4, 4) or \
            not np.all(np.isfinite(kept)):
        raise AssertionError(f"history: shape {kept.shape} or non-finite")
    steps_per_sec = n / elapsed
    ess, ess_per_sec = bt.ess_rate(kept, steps_per_sec)
    # the card's log-ML at the final θ (all 64, through B5 and B6) against
    # float64 NumPy at four of them
    lml = gp.log_marginal_likelihood(params(final.theta), xt, yt).cpu()
    theta = final.theta.cpu().numpy()
    picks = [0, 21, 42, 63]
    ref = np.array([np_log_ml(theta[i], x, y) for i in picks])
    rel = np.abs(lml.numpy()[picks] - ref) / np.abs(ref)
    result = {
        "steps_per_sec": steps_per_sec,
        "cholesky_evals_per_sec": 2 * C4_CHAINS * steps_per_sec,
        "ess_window": ess, "ess_per_sec": ess_per_sec,
        "acceptance": float(np.mean(s.acceptance_fraction)),
        "posterior_mean": kept.reshape(-1, 4).mean(0).tolist(),
        "lml_card": lml.numpy()[picks].tolist(), "lml_f64": ref.tolist(),
        "lml_rel_err": rel.tolist(), "first_run_s": first_s,
        "timed_s": elapsed, "launches": launches}
    log("config 4:", json.dumps(result))
    if not (np.all(np.isfinite(lml.numpy())) and np.all(rel < 1e-4)):
        raise AssertionError(f"config 4: the card's log-ML is off the "
                             f"float64 one: relative errors {rel.tolist()}")
    busy_share(s, n_units=50, per_unit=1, unit="step")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "bipymc_tpu_torch")):
        print("chip_smoke: no bipymc_tpu_torch package beside this file: "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from bipymc_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(built) or 'all cached'})")
    for name, (_, text) in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    records = [check_b3(dev), check_b2(dev), check_b4(dev), check_b5(dev),
               check_b6(dev)]
    launch_floor(dev)
    launches = main_path(dev)
    rhat_stop(dev)
    launches["fused_rw_chunk"] = config1_path(dev)
    rw_rhat_stop(dev)
    launches.update(config4_path(dev))
    for r in records:
        r["launches"] = launches[r["name"]]
    if not all(math.isfinite(r["ms"]) for r in records):
        raise AssertionError("a kernel time is not finite")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
