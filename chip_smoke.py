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
7. One JSON line of the kernels, the card's line, and the result line.

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


def kernel_record(name, source, replaces, err, times, n_bytes, n_ops):
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
            "library_ms": None}


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

    records = [check_b3(dev), check_b2(dev), check_b4(dev)]
    launch_floor(dev)
    launches = main_path(dev)
    rhat_stop(dev)
    launches["fused_rw_chunk"] = config1_path(dev)
    rw_rhat_stop(dev)
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
