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
   log_jac rtol 1e-5 / atol 1e-4, at config 3's [256, 100], config 5's
   [1,024, 2] and d in {1, 3, 8, 31, 32, 33, 64, 65, 100, 129, 300}
   (parallel, snooker and mixed chains, jump generations, tied u), and
   at d = d_true = 500 within log_jac atol ``B2_JAC_ATOL_D500``,
   printing its worst error by d; at d = d_true = 300 and 500 (snooker
   moves) the kernel and its plain version are held to a float64 run of
   the plain version: the kernel's log Jacobian no further from it than
   1.5 x the plain version's plus 1e-5, and both within (d_true - 1)/2 ·
   16 ε of it. B2 is timed at config 3 and at config
   5 over the launches the profiler recorded, with the host's µs a call
   of its wrapper taken apart (checks, allocations, the stream,
   pointers, the ctypes launch). Each kernel and its plain version are
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
   (256, 100, 50)}, the Gaussian at (2, 240, 5) and (256, 300, 4), and a
   non-finite ``dy1`` row that must be rejected, each on the route it
   chooses and on every route forced that takes the shape (latency,
   throughput, global), the launch's plan equal to
   ``ops/fused_rw_chunk.plan``'s. Accept decisions and stages exactly
   equal, x and logp within rtol 1e-5 / atol 1e-6, the routes' outputs
   equal bit for bit. Timed at the config-1 shape (the kernels line, with
   µs a step and the launch floor from the same call), at the wide shape
   (K = 50, n = 256, d = 100; the throughput and global routes in turns)
   and at n = 256, d = 240 and 300; µs a step also as the slope of device
   time over K (config 1 from K = 50 to 200, the wide shape from 10 to
   50), which leaves out the launch and the prologue.
2c. B5 (``sqdist``) and B6 (``bchol``: ``cholesky_batched`` and
   ``cholesky_solve_batched``) against their plain versions on the card:
   B5 at config 4's [64, 512, 2] x [64, 512, 2], at config 5's [256, 2]
   x [256, 2] and [256, 2] x [1024, 2] and at odd shapes (m % 4 in {1,
   2, 3}, whose rows take scalar stores; k = 8, its last register
   instance, and k = 9) within atol 1e-3, NaN in the same places, config
   5's readings within ``C5_GRAM_TOL``, and timed at config 5's shapes
   too; B6 at config 4's [64, 512, 512] and at (b, n) in {(3, 64),
   (5, 200), (12, 256), (8, 1000)}, and at the edges of its design: config
   4's n at b = 200 (one CTA a matrix; 64 take two) and b = 1, n in {1,
   31, 33, 511, 513, 1024, 1600}, L within atol 5e-6·max|L| and z within
   atol 1e-5·max|z|, L bit-equal between the two entry points, each
   launch's plan (P, bytes) equal to ``ops/pallas_bchol.plan``'s, P = 1
   and P = 2 both run, and a batch
   (two CTAs a matrix) with matrices that are not positive definite: NaN
   in the same matrices on both sides. B6 also on config 4's own Gram
   matrices
   (``GpRegressor._gram`` at 64 θ from phase 7's start to where its
   chains end), where both float32 routes are held to a float64 factor:
   the kernel within 1.5 x the plain version's distance from it, and
   within ``GRAM_TOL`` of it and of the plain version. Both kernels timed
   at config 4's shapes on the device clock (B6 over the launches the
   profiler recorded), with a library call beside them (``torch.cdist``,
   distances; ``torch.linalg.cholesky_ex``, L alone, beside the kernel's L
   alone).
2d. B5's gradient on config 5's operands against the plain version's
   autograd within ``B5_GRAD_TOL``·max|g|. B7 (``chol``) and B8
   (``trisolve``) against their plain versions on the card: B7 on one
   [256, 256] matrix (config 5), at n in {1, 4, 31, 32, 33, 200, 255,
   257, 480, 481, 512, 1000, 1024} (the cluster route up to 480, the
   cooperative one above, ``pallas_chol.plan``) and on [5, 130, 130],
   [3, 256, 256] and [4, 256, 256] batches within 5e-6·max|L|, NaN in
   exactly the indefinite matrices of a batch; B8 in both directions at
   b [256] and [256, 1024] (config 5), n in {1, 4, 31, 32, 33, 200, 255,
   256, 257, 1000, 1024, 4096} with m in {1, 7, 8, 9} (all of L's tiles
   in shared memory up to n = 256, a ring of them above,
   ``pallas_solve.plan``) and partial tiles of 8 columns, the batched
   and the shared-L forms, within 1e-5·max|x|. Both on config 5's own Gram
   matrices along ``optimize``'s trajectory (after 0, 10, 30, 100 and
   300 Adam steps), held to a float64 factor (solve) within 1.5 x the
   plain version's distance; their gradients against the plain routes'
   (autograd of ``cholesky_ex`` and ``solve_triangular``); B8's backward
   must launch the other direction. Timed at config 5's shapes with
   ``torch.linalg.cholesky_ex`` / ``solve_triangular`` as the library
   calls, B7 beside B6's kernel on the same one matrix, and B7's cluster
   route beside its cooperative route at [256, 256] in turns. B2 and B3
   are also held at config 5's 1,024 × 2 (phase 2).
2e. B1 (``fused_chunk``) against its plain version on the card: at
   config 3's own shapes, [G, n, k, d] = [10, 256, 6, 100], on the
   operands the fused runner builds from the config-3 run's own state and
   archive after its 500 burn-in generations; and at ragged shapes (n = 7,
   d = 3, G = 1 on both targets with a kernel form; G = 10, n = 37,
   d = 129 on the correlated Gaussian), and with a non-finite archive row
   that must be rejected, and the correlated Gaussian past B1's shared
   route at G = 10, n = 256, d in {240, 300}. Accept bits equal, except
   where the plain version's |log u − log α| < 1e-4 (counted and
   printed; that chain's later generations are then left out); x and
   logp within ``B1_TOL``. Each case's launch must take
   ``ops/fused_chunk.plan``'s launch (printed), and every route forced
   that takes the shape (shared, global) must give the chosen route's
   outputs bit for bit. Timed (device ms a launch over the launches the
   profiler recorded, which in a long process misses some at the start
   of each profile) at config 3's shape (the two routes in turns: shared,
   global, global, shared) and at d = 240 and 300 beside
   their bounds (in turns, 240, 300, 300, 240 twice, at config 3's reps
   and warm-up, by the profiler with the launches it recorded and by CUDA
   events; then each after the card idled a second, at 20 reps and 3 of
   warm-up). Then B1 in kernel-RNG mode (Philox drawn in the kernel)
   against its plain version on the same words
   (``core/rng.kernel_draw_bits``), on the kernel-RNG runner's own
   config-3 operands under the main path's run key from its first chunk
   (t0 = 500), and on the same ragged, non-finite and wide cases under a
   run key with its top bit set, with the same rule, limits, plans and
   routes; fed stream mode's words of the config-3 chunk as
   ``test_bits``, against stream-mode B1 on that chunk (the same rule).
   Timed at config 3's shape, stream and kernel-RNG mode in turns
   (stream, kernel, kernel, stream), and at d = 240 and 300 as in stream
   mode; its own record in the kernels line.
2g. B11 (``gather_rows``) against its plain version on the card, every
   case bit-equal (``torch.equal``): the fused chunk's [10, 256, 6]
   indices, drawn by B3 from the config-3 run's words after burn-in, into
   its [8192, 100] float32 archive; the per-generation [256, 6]; duplicate
   rows; indices below 0 and at or above the capacity (clamped, not
   wrapped); int64 indices; d in {1, 3, 129}; float64 and bfloat16
   buffers; a buffer with a row stride of 101; and an empty index set,
   which must launch nothing. Timed at the fused chunk's shape beside
   ``torch.index_select`` (the library call) and torch indexing.
2h. B10 (``accept_select``) against its plain version on the card, every
   case bit-equal by bit patterns (its ops are exact; NaN ≠ NaN defeats
   ``torch.equal``): [n, d] in {(256, 100) (config 3), (1024, 100), (4096,
   100), (1024, 2) (config 5's DREAM), (200, 37), (7, 129), (1, 1)} in
   float32 and (256, 100) in float64, random operands from the seed with
   the edge rows of ``testing.ACCEPT_EDGE_ROWS`` (logp* NaN, ±inf; the
   current logp NaN, ±inf; log_jac NaN; log u = −inf; logp* = logp), each
   of which must take its own decision. Timed at (256, 100) and (4096,
   100); no single torch call computes the function (library: none).
2f. B9 (``fused_stretch``) against its plain version on the card: at the
   stretch path's own shape, [G, n, d] = [64, 256, 16] on its target
   with its start and its first chunk's words, and at (G, n, d) in {(64,
   32, 16), (7, 2, 1), (5, 18, 3) on the mixture, (8, 1024, 16) (the
   API's cap), (4, 256, 100) and (4, 1024, 100) on config 3's mixture,
   (4, 256, 240), (4, 256, 300) and (4, 1024, 240) on the correlated
   Gaussian, (4, 256, 300) on the mixture}, and with infinite stretch
   factors, whose proposals both versions must reject. Accept bits
   equal, except a bit the plain version puts within 1e-4 of its
   threshold (then, as the walkers interact, every later generation is
   left out); x and logp within ``B9_TOL``. Each case prints its launch's
   plan (the population's place, the constants' place, L, threads,
   bytes): the main shape must keep both in shared memory, (4, 1024,
   100) must take the global route, and the Gaussian at d = 240 and 300
   must read its constants from device memory. At the main shape and at
   (4, 256, 100) on the Gaussian every route and place forced (shared or
   global population; constants in shared or device memory) must give
   the chosen launch's outputs bit for bit; at the main shape the routes
   are timed in turns (shared, global, global, shared), the constants'
   places in turns (chosen, device, device, chosen), and the default
   launch; then the Gaussian at n = 256, G = 64, d = 240 and 300 in turns
   (240, 300, 300, 240) beside its bound, by CUDA events around each
   launch. B9's other times are device ms a launch over the launches the
   profiler recorded.
3. The main path: BASELINE config 3 at full width through ``DreamZs``
   (256 chains, the 100-d four-mode mixture, archive 8192, burn-in 500),
   2,500 warm-up generations then a timed window of 5,000. Both kernels
   must have launched once per generation, and every mode must still hold
   a chain. Then 200 more generations, timed alone and then under
   ``torch.profiler``, give the device's busy share and time by kernel.
3b. The same run with ``DreamZs(fused=True)``, as ``bench.py`` times
   config 3: burn-in on the per-generation engine, then fused chunks of
   10 generations. B1 must have launched (fused generations) / 10 times,
   B2 once per burn-in generation and no more, B3 once per burn-in
   generation and once per chunk; every mode must still hold a chain and
   every final logp be finite. Then 20 chunks timed alone and under the
   profiler (busy share, launches per chunk), and the R̂ stop of phase 4
   with ``fused=True`` (warm call, ``reset()``, timed call), with the
   same launch counts per path.
3c. Phase 3b again with ``DreamZs(fused=True, fused_rng="kernel")``, as
   ``bench.py`` runs the JAX package: B1 must have launched in
   kernel-RNG mode once a chunk and never in stream mode, with the same
   checks, profile and R̂ stop. Then 3b's and 3c's gens/s, ESS/s,
   acceptance and occupancy on one line, and a chunk's wall and busy
   time of both samplers in turns (stream, kernel, kernel, stream). B11
   must have launched no time in phases 3, 3b and 3c: the defaults do
   not route through it.
3d. Phase 3c again with ``fused_gather="kernel"`` and
   ``gather_kernel=True``, the archive rows through B11 in burn-in and in
   every chunk: B11 and B3 must each have launched 500 + 700 = 1,200
   times, the ``accepted`` and ``x`` histories must be bit-equal to phase
   3c's, and the R̂ stop must take phase 3c's generations with its R̂.
   Then 20 chunks timed alone and under the profiler, B11's µs a chunk
   beside phase 3c's torch gather.
3e. Phase 3's run again with ``DreamZs(pallas_accept=True)``: B10, B2
   and B3 must each have launched 7,500 times and B11 none; the
   ``accepted`` and ``x`` histories must be bit-equal to phase 3's over
   all 7,500 generations, and every mode must still hold a chain. B10
   must have launched no time in phases 3-3d (the defaults). Then both
   samplers in turns (default, B10, B10, default, twice), 200
   generations each, and 200 generations each under the profiler: wall,
   busy share and kernels a generation.
3f. Phase 3c's sampler (``fused=True, fused_rng="kernel"``) again with
   ``pallas_accept=True``: B10 must have launched 500 times (the
   burn-in) and in no chunk, and the ``accepted`` and ``x`` histories
   must be bit-equal to phase 3c's over its 7,500 generations.
3g. The JAX package's own A/B workload for B10
   (``benchmarks/profile_accept_fusion.py:38-52``): n in {1024, 4096}
   chains × d = 100 on config 3's mixture, archive 8,192, burn-in 500,
   driven through ``dream.make_step`` with ``StepWords`` and only
   ``accepted`` kept. Both variants run the burn-in, then turns of 200
   generations (default, B10, B10, default, twice) and 200 generations
   under the profiler; their accept bits must be equal at every
   generation. µs and kernels a generation of each. The workload's
   third size, 256 chains, is phase 3e's turns.
4. The R̂ stop: 256 chains in one basin, ``run_mcmc_until`` to R̂ < 1.1,
   one warm call, ``reset()``, one timed call. Both kernels must have
   launched once per generation of the two calls.
5. The config-1 main path as ``benchmarks/run_all.py`` runs it:
   ``Dram(correlated_gaussian([1, -1], [[2, .8], [.8, 1]]), seed=1,
   n_chains=1, fused=True)``, 20,000 steps, a warm continuation of
   20,000, a timed continuation of 20,000. B4 must have launched
   3 × 20,000 / 50 = 1,200 times, and the posterior must match the truth
   (mean within 0.15, every covariance entry within 0.3); the route B4
   took is printed (the latency route). Then 10 chunks timed alone and 10
   under the profiler, B4's µs a chunk and a step from that profile, and
   the Welford replay's share of a chunk.
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
   steps timed alone and under the profiler, with B5's µs a step and B6's
   device ms a launch inside the step (``in_step_ms`` in its record).
   (Config 4's target is ``gp._lml_impl``, as in
   ``benchmarks/run_all.py``; the public log-ML is grad-safe and skips
   B6.)
8. BASELINE config 5 at full width as ``benchmarks/run_all.py:437-482``
   runs it, with ``pallas_chol=True, pallas_solve=True``: ``optimize``
   (300 Adam steps on 256 design points), ``fit``, the "mean"
   surrogate plus the (θ/2)⁴ prior, and ``DreamZs(n_chains=1024,
   seed=0).run_mcmc_until`` to R̂ < 1.1 (warm call, ``reset()``, timed
   call). B7 must have launched 302 times (a step, the final log-ML,
   the fit), B8 603 (two a step, one, two), B5 302 plus one a
   generation and one at each start, B2 and B3 once a generation, B6
   never. Every final logp finite; the optimised log-ML within rtol
   1e-4 of a float64 NumPy one at the same params; the params within
   1e-2 of the port's own CPU ``optimize``; the posterior mean within
   0.1 of θ = (1.2, −0.7). Then ``optimize``'s wall with the library
   route between two with the kernels, the device's busy share of an
   Adam step (with B5's, B7's and B8's device µs a step) and of a DREAM
   generation, and 200 generations of the "lcb" surrogate, B8 once a
   generation.
9. The stretch workload of ``benchmarks/profile_stretch_fused.py:30-47``
   through ``EnsembleSampler(fused=True)``: 256 walkers in d = 16 on
   N(0, diag(scales²)), scales = linspace(0.5, 3, 16), from x0 = N(0,
   1)·scales (NumPy, the seed), a run of 20,000 generations and a timed
   continuation of 20,000. B9 must have launched 313 times a run (312
   chunks of 64 and one of 32), every final logp be finite, each mean
   within 5 SE of 0 (SE from ``ess_rate``'s ESS over its window), each
   variance within 10 % of scale², the acceptance in (0.1, 0.9). Then
   ``fused=False`` for 2,000 generations from the same start and seed:
   the fused run's decisions (the rule of phase 2f), and bit-equal
   positions until a decision differs. Both engines' gens/s and ESS/s;
   100 generations and 20 chunks timed alone and under the profiler (B9's
   µs a chunk); the
   R̂ stop to 1.1 on
   both engines (warm call, ``reset()``, timed call), which must stop at
   the same generation, B9 launching twice a 100-generation chunk on the
   fused engine and never on the other.
10. One JSON line of the kernels (all eleven ported, twelve records: B1
   has one a mode), the card's line, and the result line.

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
N_CHAINS, D, CAPACITY, BURNIN = 256, 100, 8192, 500
WARM_GENS, TIMED_GENS = 2500, 5000
# B1 against its plain version, max |dx| and max |dlogp| over the compared
# entries: about 10 x the largest readings of the first runs on the H100
# (9.5e-7 and 6.1e-5, at config 3 and at d = 129; |logp| ~ 150)
B1_TOL = {"x": 1e-5, "logp": 5e-4}
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


def host_times(fn, top=8):
    """The host's own time by operator over one call of ``fn`` (the
    profiler's self CPU time, µs), the ``top`` largest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    return rows[:top]


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

    # config 3's shape, then config 5's: 1,024 chains, archive 32,768
    cases = [(N_CHAINS, 6, CAPACITY, False), (C5_CHAINS, 6, C5_CAPACITY,
                                                False)]
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


def b2_work(n, d, n_snk, k=6, n_pairs=3):
    """(bytes, operations) of one B2 call: x, the k rows, the three draws
    and scal read once, x_star and log_jac written once; per element 7
    flops of sums, then 6 (snooker) or 3·n_pairs + 10 (parallel)."""
    n_bytes = 4 * (n * d * (1 + k + 3 + 1) + n * 5 + n)
    n_ops = n * d * 7 + n_snk * d * 6 + (n - n_snk) * d * (3 * n_pairs + 10)
    return n_bytes, n_ops


def b2_host_parts(ops, d, kw, reps=1000):
    """Host µs a call of B2's wrapper and of its parts, by the host's clock
    over ``reps`` calls each: the whole wrapper; its device checks
    (``_check_cuda``); the two output allocations; the current stream;
    the pointers and strides read from the tensors; the ctypes call of
    the entry point, which launches the kernel; the rest (the shape
    checks and the Python around them) the whole less the parts."""
    from bipymc_tpu_torch.ops import _build
    from bipymc_tpu_torch.ops import dream_proposal as b2

    x, rows, um, ue, ep, scal = ops
    n = x.shape[0]
    fn = _build.library("dream_proposal")
    x_star = torch.empty((n, d), device=x.device)
    log_jac = torch.empty((n,), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = lambda: (x.data_ptr(), x.stride(0), rows.data_ptr(), rows.shape[1],
                    um.data_ptr(), um.stride(0), ue.data_ptr(), ue.stride(0),
                    ep.data_ptr(), ep.stride(0), scal.data_ptr(), n, d,
                    kw["n_pairs"], (d - 1) * 0.5, kw["b"], kw["b_star"],
                    x_star.data_ptr(), log_jac.data_ptr())
    fixed = args()
    parts = {
        "wrapper": lambda: b2.dream_propose(*ops, d_true=d, **kw),
        "checks": lambda: b2._check_cuda(*ops),
        "outputs": lambda: (torch.empty((n, d), device=x.device),
                            torch.empty((n,), device=x.device)),
        "stream": lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "pointers": args,
        "launch": lambda: fn(*fixed, stream),
    }
    us = {}
    for key, f in parts.items():
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        us[key] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    us["rest"] = us["wrapper"] - sum(v for k, v in us.items()
                                     if k != "wrapper")
    return us


# B2's log Jacobian at d = d_true = 500 against its plain version (C3):
# each float32 route stands within (d_true - 1)/2 · 16 ε of a float64 run
# of the plain version (tests/test_torch_dream_proposal.py::
# test_log_jac_at_large_d_is_float32_rounding; b2_float64_readings holds
# the kernel there on the card), so two routes differ by up to (d_true -
# 1) · 16 ε, 9.5e-4. The cases at d <= 300 keep atol 1e-4.
B2_JAC_ATOL_D500 = 499 * 16 * float(np.finfo(np.float32).eps)


def b2_float64_readings(dev, n=256, dims=(300, 500), seeds=4):
    """B2 and its plain version at d = d_true (every chain a snooker move,
    whose log Jacobian is (d_true − 1)/2 times a difference of logs of two
    float32 sums), each against the plain version run in float64 on the
    same operands: the worst |Δ log_jac| and |Δ x_star| from float64 of
    each float32 route, and between them, over ``seeds`` operand sets."""
    from bipymc_tpu_torch.ops.dream_proposal import (dream_propose,
                                                     propose_plain)

    out = {}
    for d in dims:
        r = {"kernel_vs_f64": [0.0, 0.0], "plain_vs_f64": [0.0, 0.0],
             "kernel_vs_plain": [0.0, 0.0], "max_abs_log_jac": 0.0}
        for seed in range(seeds):
            ops = b2_operands(n, d, "all", False, False, seed=700 + seed,
                              dev=dev)
            kw = dict(n_pairs=3, b=1e-4, b_star=1e-6, d_true=d)
            k = dream_propose(*ops, **kw)
            p = propose_plain(*ops, **kw)
            f = propose_plain(*[o.double() for o in ops], **kw)
            for key, u, v in (("kernel_vs_f64", k, f),
                              ("plain_vs_f64", p, f),
                              ("kernel_vs_plain", k, p)):
                r[key] = [max(r[key][0], float((u[1].double() - v[1].double())
                                               .abs().max())),
                          max(r[key][1], float((u[0].double() - v[0].double())
                                               .abs().max()))]
            r["max_abs_log_jac"] = max(r["max_abs_log_jac"],
                                       float(f[1].abs().max()))
        out[f"d{d}"] = r
    log("B2 at d = d_true against float64 (|d log_jac|, |d x_star|):",
        json.dumps(out))
    # the kernel's sums no further from float64 than the plain version's,
    # and each float32 route within (d_true - 1)/2 · 16 ε of it
    for d in dims:
        r, bound = out[f"d{d}"], (d - 1) / 2 * 16 * np.finfo(np.float32).eps
        if not (r["kernel_vs_f64"][0] <= 1.5 * r["plain_vs_f64"][0] + 1e-5
                and max(r["kernel_vs_f64"][0], r["plain_vs_f64"][0])
                <= bound):
            raise AssertionError(f"B2's log Jacobian at d = d_true = {d} is "
                                 f"further from float64 than float32 "
                                 f"rounding allows: {r}, bound {bound:.3g}")
    return out


def check_b2(dev):
    from bipymc_tpu_torch.ops.dream_proposal import (dream_propose,
                                                     propose_plain)

    kw = dict(n_pairs=3, b=1e-4, b_star=1e-6)
    main_err = None
    # config 3's shape, then config 5's (1,024 chains, d = 2)
    cases = [(N_CHAINS, D, snooker, jump, False)
             for snooker, jump in (("mixed", False), ("mixed", True))]
    cases += [(C5_CHAINS, 2, snooker, jump, False)
              for snooker in ("mixed", "all", "none")
              for jump in (False, True)]
    for d in (1, 3, 8, 31, 32, 33, 64, 65, 100, 129, 300, 500):
        for n in (5, 32):
            for snooker in ("all", "none", "mixed"):
                for jump in (False, True):
                    for ties in (False, True):
                        cases.append((n, d, snooker, jump, ties))
    # 1 and 2 DE pairs (3, the samplers' default, is the kernel's
    # compile-time count; other counts take its run-time loop)
    pairs = {len(cases) + k: n_pairs for k, n_pairs in enumerate((1, 2) * 3)}
    cases += [(n, d, "mixed", False, False) for n, d in
              ((C5_CHAINS, 2), (N_CHAINS, D), (5, 500)) for _ in (1, 2)]
    worst = {}
    for i, (n, d, snooker, jump, ties) in enumerate(cases):
        ops = b2_operands(n, d, snooker, jump, ties, seed=i, dev=dev)
        # d = 500 takes the kernel's path that reads each quad twice (past
        # 384), at d_true = 500 and its own log-Jacobian atol
        kw_i = dict(kw, n_pairs=pairs.get(i, 3), d_true=d)
        atol_j = B2_JAC_ATOL_D500 if d == 500 else 1e-4
        x_star, log_jac = dream_propose(*ops, **kw_i)
        ref_x, ref_j = propose_plain(*ops, **kw_i)
        torch.cuda.synchronize()
        ex = (x_star - ref_x).abs()
        ej = (log_jac - ref_j).abs()
        if not (bool(torch.all(ex <= 1e-6 + 1e-5 * ref_x.abs()))
                and bool(torch.all(ej <= atol_j + 1e-5 * ref_j.abs()))
                and bool(torch.all(torch.isfinite(x_star)))):
            raise AssertionError(
                f"B2 differs from its plain version at n={n} d={d} "
                f"snooker={snooker} jump={jump} ties={ties} n_pairs="
                f"{kw_i['n_pairs']}: max |dx| "
                f"{float(ex.max()):.3g}, max |d log_jac| "
                f"{float(ej.max()):.3g}")
        err = max(float(ex.max()), float(ej.max()))
        worst[f"d{d}"] = max(worst.get(f"d{d}", 0.0), err)
        if i < 2:
            main_err = err if main_err is None else max(main_err, err)
    log(f"B2 dream_propose: within tolerance of the plain version in "
        f"{len(cases)} cases; main-shape max abs error {main_err:.3g}; "
        f"max abs error by d (a warp or less a chain; up to d = 384 each "
        f"input read once, past it twice):",
        json.dumps(worst))
    b2_float64_readings(dev)

    def timed(n, d, seed):
        ops = b2_operands(n, d, "mixed", False, False, seed=seed, dev=dev)
        kernel = lambda: dream_propose(*ops, d_true=d, **kw)
        plain = lambda: propose_plain(*ops, d_true=d, **kw)
        t = timed_launches(kernel, 200, 20, key="dream_propose")
        return ops, kernel, plain, t

    ops, kernel, plain, t3 = timed(N_CHAINS, D, 99)
    times = (t3[0], device_ms(plain), call_ms(kernel), call_ms(plain))
    n_bytes, n_ops = b2_work(N_CHAINS, D, int(ops[5][:, 3].sum()))
    host = b2_host_parts(ops, D, kw)
    log("B2 at config 3, host µs a call of the wrapper and its parts:",
        json.dumps(host))
    ops5, kernel5, plain5, t5 = timed(C5_CHAINS, 2, 100)
    b5, o5 = b2_work(C5_CHAINS, 2, int(ops5[5][:, 3].sum()))
    config5 = {"ms": t5[0], "recorded": t5[1], "ms_over_reps": t5[2],
               "events_ms": t5[3], "call_ms": call_ms(kernel5),
               "plain_ms": device_ms(plain5), "bound_ms": bound_ms(b5, o5),
               "bound_by": ("bytes" if b5 / HBM_BYTES_PER_S
                            >= o5 / FP32_OPS_PER_S else "operations")}
    log("B2 at config 5's [1024, 2]:", json.dumps(config5))
    rec = kernel_record(
        "dream_propose", "bipymc_tpu_torch/csrc/dream_proposal.cu",
        "bipymc_tpu/ops/dream_proposal.py:123", main_err, times, n_bytes,
        n_ops)
    rec.update(recorded=t3[1], ms_over_reps=t3[2], events_ms=t3[3],
               host_us=host, config5=config5)
    return rec


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
    floor = {"device_ms": device_ms(op), "call_ms": call_ms(op)}
    log("launch floor:", json.dumps(floor))
    return floor


# ---------------------------------------------------------------- phase 2e
def config3_setup(dev):
    """Config 3's target, means and start points (phases 2e, 3 and 3b)."""
    import bipymc_tpu_torch as bt

    means = bt.baseline_config3_means(D)
    g = torch.Generator(device=dev).manual_seed(SEED)
    theta0 = bt.stratified_mode_init(g, means, N_CHAINS, var=4.0, device=dev)
    return bt.gaussian_mixture(means, sigma=1.0), means, theta0


def b1_ragged_operands(G, n, d, seed, dev):
    """x0, rows, u_mask, u_e, eps, scal in the fused runner's layout (u_mask
    and u_e slices of one uniform block), δ ~ U{1..3}, CR ∈ {1/3, 2/3,
    1}, snooker with probability 0.3, γ = 1 at generation G // 2."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(generator=g, device=dev, dtype=torch.float32)
    x0 = 2.0 * torch.randn((n, d), **f32)
    rows = x0[None, :, None, :] + 2.0 * torch.randn((G, n, 6, d), **f32)
    block = torch.rand((G, n, 2 * d + 4), **f32)
    jump = torch.zeros((G, n), device=dev)
    jump[G // 2] = 1.0
    scal = torch.stack([
        torch.clamp_max(1.0 + torch.floor(torch.rand((G, n), **f32) * 3),
                        3.0),
        torch.randint(1, 4, (G, n), generator=g, device=dev).float() / 3.0,
        1.2 + torch.rand((G, n), **f32),
        (torch.rand((G, n), **f32) < 0.3).float(), jump,
        torch.rand((G, n), **f32).clamp_min(1e-7).log()], -1)
    return (x0, rows, block[..., 4:4 + d], block[..., 4 + d:],
            torch.randn((G, n, d), **f32), scal)


def b1_compare(lp, x0, ops, d, label):
    """B1 against its plain version on one operand set; returns the
    excused bits, max |dx| and max |dlogp| over the comparable entries,
    and the kernel's outputs."""
    from bipymc_tpu_torch.ops.fused_chunk import (fused_chunk,
                                                  fused_chunk_plain)
    from bipymc_tpu_torch.testing import match_decisions, plain_log_alpha

    kw = dict(n_pairs=3, d_true=d, b=1e-4, b_star=1e-6)
    lp0 = lp(x0)
    out = fused_chunk(x0, lp0, *ops, lp, **kw)
    ref = fused_chunk_plain(x0, lp0, *ops, lp, **kw)
    ref_la = plain_log_alpha(x0, lp0, *ops, lp, **kw)
    torch.cuda.synchronize()
    kept, excused = match_decisions(out[2], ref[2],
                                    (ops[4][..., 5] - ref_la).abs())
    errs = []
    for key, a, b in (("x", out[0][kept], ref[0][kept]),
                      ("logp", out[1][kept], ref[1][kept])):
        if not (bool(torch.all((a - b).abs() <= B1_TOL[key]))
                and bool(torch.all(torch.isfinite(a)))):
            raise AssertionError(
                f"B1 differs from its plain version ({label}): max "
                f"|d{key}| {float((a - b).abs().max()):.3g}")
        errs.append(float((a - b).abs().max()))
    return excused, errs[0], errs[1], out


# operations a lane of kernel-RNG B1 spends on its three draws: Philox's
# ten rounds (two multiply-highs, two multiplies, four XORs; nine key
# bumps of two adds), the three uniforms (3 each), 2u - 1 and its clamp,
# and the inverse normal CDF in float64, ~40 operations counted twice
# (the H100's float64 rate is half its float32 rate)
KRNG_OPS_PER_LANE = 10 * 8 + 9 * 2 + 3 * 3 + 3 + 2 * 40


def b1_work(x0, rows, scal, n_modes, kernel_rng=False):
    """Bytes B1 must move and the operations this run's moves take (a
    mixture of ``n_modes`` modes; the correlated Gaussian where n_modes
    is 0). Each input the function needs is read once and each output
    written once: a parallel move needs 2δ archive rows and, in stream
    mode, its three [d] draws, a snooker move rows 0-2 and no draw.
    Kernel-RNG mode reads no draws and makes every lane's three."""
    G, n, k, d = rows.shape
    snk = scal[..., 3] > 0.5
    n_snk = int(snk.sum())
    par_rows = int((2 * scal[..., 0] * (~snk)).sum())
    n_const = n_modes * d + n_modes if n_modes else d * d + d
    n_in = (x0.numel() + n + scal.numel() + n_const
            + (3 * n_snk + par_rows) * d)
    if not kernel_rng:
        n_in += 3 * (G * n - n_snk) * d
    n_bytes = 4 * (n_in + G * n * d + G * n) + G * n
    par_per_dim = int(((3 * scal[..., 0] + 10) * (~snk)).sum())
    # proposal pass 1: 7 a dim; pass 2: 6 (snooker) or 3·δ + 10
    # (parallel); the target 3 a mode and dim (the mixture) or 2 d² + 3 d
    # (the Gaussian's quadratic form); the accept ~10
    target = (3 * n_modes * d + 6 * n_modes if n_modes
              else 2 * d * d + 3 * d)
    n_ops = (G * n * d * 7 + n_snk * d * 6 + par_per_dim * d
             + G * n * (target + 10))
    if kernel_rng:
        n_ops += G * n * d * KRNG_OPS_PER_LANE
    return n_bytes, n_ops


def b1_shape(lp, G, n, d):
    """``ops/fused_chunk.plan``'s target arguments of B1 on ``lp``: (n,
    d, G, n_pairs, kind, n_modes)."""
    form = lp.kernel_form
    if form.name == "gaussian_mixture":
        return n, d, G, 3, 1, form.arrays["means"].shape[0]
    return n, d, G, 3, 0, 0


def b1_hold_routes(call, out, shape, label):
    """``call(route)`` on each route of B1 that takes ``shape``: every
    launch's plan as ``ops/fused_chunk.plan`` gives it, and outputs equal
    bit for bit to ``out``, those of the route B1 chose. Returns the
    routes run."""
    from bipymc_tpu_torch.ops import fused_chunk as b1

    taken = []
    for route in b1.ROUTES:
        want = b1.plan(*shape, route=route)
        if want is None:
            continue
        o = call(route)
        torch.cuda.synchronize()
        if b1.fused_chunk.last_plan != want:
            raise AssertionError(f"B1's {route} route ({label}) launched "
                                 f"{b1.fused_chunk.last_plan}, plan {want}")
        if not all(bool(torch.equal(a, b)) for a, b in zip(o, out)):
            raise AssertionError(f"B1's {route} route ({label}) differs "
                                 "from the chosen route's outputs")
        taken.append(route)
    return taken


def b1_check_plan(shape, label):
    """The last launch of B1 took ``ops/fused_chunk.plan``'s launch."""
    from bipymc_tpu_torch.ops import fused_chunk as b1

    if b1.fused_chunk.last_plan != b1.plan(*shape):
        raise AssertionError(f"B1 ({label}) launched "
                             f"{b1.fused_chunk.last_plan}, plan "
                             f"{b1.plan(*shape)}")
    return b1.fused_chunk.last_plan


# the correlated Gaussian past B1's shared route, at config 3's n and G
B1_WIDE_D = (240, 300)


def timed_launches(fn, reps, warmup, key="fused_chunk"):
    """The kernel whose name holds ``key`` (B1 by default) over ``reps``
    launches after ``warmup``: its device ms a launch over the launches
    the profiler recorded, that count, its device ms over ``reps`` (as
    ``device_ms`` reads it), and ms a launch by CUDA events around the
    same launches, back to back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and key in e.key]
    us = sum(e.self_device_time_total for e in rows)
    n = sum(e.count for e in rows)
    if n == 0:
        raise AssertionError(f"the profiler recorded no launch of {key}")
    return us / n / 1e3, n, us / reps / 1e3, e0.elapsed_time(e1) / reps


def b1_wide_times(calls):
    """B1 at the wide shapes: ``calls`` maps d to (the launch, bytes,
    operations). In turns (d = 240, 300, 300, 240, twice) at config 3's
    200 reps after 20 of warm-up: device ms a launch over the launches
    the profiler recorded, their median and spread ((max − min) / min),
    the counts, and CUDA events around the same launches; then each once
    after the card idled a second, at 20 reps after 3 of warm-up, the
    timing these cases first had (``ms_over_reps``: the profiler's device
    time over the 20, as ``device_ms`` reads it)."""
    order = list(calls) + list(calls)[::-1]
    turns = {d: [] for d in calls}
    for d in order * 2:
        turns[d].append(timed_launches(calls[d][0], 200, 20))
    wide = {}
    for d, (fn, n_bytes, n_ops) in calls.items():
        time.sleep(1.0)
        ms = sorted(t[0] for t in turns[d])
        idle = timed_launches(fn, 20, 3)
        wide[f"d{d}"] = {
            "ms": (ms[1] + ms[2]) / 2,
            "turns_ms": [t[0] for t in turns[d]],
            "turns_recorded": [t[1] for t in turns[d]],
            "turns_events_ms": [t[3] for t in turns[d]],
            "spread": (ms[-1] - ms[0]) / ms[0],
            "after_idle_20_reps": {"ms": idle[0], "recorded": idle[1],
                                   "ms_over_reps": idle[2],
                                   "events_ms": idle[3]},
            "bound_ms": bound_ms(n_bytes, n_ops),
            "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                         >= n_ops / FP32_OPS_PER_S else "operations"),
            "route": "global"}
    return wide


def config3_burned_in(dev):
    """Config 3's target, means and per-generation sampler after its
    burn-in: the state and archive the fused runner starts from."""
    import bipymc_tpu_torch as bt

    lp, means, theta0 = config3_setup(dev)
    s = bt.DreamZs(lp, n_chains=N_CHAINS, seed=SEED, burnin_gens=BURNIN,
                   archive_capacity=CAPACITY, device=dev)
    s.run_mcmc(BURNIN, theta0)
    return lp, means, s


def check_b1(dev):
    from bipymc_tpu_torch.ops.fused_chunk import (fused_chunk,
                                                  fused_chunk_plain)
    from bipymc_tpu_torch.samplers.dream_fused import chunk_operands

    # config 3's own operands: its state and archive after burn-in
    lp, means, s = config3_burned_in(dev)
    st = s.final_state
    ops = chunk_operands(st, s._words, BURNIN, s.cfg)
    if tuple(ops[0].shape) != (10, N_CHAINS, 6, D):
        raise AssertionError(f"config-3 rows {tuple(ops[0].shape)}")
    shape = b1_shape(lp, 10, N_CHAINS, D)
    excused, ex, el, out = b1_compare(lp, st.x, ops, D, "config 3")
    plan = b1_check_plan(shape, "config 3")
    kw = dict(n_pairs=3, d_true=D, b=1e-4, b_star=1e-6)
    lp0 = lp(st.x)
    routes = b1_hold_routes(
        lambda r: fused_chunk(st.x, lp0, *ops, lp, route=r, **kw), out,
        shape, "config 3")
    readings = {"config3": {"excused_bits": excused, "max_abs_dx": ex,
                            "max_abs_dlogp": el, "plan": plan,
                            "routes_bit_equal": routes,
                            "acceptance": float(out[2].float().mean())}}
    cases = [(1, 7, 3, "mixture"), (1, 7, 3, "gaussian"),
             (10, 37, 129, "gaussian"), (5, 8, 4, "nonfinite")]
    cases += [(10, N_CHAINS, d, "gaussian") for d in B1_WIDE_D]
    calls = {}
    for i, (G, n, d, kind) in enumerate(cases):
        label = f"G={G} n={n} d={d} {kind}"
        tgt = b4_target("gaussian" if kind == "gaussian" else "mixture", d)
        x0, *rest = b1_ragged_operands(G, n, d, seed=i, dev=dev)
        if kind == "nonfinite":
            rest[0][2, 3] = torch.inf
        e_bits, e_x, e_l, o = b1_compare(tgt, x0, rest, d, label)
        if kind == "nonfinite" and bool(o[2][2, 3]):
            raise AssertionError("B1 accepted a non-finite proposal")
        kw_d = dict(kw, d_true=d)
        t_lp0 = tgt(x0)
        readings[label] = {
            "excused_bits": e_bits, "max_abs_dx": e_x, "max_abs_dlogp": e_l,
            "plan": b1_check_plan(b1_shape(tgt, G, n, d), label),
            "routes_bit_equal": b1_hold_routes(
                lambda r: fused_chunk(x0, t_lp0, *rest, tgt, route=r,
                                      **kw_d), o, b1_shape(tgt, G, n, d),
                label)}
        if d in B1_WIDE_D:
            if readings[label]["plan"][0] != "global":
                raise AssertionError(f"B1 ({label}) took the shared route")
            calls[d] = (lambda x0=x0, t_lp0=t_lp0, rest=rest, tgt=tgt,
                        kw_d=kw_d: fused_chunk(x0, t_lp0, *rest, tgt,
                                               **kw_d),
                        *b1_work(x0, rest[0], rest[4], 0))
    wide = b1_wide_times(calls)
    log("B1 fused_chunk: against the plain version, limits "
        f"{json.dumps(B1_TOL)}:", json.dumps(readings))
    log("B1 fused_chunk, the Gaussian past the shared route (n = 256, "
        "G = 10), device ms and bound:", json.dumps(wide))

    kernel = lambda: fused_chunk(st.x, lp0, *ops, lp, **kw)
    plain = lambda: fused_chunk_plain(st.x, lp0, *ops, lp, **kw)
    forced = lambda r: (lambda: fused_chunk(st.x, lp0, *ops, lp, route=r,
                                            **kw))
    # the two routes in turns at config 3: shared, global, global, shared
    # (device ms a launch over the launches the profiler recorded)
    timed = [timed_launches(forced(r), 200, 20) for r in ("shared", "global",
                                                    "global", "shared")]
    turns = [t[0] for t in timed]
    log("B1 device ms at config 3 in turns (shared, global, global, "
        "shared), the launches recorded of 200:",
        json.dumps([turns, [t[1] for t in timed]]))
    times = (timed_launches(kernel, 200, 20)[0],
             device_ms(plain, reps=20, warmup=3), call_ms(kernel),
             call_ms(plain, reps=30, warmup=3))
    n_bytes, n_ops = b1_work(st.x, ops[0], ops[4], len(means))
    rec = kernel_record(
        "fused_chunk", "bipymc_tpu_torch/csrc/fused_chunk.cu",
        "bipymc_tpu/ops/fused_chunk.py:242", max(ex, el), times, n_bytes,
        n_ops)
    rec["plan"] = plan
    rec["routes_turns_ms"] = {"shared": [turns[0], turns[3]],
                              "global": [turns[1], turns[2]]}
    rec["gaussian_wide"] = wide
    return rec


# ------------------------------------------------ phase 2e, kernel-RNG mode
# the ragged cases' run key: its top bit set, so a key ≥ 2⁶³ crosses
# the wrapper's uint64 argument (config 3's own key, seed 0, is < 2⁶³)
RUN_KEY_HI = 0xF123456789ABCDEF


def b1_kernel_rng_compare(lp, x0, rows, scal, d, label, run_key, t0,
                          test_bits=None):
    """Kernel-RNG B1 against its plain version (the same Philox words,
    or ``test_bits``) on one operand set; returns the excused bits, max
    |dx| and max |dlogp| over the comparable entries, the kernel's
    outputs and the plain version's log α."""
    from bipymc_tpu_torch.ops.fused_chunk import (fused_chunk,
                                                  fused_chunk_plain,
                                                  kernel_rng_draws)
    from bipymc_tpu_torch.testing import match_decisions, plain_log_alpha

    G, n = scal.shape[:2]
    kw = dict(n_pairs=3, d_true=d, b=1e-4, b_star=1e-6)
    lp0 = lp(x0)
    out = fused_chunk(x0, lp0, rows, None, None, None, scal, lp,
                      rng="kernel", run_key=run_key, t0=t0,
                      test_bits=test_bits, **kw)
    draws = kernel_rng_draws(run_key, t0, G, n, d, x0.device, test_bits)
    ref = fused_chunk_plain(x0, lp0, rows, *draws, scal, lp, **kw)
    ref_la = plain_log_alpha(x0, lp0, rows, *draws, scal, lp, **kw)
    torch.cuda.synchronize()
    kept, excused = match_decisions(out[2], ref[2],
                                    (scal[..., 5] - ref_la).abs())
    errs = []
    for key, a, b in (("x", out[0][kept], ref[0][kept]),
                      ("logp", out[1][kept], ref[1][kept])):
        if not (bool(torch.all((a - b).abs() <= B1_TOL[key]))
                and bool(torch.all(torch.isfinite(a)))):
            raise AssertionError(
                f"kernel-RNG B1 differs from its plain version ({label}): "
                f"max |d{key}| {float((a - b).abs().max()):.3g}")
        errs.append(float((a - b).abs().max()))
    return excused, errs[0], errs[1], out, ref_la


def check_b1_kernel_rng(dev):
    """B1 in kernel-RNG mode against its plain version, and, fed stream
    mode's words, against B1 in stream mode. Config 3's chunk draws the
    words of the main path's first chunk: its run key, t0 = burn-in."""
    from bipymc_tpu_torch.ops.fused_chunk import (
        fused_chunk, fused_chunk_kernel_rng_plain)
    from bipymc_tpu_torch.samplers.dream_fused import (
        chunk_operands, chunk_operands_kernel_rng)
    from bipymc_tpu_torch.testing import match_decisions

    lp, means, s = config3_burned_in(dev)
    st = s.final_state
    key = s._words.key
    rows, scal, _ = chunk_operands_kernel_rng(st, s._words, BURNIN, s.cfg)
    if tuple(rows.shape) != (10, N_CHAINS, 6, D):
        raise AssertionError(f"config-3 rows {tuple(rows.shape)}")
    shape = b1_shape(lp, 10, N_CHAINS, D)
    excused, ex, el, out, _ = b1_kernel_rng_compare(lp, st.x, rows, scal, D,
                                                    "config 3", key, BURNIN)
    plan = b1_check_plan(shape, "config 3, kernel RNG")
    kw = dict(n_pairs=3, d_true=D, b=1e-4, b_star=1e-6)
    lp0 = lp(st.x)
    routes = b1_hold_routes(
        lambda rt: fused_chunk(st.x, lp0, rows, None, None, None, scal, lp,
                               rng="kernel", run_key=key, t0=BURNIN,
                               route=rt, **kw), out, shape,
        "config 3, kernel RNG")
    readings = {"config3": {"excused_bits": excused, "max_abs_dx": ex,
                            "max_abs_dlogp": el, "plan": plan,
                            "routes_bit_equal": routes,
                            "acceptance": float(out[2].float().mean())}}
    cases = [(1, 7, 3, "mixture"), (1, 7, 3, "gaussian"),
             (10, 37, 129, "gaussian"), (5, 8, 4, "nonfinite")]
    cases += [(10, N_CHAINS, d, "gaussian") for d in B1_WIDE_D]
    calls = {}
    for i, (G, n, d, kind) in enumerate(cases):
        label = f"G={G} n={n} d={d} {kind}"
        tgt = b4_target("gaussian" if kind == "gaussian" else "mixture", d)
        x0, r, _, _, _, sc = b1_ragged_operands(G, n, d, seed=i, dev=dev)
        if kind == "nonfinite":
            r[2, 3] = torch.inf
        e_bits, e_x, e_l, o, _ = b1_kernel_rng_compare(
            tgt, x0, r, sc, d, label, RUN_KEY_HI, 10 * i)
        if kind == "nonfinite" and bool(o[2][2, 3]):
            raise AssertionError("kernel-RNG B1 accepted a non-finite "
                                 "proposal")
        kw_d = dict(kw, d_true=d, rng="kernel", run_key=RUN_KEY_HI,
                    t0=10 * i)
        t_lp0 = tgt(x0)
        readings[label] = {
            "excused_bits": e_bits, "max_abs_dx": e_x, "max_abs_dlogp": e_l,
            "plan": b1_check_plan(b1_shape(tgt, G, n, d), label),
            "routes_bit_equal": b1_hold_routes(
                lambda rt: fused_chunk(x0, t_lp0, r, None, None, None, sc,
                                       tgt, route=rt, **kw_d), o,
                b1_shape(tgt, G, n, d), label)}
        if d in B1_WIDE_D:
            if readings[label]["plan"][0] != "global":
                raise AssertionError(f"B1 ({label}) took the shared route")
            calls[d] = (lambda x0=x0, t_lp0=t_lp0, r=r, sc=sc, tgt=tgt,
                        kw_d=kw_d: fused_chunk(x0, t_lp0, r, None, None,
                                               None, sc, tgt, **kw_d),
                        *b1_work(x0, r, sc, 0, kernel_rng=True))
    wide = b1_wide_times(calls)

    # stream mode's own words as test_bits: the decisions of stream-mode
    # B1 on the same chunk (a bit excused only at a plain near tie)
    s_ops = chunk_operands(st, s._words, BURNIN, s.cfg)
    t_rows, t_scal, tb = chunk_operands_kernel_rng(
        st, s._words, BURNIN, s.cfg, test_stream_bits=True)
    e_bits, e_x, e_l, t_out, t_la = b1_kernel_rng_compare(
        lp, st.x, t_rows, t_scal, D, "config 3, stream words", key, BURNIN,
        test_bits=tb)
    stream = fused_chunk(st.x, lp0, *s_ops, lp, **kw)
    kept, vs_stream = match_decisions(t_out[2], stream[2],
                                      (t_scal[..., 5] - t_la).abs())
    dx = float((t_out[0][kept] - stream[0][kept]).abs().max())
    if dx > B1_TOL["x"]:
        raise AssertionError(f"kernel-RNG B1 on stream words: max |dx| "
                             f"{dx:.3g} from stream-mode B1")
    readings["config3 stream words"] = {
        "excused_bits": e_bits, "max_abs_dx": e_x, "max_abs_dlogp": e_l,
        "excused_vs_stream_mode": vs_stream, "max_abs_dx_vs_stream_mode": dx,
        "decisions_equal_stream_mode": bool(torch.equal(t_out[2],
                                                        stream[2]))}
    log("B1 fused_chunk, kernel RNG: against the plain version, limits "
        f"{json.dumps(B1_TOL)}:", json.dumps(readings))
    log("B1 fused_chunk, kernel RNG, the Gaussian past the shared route "
        "(n = 256, G = 10), device ms and bound:", json.dumps(wide))

    kw_k = dict(kw, rng="kernel", run_key=key, t0=BURNIN)
    kernel = lambda: fused_chunk(st.x, lp0, rows, None, None, None, scal,
                                 lp, **kw_k)
    plain = lambda: fused_chunk_kernel_rng_plain(
        st.x, lp0, rows, scal, lp, run_key=key, t0=BURNIN, **kw)
    stream_fn = lambda: fused_chunk(st.x, lp0, *s_ops, lp, **kw)
    # the two modes in turns on the same chunk: stream, kernel, kernel,
    # stream (device ms a launch over the launches the profiler recorded)
    timed = [timed_launches(f, 200, 20) for f in (stream_fn, kernel, kernel,
                                            stream_fn)]
    turns = [t[0] for t in timed]
    log("B1 device ms in turns (stream, kernel RNG, kernel RNG, stream), "
        "the launches recorded of 200:",
        json.dumps([turns, [t[1] for t in timed]]))
    times = (min(turns[1:3]), device_ms(plain, reps=20, warmup=3),
             call_ms(kernel), call_ms(plain, reps=30, warmup=3))
    n_bytes, n_ops = b1_work(st.x, rows, scal, len(means), kernel_rng=True)
    rec = kernel_record(
        "fused_chunk_kernel_rng", "bipymc_tpu_torch/csrc/fused_chunk.cu",
        "bipymc_tpu/ops/fused_chunk.py:242", max(ex, el), times, n_bytes,
        n_ops)
    rec["rng"] = "kernel (_draw_kernel_randomness :73)"
    rec["turns_ms"] = {"stream": [turns[0], turns[3]],
                       "kernel_rng": [turns[1], turns[2]]}
    rec["plan"] = plan
    rec["gaussian_wide"] = wide
    return rec


# ---------------------------------------------------------------- phase 2f
# the stretch workload (benchmarks/profile_stretch_fused.py:30-47): 256
# walkers in d = 16 on N(0, diag(scales²)), 20,000 generations a run, B9
# at 64 generations a launch
ST_N, ST_D, ST_G, ST_GENS, ST_PERGEN = 256, 16, 64, 20000, 2000
# B9 against its plain version over the compared entries (B4's bound):
# x* is one FMA on both sides, so x differs only where a decision did
B9_TOL = {"rtol": 1e-5, "atol": 1e-6}


def stretch_setup():
    """The stretch workload's target, scales and start x0 = N(0, 1)·scales
    [256, 16], drawn from the seed with NumPy (phases 2f and 9)."""
    import bipymc_tpu_torch as bt

    scales = np.linspace(0.5, 3.0, ST_D).astype(np.float32)
    lp = bt.correlated_gaussian(np.zeros(ST_D),
                                np.diag(scales.astype(np.float64) ** 2))
    x0 = (np.random.default_rng(SEED).standard_normal((ST_N, ST_D))
          * scales).astype(np.float32)
    return lp, scales, x0


def b9_random_operands(G, n, d, seed, dev):
    """Per-walker (j, z, log u) [G, n] from random words, converted as the
    engines convert them, and x0 = 2·N(0, 1) [n, d]."""
    from bipymc_tpu_torch.samplers.stretch import convert_words

    g = torch.Generator(device=dev).manual_seed(seed)
    words = torch.randint(-2 ** 31, 2 ** 31, (G, n, 3), generator=g,
                          device=dev, dtype=torch.int32)
    x0 = 2.0 * torch.randn((n, d), generator=g, device=dev)
    return (x0, *convert_words(words, 2.0))


def b9_compare(lp, x0, j, z, log_u, label):
    """B9 against its plain version on one operand set; returns the
    excused bits, max |dx| and max |dlogp| over the comparable entries,
    the kernel's outputs and the route it took."""
    from bipymc_tpu_torch.models.targets import kernel_form
    from bipymc_tpu_torch.ops.fused_stretch import (fused_stretch,
                                                    fused_stretch_plain, plan)
    from bipymc_tpu_torch.testing import (match_stretch_decisions,
                                          stretch_log_alpha)

    half = x0.shape[0] // 2
    lp0 = lp(x0)
    out = fused_stretch(x0, lp0, j, z, log_u, lp, half)
    route = fused_stretch.last_plan
    form = kernel_form(lp)
    kind, m = ((0, 0) if form.name == "correlated_gaussian"
               else (1, form.arrays["means"].shape[0]))
    want = plan(*x0.shape, kind, m)
    if route != want:
        raise AssertionError(f"B9 ({label}): the launch took {route}, "
                             f"ops/fused_stretch.plan {want}")
    ref = fused_stretch_plain(x0, lp0, j, z, log_u, lp, half)
    ref_la = stretch_log_alpha(x0, lp0, j, z, log_u, lp)
    torch.cuda.synchronize()
    kept, excused = match_stretch_decisions(out[2], ref[2],
                                            (log_u - ref_la).abs())
    errs = []
    for key, a, b in (("x", out[0][kept], ref[0][kept]),
                      ("logp", out[1][kept], ref[1][kept])):
        tol = B9_TOL["atol"] + B9_TOL["rtol"] * b.abs()
        if not (bool(torch.all((a - b).abs() <= tol))
                and bool(torch.all(torch.isfinite(a)))):
            raise AssertionError(
                f"B9 differs from its plain version ({label}): max "
                f"|d{key}| {float((a - b).abs().max()):.3g}")
        errs.append(float((a - b).abs().max()))
    return excused, errs[0], errs[1], out, route


def b9_work(G, n, d, kind, n_modes=0):
    """(bytes, operations) of one B9 call: x0, logp0, (j, z, log u) and the
    target's constants read once; x_hist, logp_hist and the accept bytes
    written once. A walker-generation: x* (3d), the target (kind 0:
    2d² + 3d + 4; kind 1: 3kd + 10k) and the accept (~30 with its log)."""
    n_const = d * d + d if kind == 0 else n_modes * d + n_modes
    n_bytes = 4 * (n * d + n + 3 * G * n + n_const + G * n * d + G * n) \
        + G * n
    target = 2 * d * d + 3 * d + 4 if kind == 0 else \
        3 * n_modes * d + 10 * n_modes
    return n_bytes, G * n * (3 * d + target + 30)


def check_b9(dev):
    """Phase 2f: B9 against its plain version at the stretch path's shape
    (its first chunk's own words) and at edge shapes, then timed."""
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.fused_stretch import (fused_stretch,
                                                    fused_stretch_plain)
    from bipymc_tpu_torch.samplers.stretch_fused import chunk_words

    lp, scales, x0_np = stretch_setup()
    x0 = torch.from_numpy(x0_np).to(dev)
    s = bt.EnsembleSampler(lp, n_chains=ST_N, seed=SEED, fused=True,
                           device=dev)
    s._ensure_state(x0, 1.0)                  # its run key's word source
    main_ops = chunk_words(s._words, 0, ST_G, ST_N, ST_D, s.cfg.a,
                           torch.float32, dev)
    c3_lp = bt.gaussian_mixture(bt.baseline_config3_means(D), sigma=1.0)

    def case(label, tgt, G, n, d, seed, x=None):
        x_r, *ops = b9_random_operands(G, n, d, seed, dev)
        return label, tgt, x_r if x is None else x, ops

    x_big = torch.from_numpy((np.random.default_rng(SEED + 1)
                              .standard_normal((1024, ST_D)) * scales)
                             .astype(np.float32)).to(dev)
    cases = [("main G=64 n=256 d=16 gaussian", lp, x0, main_ops),
             case("G=64 n=32 d=16 gaussian", lp, 64, 32, ST_D, 1, x0[:32]),
             case("G=7 n=2 d=1 gaussian", b4_target("gaussian", 1), 7, 2, 1,
                  2),
             case("G=5 n=18 d=3 mixture", b4_target("mixture", 3), 5, 18, 3,
                  3),
             case("G=8 n=1024 d=16 gaussian (the cap)", lp, 8, 1024, ST_D,
                  4, x_big),
             case("G=4 n=256 d=100 config-3 mixture", c3_lp, 4, 256, D, 5),
             case("G=4 n=1024 d=100 config-3 mixture", c3_lp, 4, 1024, D,
                  7),
             case("G=4 n=256 d=240 gaussian", b4_target("gaussian", 240), 4,
                  256, 240, 8),
             case("G=4 n=256 d=300 gaussian", b4_target("gaussian", 300), 4,
                  256, 300, 9),
             case("G=4 n=1024 d=240 gaussian", b4_target("gaussian", 240), 4,
                  1024, 240, 10),
             case("G=4 n=256 d=300 mixture", b4_target("mixture", 300), 4,
                  256, 300, 11),
             case("G=6 n=16 d=4 gaussian, non-finite",
                  b4_target("gaussian", 4), 6, 16, 4, 6)]
    # an infinite stretch factor makes x* infinite, so its target value is
    # not finite: both versions must reject it
    z_nf = cases[-1][3][1]
    z_nf[1, 0] = z_nf[3, 15] = torch.inf
    readings = {}
    for label, tgt, x, ops in cases:
        if not (tgt(x).isfinite().all()):
            raise AssertionError(f"B9 case {label}: a start logp is not "
                                 "finite")
        e_bits, e_x, e_l, out, route = b9_compare(tgt, x, *ops, label)
        if "non-finite" in label and (bool(out[2][1, 0])
                                      or bool(out[2][3, 15])):
            raise AssertionError("B9 accepted a non-finite proposal")
        readings[label] = {"route": route, "excused_bits": e_bits,
                           "max_abs_dx": e_x, "max_abs_dlogp": e_l,
                           "acceptance": float(out[2].float().mean())}
    log(f"B9 fused_stretch: against the plain version, limits "
        f"{json.dumps(B9_TOL)} (route: the population's place, the "
        "constants' place, L, threads, shared bytes):", json.dumps(readings))
    places = {tuple(r["route"][:2]) for r in readings.values()}
    wide = [r["route"][1] for k, r in readings.items() if "d=240" in k
            or "d=300 gaussian" in k]
    if places != {("shared", "shared"), ("global", "shared"),
                  ("global", "device")} or \
            tuple(readings[cases[0][0]]["route"][:2]) != ("shared", "shared") \
            or wide != ["device"] * 3:
        raise AssertionError(f"B9's routes in phase 2f: {readings}")

    # every route and place forced where it takes the shape, at the main
    # shape and at config 3's width on the Gaussian: the same outputs bit
    # for bit (the same per-walker code, the same lanes a walker; the
    # ring's tiles summed as eval_group sums the shared constants)
    lp0 = lp(x0)
    run = lambda route=None, consts=None: fused_stretch(
        x0, lp0, *main_ops, lp, ST_N // 2, route=route, consts=consts)
    g100 = b4_target("gaussian", D)
    x100, *ops100 = b9_random_operands(4, 256, D, 12, dev)
    lp100 = g100(x100)
    for label, call in (("main", run),
                        ("G=4 n=256 d=100 gaussian",
                         lambda route=None, consts=None: fused_stretch(
                             x100, lp100, *ops100, g100, 128, route=route,
                             consts=consts))):
        ref = call()
        for route in ("shared", "global"):
            for consts in ("shared", "device"):
                out = call(route, consts)
                if fused_stretch.last_plan[:2] != (route, consts) or not all(
                        torch.equal(a, b) for a, b in zip(ref, out)):
                    raise AssertionError(
                        f"B9 {label}: route {route}, constants in {consts} "
                        "memory differ from the chosen launch's outputs")
    log("B9: every route and place forced gives the chosen launch's "
        "outputs bit for bit at the main shape and at G=4 n=256 d=100")
    plain = lambda: fused_stretch_plain(x0, lp0, *main_ops, lp, ST_N // 2)
    # the routes in turns (shared, global, global, shared), then the
    # constants from device memory in turns with the chosen launch
    b9_ms = lambda f: timed_launches(f, 200, 20, key="fused_stretch")[0]
    turns = [b9_ms(lambda r=r: run(r)) for r in
             (None, "global", "global", None)]
    c_turns = [b9_ms(lambda c=c: run(consts=c)) for c in
               (None, "device", "device", None)]
    log("B9 at the main shape, device ms in turns (shared, global, global, "
        "shared):", json.dumps(turns), "; (chosen, constants in device "
        "memory x 2, chosen):", json.dumps(c_turns))
    times = (timed_launches(run, 200, 20, key="fused_stretch")[0],
             device_ms(plain, reps=5, warmup=1), call_ms(run),
             call_ms(plain, reps=10, warmup=2))
    n_bytes, n_ops = b9_work(ST_G, ST_N, ST_D, 0)
    rec = kernel_record(
        "fused_stretch", "bipymc_tpu_torch/csrc/fused_stretch.cu",
        "bipymc_tpu/ops/fused_stretch.py:125",
        max(readings[cases[0][0]]["max_abs_dx"],
            readings[cases[0][0]]["max_abs_dlogp"]), times, n_bytes, n_ops)
    rec["routes_in_turns_ms"] = {"shared": [turns[0], turns[3]],
                                 "global": [turns[1], turns[2]]}
    rec["consts_in_turns_ms"] = {"shared": [c_turns[0], c_turns[3]],
                                 "device": [c_turns[1], c_turns[2]]}
    rec["wide"] = b9_wide_times(dev)
    return rec


def b9_wide_times(dev):
    """B9 on the correlated Gaussian past its shared-memory constants, at
    the stretch workload's n = 256 and G = 64, d = 240 and 300, in turns
    (240, 300, 300, 240), each 10 launches after 2 of warm-up timed one
    by one by CUDA events around the launch (synchronised after it; a
    launch takes milliseconds, so the host's part is small): their
    median, and the bound. (The profiler recorded none of 20 such
    launches in a long process, my chip call 2, PR 25.)"""
    from bipymc_tpu_torch.ops.fused_stretch import fused_stretch

    calls = {}
    for d in B1_WIDE_D:
        lp = b4_target("gaussian", d)
        x0, *ops = b9_random_operands(ST_G, ST_N, d, 20 + d, dev)
        lp0 = lp(x0)
        calls[d] = lambda x0=x0, lp0=lp0, ops=ops, lp=lp: fused_stretch(
            x0, lp0, *ops, lp, ST_N // 2)

    def each_ms(fn, reps=10, warmup=2):
        for _ in range(warmup):
            fn()
        out = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            out.append(e0.elapsed_time(e1))
        return float(np.median(out))

    turns = {d: [] for d in calls}
    for d in list(calls) + list(calls)[::-1]:
        turns[d].append(each_ms(calls[d]))
    wide = {}
    for d in calls:
        calls[d]()
        n_bytes, n_ops = b9_work(ST_G, ST_N, d, 0)
        wide[f"d{d}"] = {
            "ms": float(np.median(turns[d])),
            "turns_events_ms": turns[d],
            "plan": list(fused_stretch.last_plan),
            "bound_ms": bound_ms(n_bytes, n_ops),
            "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                         >= n_ops / FP32_OPS_PER_S else "operations")}
    log("B9 on the Gaussian at n=256, G=64, constants in device memory:",
        json.dumps(wide))
    return wide


# ---------------------------------------------------------------- phase 2g
def check_b11(dev):
    from bipymc_tpu_torch.ops.gather_rows import (gather_rows,
                                                  gather_rows_reference)
    from bipymc_tpu_torch.samplers.dream import n_words
    from bipymc_tpu_torch.samplers.dream_fused import chunk_row_idx

    # the fused chunk's own indices: B3 on the config-3 run's words of its
    # first chunk, into its archive after burn-in
    _, _, s = config3_burned_in(dev)
    st = s.final_state
    blk = s._words.block(BURNIN, 10, N_CHAINS, n_words(s.cfg, D), dev)
    chunk_idx = chunk_row_idx(st, blk, s.cfg)               # [2560, 6]
    buf = st.archive.buf                                     # [8192, 100]
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand_buf(cap, d, dtype=torch.float32, ld=None):
        return torch.randn((cap, ld or d), generator=g, device=dev
                           ).to(dtype)[:, :d]

    def rand_idx(shape, lo, hi, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    cases = {
        "fused chunk [10, 256, 6] (B3)": (buf, chunk_idx.view(10, N_CHAINS,
                                                               6)),
        "per generation [256, 6] (B3)": (buf, chunk_idx[:N_CHAINS]),
        "duplicate rows": (rand_buf(64, D), rand_idx((300,), 0, 4)),
        "below 0 and at or above cap": (rand_buf(64, D),
                                        rand_idx((2000,), -100, 200)),
        "int64": (buf, rand_idx((N_CHAINS, 6), -5, CAPACITY + 8,
                                torch.int64)),
        "d=1": (rand_buf(50, 1), rand_idx((10, 16, 7), -2, 52)),
        "d=3": (rand_buf(50, 3), rand_idx((37,), 0, 50)),
        "d=129": (rand_buf(50, 129), rand_idx((4, 9), 0, 50)),
        "float64": (rand_buf(512, D, torch.float64),
                    rand_idx((10, 16, 7), -1, 513)),
        "bfloat16": (rand_buf(512, D, torch.bfloat16),
                     rand_idx((37,), 0, 512, torch.int64)),
        "bfloat16 d=3": (rand_buf(512, 3, torch.bfloat16),
                         rand_idx((37,), 0, 512)),
        "row stride 101": (rand_buf(512, D, ld=101),
                           rand_idx((N_CHAINS, 6), 0, 512)),
        "empty": (buf, rand_idx((0,), 0, 1)),
    }
    for label, (b, idx) in cases.items():
        before = gather_rows.launches
        out = gather_rows(b, idx)
        ref = gather_rows_reference(b, idx)
        torch.cuda.synchronize()
        if gather_rows.launches != before + (idx.numel() > 0):
            raise AssertionError(f"B11 ({label}): launched "
                                 f"{gather_rows.launches - before} times")
        if out.shape != (*idx.shape, b.shape[1]) or not torch.equal(out,
                                                                    ref):
            raise AssertionError(f"B11 differs from its plain version "
                                 f"({label})")
    b, idx = cases["below 0 and at or above cap"]
    if not (bool((idx < 0).any()) and bool((idx >= b.shape[0]).any())):
        raise AssertionError("B11: the clamp case has no index out of range")
    log(f"B11 gather_rows: bit-equal to the plain version in {len(cases)} "
        f"cases ({', '.join(cases)})")

    kernel = lambda: gather_rows(buf, chunk_idx)
    plain = lambda: gather_rows_reference(buf, chunk_idx)
    flat = chunk_idx.view(-1)            # in range: index_select needs no
    library = lambda: torch.index_select(buf, 0, flat)           # clamp
    times = (device_ms(kernel), device_ms(plain), call_ms(kernel),
             call_ms(plain))
    # bytes: each distinct row the chunk reads once, each gathered row
    # written once, the indices; operations: a clamp an index
    n_rows = chunk_idx.numel()
    n_distinct = int(torch.unique(chunk_idx).numel())
    n_bytes = (n_distinct + n_rows) * D * 4 + n_rows * 4
    record = kernel_record(
        "gather_rows", "bipymc_tpu_torch/csrc/gather_rows.cu",
        "bipymc_tpu/ops/gather_rows.py:55", 0.0, times, n_bytes, n_rows,
        library_ms=device_ms(library))
    record["torch_index_ms"] = device_ms(lambda: buf[chunk_idx])
    # the archive (3.3 MB) stays in the 50 MB L2 across repeated calls:
    # B11 alone with L2 overwritten (128 MB of zeros) before each call
    scratch = torch.empty(32 * 2 ** 20, device=dev)

    def cold():
        scratch.zero_()
        gather_rows(buf, chunk_idx)

    for _ in range(5):
        cold()
    rows = device_times(cold, 50)
    record["ms_cold_l2"] = sum(us for k, (us, _) in rows.items()
                               if "gather_rows" in k) / 50 / 1e3
    log("B11 at the fused chunk's shape:", json.dumps(
        {"distinct_rows": n_distinct, "rows": n_rows,
         "ms_cold_l2": record["ms_cold_l2"],
         "library_ms (index_select)": record["library_ms"],
         "torch_index_ms (buf[idx], the default route)":
             record["torch_index_ms"]}))
    return record


# ---------------------------------------------------------------- phase 2h
# config 3's, the A/B's of phase 3g, config 5's DREAM (1,024 × 2), the
# JAX package's test's, ragged ones, and config 3's in float64
B10_SHAPES = [(N_CHAINS, D, np.float32), (1024, D, np.float32),
              (4096, D, np.float32), (1024, 2, np.float32),
              (200, 37, np.float32), (7, 129, np.float32), (1, 1, np.float32),
              (N_CHAINS, D, np.float64)]


def b10_operands(n, d, seed, edges, dtype, dev):
    from bipymc_tpu_torch.testing import ACCEPT_FIELDS, accept_operands

    ops = accept_operands(n, d, seed, edges, dtype=dtype)
    return [torch.from_numpy(ops[k]).to(dev) for k in ACCEPT_FIELDS]


def b10_work(n, d, elem):
    """B10's bytes (the kept row of x or x* read, x_new's row written;
    five scalars in, two out and the accept byte, a chain) and
    operations (subtract, add, min, the finite test, compare, and, two
    selects and an add, a chain)."""
    return 2 * n * d * elem + n * (7 * elem + 1), 10 * n


def check_b10(dev):
    from bipymc_tpu_torch.ops.accept_select import (accept_select,
                                                    accept_select_reference)
    from bipymc_tpu_torch.testing import (accept_edge_groups, bit_equal,
                                          check_accept_edges)

    n_cases = 0
    for n, d, dtype in B10_SHAPES:
        for i, edges in enumerate(accept_edge_groups(n)):
            ops = b10_operands(n, d, SEED + n + d + i, edges, dtype, dev)
            before = accept_select.launches
            out = accept_select(*ops)
            ref = accept_select_reference(*ops)
            torch.cuda.synchronize()
            if accept_select.launches != before + 1:
                raise AssertionError(f"B10 at [{n}, {d}]: launched "
                                     f"{accept_select.launches - before} "
                                     "times")
            for name, a, b in zip(("x_new", "logp_new", "logp_sum_new",
                                   "accepted"), out, ref):
                if not bit_equal(a, b):
                    raise AssertionError(
                        f"B10 differs from its plain version at [{n}, {d}] "
                        f"{np.dtype(dtype).name}: {name}")
            check_accept_edges(out[3].cpu(), edges)
            n_cases += 1
    shapes = [f"{n}x{d} {np.dtype(t).name}" for n, d, t in B10_SHAPES]
    log(f"B10 accept_select: bit-equal to the plain version in {n_cases} "
        f"cases ({', '.join(shapes)}; every shape with the NaN and "
        "infinite edge rows)")

    record = None
    for n in (N_CHAINS, 4096):
        ops = b10_operands(n, D, SEED, (), np.float32, dev)
        times = (device_ms(lambda: accept_select(*ops)),
                 device_ms(lambda: accept_select_reference(*ops)),
                 call_ms(lambda: accept_select(*ops)),
                 call_ms(lambda: accept_select_reference(*ops)))
        rec = kernel_record(
            "accept_select", "bipymc_tpu_torch/csrc/accept_select.cu",
            "bipymc_tpu/ops/accept_select.py:57", 0.0, times,
            *b10_work(n, D, 4))
        if record is None:
            record = rec
        else:
            record["at_4096x100"] = {k: rec[k] for k in (
                "ms", "plain_ms", "call_ms", "plain_call_ms", "bound_ms")}
    return record


# ---------------------------------------------------------------- phase 3
def main_path(dev):
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
    from bipymc_tpu_torch.ops.dream_proposal import dream_propose
    from bipymc_tpu_torch.ops.gather_rows import gather_rows

    from bipymc_tpu_torch.ops.accept_select import accept_select

    log_prob, means, theta0 = config3_setup(dev)
    s = bt.DreamZs(log_prob, n_chains=N_CHAINS, seed=SEED,
                   burnin_gens=BURNIN, archive_capacity=CAPACITY, device=dev)
    distinct_idx.launches = dream_propose.launches = 0
    gather_rows.launches = accept_select.launches = 0
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
    if gather_rows.launches:
        raise AssertionError(f"B11 launched {gather_rows.launches} times "
                             "on the default route")

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
    return launches, s


def kernel_us(rows, n_units, *names):
    """µs a unit of the kernels ``names`` in a profile ``rows``, matched
    by the demangled name, whole ("chol_kernel" alone is also in B6's
    "bchol_kernel")."""
    keys = [f"(anonymous namespace)::{name}{end}" for name in names
            for end in "(<"]
    return sum(us for key, (us, _) in rows.items()
               if any(k in key for k in keys)) / n_units


def busy_share(s, n_units=200, per_unit=1, unit="gen"):
    """The device's busy share of a unit of work, and its time by kernel:
    ``n_units`` units of ``per_unit`` steps timed alone, then as many
    under the profiler (which slows the host, not the kernels). Returns
    the wall µs a unit and the profile, {kernel: (µs, calls)}."""
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
    return wall_us, rows


# ---------------------------------------------------------- phases 3b, 3c
def torch_gather_us(rows, n_units):
    """The µs a unit of torch's own gather kernels in a ``busy_share``
    profile, and their names."""
    keys = [k for k in rows if any(name in k for name in (
        "gather_kernel", "index_elementwise", "indexSelect"))
        and "gather_rows" not in k]
    return sum(rows[k][0] for k in keys) / n_units, [k[:80] for k in keys]


def fused_path(dev, rng="stream", gather=False):
    """Config 3 on the fused engine, as ``bench.py`` times it, with B1 in
    stream mode (3b) or kernel-RNG mode (3c), and with ``gather`` the
    archive rows through B11 (3d). Returns the launch counts, the result
    line and the sampler."""
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
    from bipymc_tpu_torch.ops.dream_proposal import dream_propose
    from bipymc_tpu_torch.ops.fused_chunk import fused_chunk
    from bipymc_tpu_torch.ops.gather_rows import gather_rows

    log_prob, means, theta0 = config3_setup(dev)
    flags = dict(fused_gather="kernel", gather_kernel=True) if gather else {}
    s = bt.DreamZs(log_prob, n_chains=N_CHAINS, seed=SEED,
                   burnin_gens=BURNIN, archive_capacity=CAPACITY, fused=True,
                   fused_rng=rng, device=dev, **flags)
    distinct_idx.launches = dream_propose.launches = fused_chunk.launches = 0
    fused_chunk.kernel_rng_launches = gather_rows.launches = 0
    t0 = time.perf_counter()
    s.run_mcmc(WARM_GENS, theta0)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.run_mcmc(TIMED_GENS)
    elapsed = time.perf_counter() - t0
    launches = {"fused_chunk": fused_chunk.launches,
                "fused_chunk_kernel_rng": fused_chunk.kernel_rng_launches,
                "dream_propose": dream_propose.launches,
                "distinct_idx": distinct_idx.launches,
                "gather_rows": gather_rows.launches}
    n_chunks = (WARM_GENS + TIMED_GENS - BURNIN) // 10
    # fused_chunk counts B1's launches in either mode; no stream-mode
    # launch may occur in kernel-RNG mode, nor the reverse; B11 once a
    # burn-in generation and once a chunk with ``gather``, else never
    want = {"fused_chunk": n_chunks,
            "fused_chunk_kernel_rng": n_chunks if rng == "kernel" else 0,
            "dream_propose": BURNIN, "distinct_idx": BURNIN + n_chunks,
            "gather_rows": BURNIN + n_chunks if gather else 0}
    if launches != want:
        raise AssertionError(f"fused config 3 ({rng}, gather={gather}) "
                             f"launched {launches}, want {want}")

    chains = s.get_chain(discard=WARM_GENS)          # [256, 5000, 100]
    if chains.shape != (N_CHAINS, TIMED_GENS, D) or \
            not np.all(np.isfinite(chains)):
        raise AssertionError(f"history: shape {chains.shape} or non-finite")
    gens_per_sec = TIMED_GENS / elapsed
    ess, ess_per_sec = bt.ess_rate(chains, gens_per_sec)
    occ = bt.mode_occupancy(chains[:, -1], means)
    result = {
        "gens_per_sec": gens_per_sec,
        "chain_steps_per_sec": gens_per_sec * N_CHAINS,
        "ess_window": ess, "ess_per_sec": ess_per_sec,
        "acceptance": float(np.mean(s._history["accepted"][WARM_GENS:])),
        "mode_occupancy": occ.tolist(), "warmup_s": warm_s,
        "timed_s": elapsed, "launches": launches}
    log("fused main path:" if rng == "stream" else
        "fused main path, kernel RNG:" if not gather else
        "fused main path, kernel RNG, B11 gathers:", json.dumps(result))
    if occ.min() == 0:
        raise AssertionError(f"a mode lost all its chains: {occ.tolist()}")
    if not bool(torch.all(torch.isfinite(s.final_state.logp))):
        raise AssertionError(f"fused config 3 ({rng}): a final logp is not "
                             "finite")
    wall_us, rows = busy_share(s, n_units=20, per_unit=10, unit="chunk")
    result["profile"] = {
        "wall_us_per_chunk": wall_us,
        "busy_us_per_chunk": sum(us for us, _ in rows.values()) / 20,
        "kernels_per_chunk": sum(c for _, c in rows.values()) / 20,
        "b11_us_per_chunk": sum(us for k, (us, _) in rows.items()
                                if "gather_rows" in k) / 20,
        "torch_gather_us_per_chunk": torch_gather_us(rows, 20)}
    if (result["profile"]["b11_us_per_chunk"] > 0) != gather:
        raise AssertionError(f"fused config 3 ({rng}, gather={gather}): "
                             "B11 in the profile is not as configured")
    result["rhat_stop"] = rhat_stop(dev, fused=True, rng=rng, gather=gather)
    return launches, result, s


def gather_path(dev, s_ref, ref_res):
    """Phase 3d: phase 3c with the archive rows through B11, held to phase
    3c's sampler ``s_ref`` and result ``ref_res``. Returns the launch
    counts."""
    launches, res, s = fused_path(dev, rng="kernel", gather=True)
    n_gens = WARM_GENS + TIMED_GENS
    h, h_ref = s._history, s_ref._history
    for key in ("accepted", "x"):
        if not np.array_equal(h[key][:n_gens], h_ref[key][:n_gens]):
            raise AssertionError(f"phase 3d: the {key} history differs from "
                                 "phase 3c's")
    if res["rhat_stop"] != ref_res["rhat_stop"]:
        raise AssertionError(f"phase 3d: R-hat stop {res['rhat_stop']}, "
                             f"phase 3c {ref_res['rhat_stop']}")
    log("config 3 fused kernel RNG, torch gather (3c) vs B11 (3d):",
        json.dumps({"bit_equal_gens": n_gens,
                    "rhat_stop (gens, max R-hat)": res["rhat_stop"],
                    **{k: [ref_res[k], res[k]] for k in (
                        "gens_per_sec", "ess_per_sec", "profile")}}))
    return launches


def fused_modes_side_by_side(stream_res, kernel_res, s_stream, s_kernel):
    """Phases 3b and 3c's results on one line, then a chunk's wall and
    busy time of the two samplers in turns (stream, kernel RNG, kernel
    RNG, stream)."""
    keys = ("gens_per_sec", "ess_per_sec", "acceptance", "mode_occupancy")
    log("config 3 fused, stream vs kernel RNG:", json.dumps(
        {k: [stream_res[k], kernel_res[k]] for k in keys}))
    walls = [busy_share(s, n_units=20, per_unit=10, unit="chunk")[0]
             for s in (s_stream, s_kernel, s_kernel, s_stream)]
    log("wall us a chunk in turns (stream, kernel RNG, kernel RNG, "
        "stream):", json.dumps(walls))


# ------------------------------------------------------ phases 3e, 3f, 3g
def wall_us_per_gen(step_fn, n_gens):
    """Host wall µs a generation of ``step_fn(n_gens)``, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_fn(n_gens)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_gens * 1e6


def in_turns(run_default, run_b10, n_gens=200, rounds=2):
    """Wall µs a generation of the two variants in turns (default, B10,
    B10, default), ``rounds`` times."""
    out = {"default": [], "b10": []}
    for _ in range(rounds):
        for key, fn in (("default", run_default), ("b10", run_b10),
                        ("b10", run_b10), ("default", run_default)):
            out[key].append(wall_us_per_gen(fn, n_gens))
    return out


def accept_path(dev, s_ref):
    """Phase 3e: phase 3's run with ``pallas_accept=True``, held to phase
    3's sampler ``s_ref``; then both samplers in turns and profiled.
    Returns B10's launches."""
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.accept_select import accept_select
    from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
    from bipymc_tpu_torch.ops.dream_proposal import dream_propose
    from bipymc_tpu_torch.ops.gather_rows import gather_rows

    log_prob, means, theta0 = config3_setup(dev)
    s = bt.DreamZs(log_prob, n_chains=N_CHAINS, seed=SEED,
                   burnin_gens=BURNIN, archive_capacity=CAPACITY,
                   pallas_accept=True, device=dev)
    distinct_idx.launches = dream_propose.launches = 0
    gather_rows.launches = accept_select.launches = 0
    s.run_mcmc(WARM_GENS, theta0)
    t0 = time.perf_counter()
    s.run_mcmc(TIMED_GENS)
    elapsed = time.perf_counter() - t0
    n_gens = WARM_GENS + TIMED_GENS
    launches = {"accept_select": accept_select.launches,
                "dream_propose": dream_propose.launches,
                "distinct_idx": distinct_idx.launches,
                "gather_rows": gather_rows.launches}
    want = {"accept_select": n_gens, "dream_propose": n_gens,
            "distinct_idx": n_gens, "gather_rows": 0}
    if launches != want:
        raise AssertionError(f"config 3 with B10 launched {launches}, "
                             f"want {want}")
    h, h_ref = s._history, s_ref._history
    for key in ("accepted", "x"):
        if not np.array_equal(h[key][:n_gens], h_ref[key][:n_gens]):
            raise AssertionError(f"phase 3e: the {key} history differs from "
                                 "phase 3's")
    occ = bt.mode_occupancy(s.get_chain(discard=WARM_GENS)[:, -1], means)
    if occ.min() == 0:
        raise AssertionError(f"a mode lost all its chains: {occ.tolist()}")
    walls = in_turns(lambda k: s_ref.run_mcmc(k), lambda k: s.run_mcmc(k))
    profiles = {}
    for key, smp in (("default", s_ref), ("b10", s)):
        wall_us, rows = busy_share(smp)
        busy_us = sum(us for us, _ in rows.values()) / 200
        profiles[key] = {
            "wall_us_per_gen": wall_us, "busy_us_per_gen": busy_us,
            "busy_share": busy_us / wall_us,
            "kernels_per_gen": sum(c for _, c in rows.values()) / 200,
            "b10_us_per_gen": sum(us for k, (us, _) in rows.items()
                                  if "accept_select" in k) / 200}
    if profiles["b10"]["b10_us_per_gen"] <= 0 or \
            profiles["default"]["b10_us_per_gen"] > 0:
        raise AssertionError("phase 3e: B10 in the profiles is not as "
                             "configured")
    log("config 3 per generation, default (3) vs B10 (3e):", json.dumps(
        {"bit_equal_gens": n_gens, "launches": launches,
         "mode_occupancy": occ.tolist(),
         "gens_per_sec_b10": TIMED_GENS / elapsed,
         "wall_us_per_gen_in_turns": walls, "profiles": profiles}))
    return launches["accept_select"]


def fused_accept_path(dev, s_ref):
    """Phase 3f: phase 3c's sampler (kernel RNG) with ``pallas_accept=True``:
    B10 in the 500 burn-in generations and in no chunk, the histories
    bit-equal to phase 3c's sampler ``s_ref``."""
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.accept_select import accept_select
    from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
    from bipymc_tpu_torch.ops.dream_proposal import dream_propose
    from bipymc_tpu_torch.ops.fused_chunk import fused_chunk

    log_prob, _, theta0 = config3_setup(dev)
    s = bt.DreamZs(log_prob, n_chains=N_CHAINS, seed=SEED,
                   burnin_gens=BURNIN, archive_capacity=CAPACITY, fused=True,
                   fused_rng="kernel", pallas_accept=True, device=dev)
    distinct_idx.launches = dream_propose.launches = fused_chunk.launches = 0
    fused_chunk.kernel_rng_launches = accept_select.launches = 0
    n_gens = WARM_GENS + TIMED_GENS
    s.run_mcmc(WARM_GENS, theta0)
    s.run_mcmc(TIMED_GENS)
    n_chunks = (n_gens - BURNIN) // 10
    launches = {"accept_select": accept_select.launches,
                "dream_propose": dream_propose.launches,
                "distinct_idx": distinct_idx.launches,
                "fused_chunk_kernel_rng": fused_chunk.kernel_rng_launches}
    want = {"accept_select": BURNIN, "dream_propose": BURNIN,
            "distinct_idx": BURNIN + n_chunks,
            "fused_chunk_kernel_rng": n_chunks}
    if launches != want or fused_chunk.launches != n_chunks:
        raise AssertionError(f"fused kernel-RNG config 3 with B10 launched "
                             f"{launches}, want {want}")
    h, h_ref = s._history, s_ref._history
    for key in ("accepted", "x"):
        if not np.array_equal(h[key][:n_gens], h_ref[key][:n_gens]):
            raise AssertionError(f"phase 3f: the {key} history differs from "
                                 "phase 3c's")
    log("config 3 fused kernel RNG with B10 in burn-in (3f):", json.dumps(
        {"bit_equal_gens": n_gens, "launches": launches}))


# the JAX package's A/B sizes but 256, which phase 3e's turns measure
AB_CHAINS = (1024, 4096)


def accept_ab(dev):
    """Phase 3g: the JAX package's own A/B workload for B10
    (``benchmarks/profile_accept_fusion.py:38-52``) on the port: n chains
    × d = 100 on config 3's mixture, archive 8,192, burn-in 500, through
    ``dream.make_step`` with ``StepWords`` and only ``accepted`` kept;
    both variants run the burn-in, then turns of 200 generations. The
    variants' accept bits must be equal at every generation."""
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.core.rng import StepWords
    from bipymc_tpu_torch.samplers import dream

    means = bt.baseline_config3_means(D)
    lp = bt.gaussian_mixture(means, sigma=1.0)
    rows = []
    for n in AB_CHAINS:
        variants = {}
        for key, pa in (("default", False), ("b10", True)):
            cfg = dream.DreamConfig(n_chains=n, burnin_gens=BURNIN,
                                    pallas_accept=pa)
            g = torch.Generator(device=dev).manual_seed(SEED)
            x0 = bt.stratified_mode_init(g, means, n, var=4.0, device=dev)
            z0 = bt.stratified_mode_init(g, means, n, var=4.0, device=dev)
            variants[key] = {
                "state": dream.init(x0, lp, cfg, CAPACITY, z0),
                "step": dream.make_step(lp, cfg), "t": 0, "acc": [],
                "n_words": dream.n_words(cfg, D)}
        words = StepWords(SEED)

        def runner(v):
            def run(n_gens):
                st = v["state"]
                for t in range(v["t"], v["t"] + n_gens):
                    st, info = v["step"](st, words(t, n, v["n_words"], dev),
                                         t)
                    v["acc"].append(info.accepted)
                v["state"], v["t"] = st, v["t"] + n_gens
            return run

        run = {key: runner(v) for key, v in variants.items()}
        for key in run:
            run[key](BURNIN)
        walls = in_turns(run["default"], run["b10"])
        kernels = {}
        for key in run:
            prof = device_times(lambda: run[key](200), 1)
            kernels[key] = sum(c for _, c in prof.values()) / 200
        acc = {key: torch.stack(v["acc"]) for key, v in variants.items()}
        if not torch.equal(acc["default"], acc["b10"]):
            bad = int((acc["default"] != acc["b10"]).any(1).nonzero()[0])
            raise AssertionError(f"phase 3g, {n} chains: the variants' "
                                 f"accept bits differ at generation {bad}")
        row = {"n_chains": n, "gens_compared": acc["b10"].shape[0],
               "acceptance": float(acc["b10"].float().mean()),
               "us_per_gen_in_turns": walls,
               "median_us_per_gen": {k: float(np.median(w))
                                     for k, w in walls.items()},
               "kernels_per_gen": kernels}
        log("B10 A/B (3g):", json.dumps(row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------- phase 4
def rhat_stop(dev, fused=False, rng="stream", gather=False):
    """The within-basin R̂ stop; with ``fused`` the chunks after burn-in
    run on the fused engine, B1 in mode ``rng``; with ``gather`` (fused
    only) the archive rows come from B11. Returns the generations and
    max R̂."""
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
    from bipymc_tpu_torch.ops.dream_proposal import dream_propose
    from bipymc_tpu_torch.ops.fused_chunk import fused_chunk
    from bipymc_tpu_torch.ops.gather_rows import gather_rows

    means = bt.baseline_config3_means(D)
    log_prob = bt.gaussian_mixture(means, sigma=1.0)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    theta0 = bt.var_ball(g, torch.full((D,), 4.0), N_CHAINS,
                         center=means[2], device=dev)
    burnin = 1000
    flags = dict(fused_gather="kernel", gather_kernel=True) if gather else {}
    s = bt.DreamZs(log_prob, n_chains=N_CHAINS, seed=SEED, burnin_gens=burnin,
                   archive_capacity=CAPACITY, fused=fused, fused_rng=rng,
                   device=dev, **flags)
    kw = dict(rhat_tol=1.1, chunk=200, max_chunks=150, warmup_chunks=6)
    distinct_idx.launches = dream_propose.launches = fused_chunk.launches = 0
    fused_chunk.kernel_rng_launches = gather_rows.launches = 0
    warm = s.run_mcmc_until(theta0, **kw)
    s.reset()
    t0 = time.perf_counter()
    info = s.run_mcmc_until(theta0, **kw)
    wall = time.perf_counter() - t0
    steps, rhat = int(info["steps"]), float(np.max(info["rhat"]))
    launches = {"distinct_idx": distinct_idx.launches,
                "dream_propose": dream_propose.launches,
                "fused_chunk": fused_chunk.launches,
                "fused_chunk_kernel_rng": fused_chunk.kernel_rng_launches,
                "gather_rows": gather_rows.launches}
    n_gens = int(warm["steps"]) + steps
    # the fused run: burn-in per generation in each call (the stop comes
    # after the 6 warm-up chunks, past burn-in), then chunks of 10
    pergen = 2 * burnin if fused else n_gens
    n_chunks = (n_gens - pergen) // 10
    want = {"distinct_idx": pergen + n_chunks, "dream_propose": pergen,
            "fused_chunk": n_chunks,
            "fused_chunk_kernel_rng": n_chunks if rng == "kernel" else 0,
            "gather_rows": pergen + n_chunks if gather else 0}
    if launches != want:
        raise AssertionError(f"R-hat runs ({n_gens} generations): launched "
                             f"{launches}, want {want}")
    label = ("rhat stop:" if not fused else "fused rhat stop:"
             if rng == "stream" else "fused kernel-RNG rhat stop:"
             if not gather else "fused kernel-RNG rhat stop, B11 gathers:")
    log(label, json.dumps({"wall_s": wall, "gens": steps, "rhat_max": rhat,
                           "mode_occupancy": bt.mode_occupancy(
                               s.final_state.x.cpu().numpy(),
                               means).tolist(),
                           "launches": launches}))
    if not rhat < 1.1:
        raise AssertionError(f"R-hat stop not reached: max R-hat {rhat}")
    if not bool(torch.all(torch.isfinite(s.final_state.logp))):
        raise AssertionError("R-hat run: a final logp is not finite")
    return steps, rhat


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


def b4_work(n, d, K, stage):
    """Bytes and operations of a DR launch of B4 on the Gaussian: x0,
    logp0, dy1, dy2, scal and the target's constants read once, the
    histories written once; a target evaluation at every step and a second
    one where stage 1 rejected (``stage`` [K, n], from this run)."""
    n_evals = K * n + int((stage != 1).sum())
    n_bytes = 4 * (n * d + n + 3 * K * n * d + 4 * K * n + d * d + d
                   + 2 * K * n) + K * n
    n_ops = n_evals * (2 * d * d + 3 * d) + 2 * K * n * d + 30 * K * n
    return n_bytes, n_ops


def bound_ms(n_bytes, n_ops):
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3


def check_b4(dev):
    """Phase 2b: B4 against its plain version on every route that takes
    each shape, the routes bit-equal to each other, then timed."""
    from bipymc_tpu_torch.ops.fused_rw_chunk import (ROUTES, fused_rw_chunk,
                                                     fused_rw_chunk_plain,
                                                     plan)

    cases = [(n, d, K, kind, delayed)
             for n, d, K in ((1, 2, 50), (4, 2, 20), (37, 129, 7),
                             (256, 100, 50))
             for kind in ("gaussian", "mixture")
             for delayed in (False, True)]
    cases += [(n, d, K, "gaussian", delayed)
              for n, d, K in ((2, 240, 5), (256, 300, 4))
              for delayed in (False, True)]
    errs, runs = {}, {r: 0 for r in ROUTES}
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
        ref = fused_rw_chunk_plain(x0, lp0, dy1, dy2, scal, lp, delayed)
        mixture = int(kind == "mixture")
        label = (f"n={n} d={d} K={K} {kind} delayed={delayed} "
                 f"nonfinite={nonfinite}")
        outs = []
        for route in (None, *ROUTES):
            want = plan(n, d, K, mixture, 4 * mixture, route)
            if want is None:
                continue
            out = fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, delayed,
                                 route=route)
            torch.cuda.synchronize()
            if fused_rw_chunk.last_plan != want:
                raise AssertionError(f"B4 at {label}, route {route}: the "
                                     f"launch took {fused_rw_chunk.last_plan}"
                                     f", plan() says {want}")
            runs[want[0]] += route is not None
            ex = (out[0] - ref[0]).abs()
            el = (out[1] - ref[1]).abs()
            if not (torch.equal(out[2], ref[2])
                    and torch.equal(out[3], ref[3])
                    and bool(torch.all(ex <= 1e-6 + 1e-5 * ref[0].abs()))
                    and bool(torch.all(el <= 1e-6 + 1e-5 * ref[1].abs()))):
                raise AssertionError(
                    f"B4 differs from its plain version at {label}, route "
                    f"{want[0]}: accepts equal "
                    f"{torch.equal(out[2], ref[2])}, stages equal "
                    f"{torch.equal(out[3], ref[3])}, max |dx| "
                    f"{float(ex.max()):.3g}, max |dlogp| "
                    f"{float(el.max()):.3g}")
            if nonfinite and int(out[3][5, 3]) == 1:
                raise AssertionError("B4 accepted a non-finite proposal")
            if outs and not all(torch.equal(a, b)
                                for a, b in zip(outs[0], out)):
                raise AssertionError(f"B4's routes differ at {label}")
            outs.append(out)
            errs[(n, d, K, kind, delayed)] = max(
                errs.get((n, d, K, kind, delayed), 0.0), float(ex.max()),
                float(el.max()))
    log(f"B4 fused_rw_chunk: same decisions as the plain version, x and "
        f"logp within tolerance, the routes bit-equal, in {len(cases) + 1} "
        f"cases; forced runs by route: {json.dumps(runs)}")
    if not all(runs.values()):
        raise AssertionError(f"a route of B4 was not forced: {runs}")

    def operands(n, d, K):
        lp = b4_target("gaussian", d)
        x0, dy1, dy2, scal = b4_operands(n, d, K, seed=99, dev=dev)
        return lp, x0, lp(x0), dy1, dy2, scal

    def timed(n, d, K):
        lp, x0, lp0, dy1, dy2, scal = operands(n, d, K)
        kernel = lambda: fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, True)
        plain = lambda: fused_rw_chunk_plain(x0, lp0, dy1, dy2, scal, lp,
                                             True)
        times = (device_ms(kernel), device_ms(plain, reps=20, warmup=3),
                 call_ms(kernel), call_ms(plain, reps=30, warmup=3))
        stage = kernel()[3]
        return (times, *b4_work(n, d, K, stage)), fused_rw_chunk.last_plan

    def in_turns(n, d, K, routes):
        """device ms of each route, in turns (a, b, b, a)"""
        lp, x0, lp0, dy1, dy2, scal = operands(n, d, K)
        run = lambda r: fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, True,
                                       route=r)
        order = [routes[0], routes[1], routes[1], routes[0]]
        ms = [device_ms(lambda r=r: run(r)) for r in order]
        return {r: [ms[i] for i, o in enumerate(order) if o == r]
                for r in routes}

    (times, n_bytes, n_ops), wide_plan = timed(256, 100, 50)
    wide = kernel_record("fused_rw_chunk", "", "", None, times, n_bytes,
                         n_ops)
    wide_turns = in_turns(256, 100, 50, ["throughput", "global"])
    log("B4 at the wide shape, device ms in turns (throughput, global, "
        "global, throughput):", json.dumps(wide_turns))
    large = {}
    for d in (240, 300):
        lp, x0, lp0, dy1, dy2, scal = operands(256, d, C1_K)
        kernel = lambda: fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, True)
        ms = device_ms(kernel, reps=50, warmup=5)
        n_bytes, n_ops = b4_work(256, d, C1_K, kernel()[3])
        large[f"d{d}"] = {"shape": f"K={C1_K} n=256 d={d}, DR, correlated "
                                   "Gaussian", "plan": fused_rw_chunk.last_plan,
                          "ms": ms, "bound_ms": bound_ms(n_bytes, n_ops)}
    log("B4 past the old limit:", json.dumps(large))
    def step_us(n, d, k_lo, k_hi):
        """µs a step: the slope of B4's device time from K = k_lo to
        k_hi (DR), and what is left at K = k_lo (launch and prologue)"""
        ms = {}
        for K in (k_lo, k_hi):
            lp, x0, lp0, dy1, dy2, scal = operands(n, d, K)
            ms[K] = device_ms(lambda: fused_rw_chunk(x0, lp0, dy1, dy2,
                                                     scal, lp, True))
        slope = (ms[k_hi] - ms[k_lo]) / (k_hi - k_lo)
        return {"us_a_step": slope * 1e3,
                f"fixed_ms_at_K{k_lo}": ms[k_lo] - k_lo * slope,
                "device_ms_by_K": ms}

    floor = launch_floor(dev)
    c1_slope, wide_slope = step_us(1, 2, C1_K, 4 * C1_K), step_us(256, 100,
                                                                   10, C1_K)
    log("B4's µs a step over K (config 1, the wide shape):",
        json.dumps([c1_slope, wide_slope]))
    (times, n_bytes, n_ops), c1_plan = timed(1, 2, C1_K)
    rec = kernel_record(
        "fused_rw_chunk", "bipymc_tpu_torch/csrc/fused_rw_chunk.cu",
        "bipymc_tpu/ops/fused_rw_chunk.py:148",
        errs[(1, 2, 50, "gaussian", True)], times, n_bytes, n_ops)
    rec["plan"] = c1_plan
    rec["us_a_step"] = rec["ms"] / C1_K * 1e3
    rec["step_slope"] = c1_slope
    rec["launch_floor_ms"] = floor["device_ms"]
    rec["launch_floor_call_ms"] = floor["call_ms"]
    rec["wide_shape"] = {k: wide[k] for k in (
        "ms", "plain_ms", "call_ms", "plain_call_ms", "bound_ms",
        "bound_by")}
    rec["wide_shape"]["shape"] = "K=50 n=256 d=100, DR, correlated Gaussian"
    rec["wide_shape"]["plan"] = wide_plan
    rec["wide_shape"]["max_abs_err"] = errs[(256, 100, 50, "gaussian", True)]
    rec["wide_shape"]["routes_in_turns_ms"] = wide_turns
    rec["wide_shape"]["step_slope"] = wide_slope
    rec.update(large)
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
              "launches": {"fused_rw_chunk": launches},
              "b4_plan": fused_rw_chunk.last_plan}
    log("config 1:", json.dumps(result))
    if not (np.all(np.abs(mean - np.array(C1_MEAN)) < 0.15)
            and np.all(np.abs(cov - np.array(C1_COV)) < 0.3)):
        raise AssertionError(f"config 1 posterior off the truth: mean "
                             f"{mean.tolist()}, cov {cov.tolist()}")
    wall_us, rows = busy_share(s, n_units=10, per_unit=C1_K, unit="chunk")
    b4_us = kernel_us(rows, 10, "fused_rw_chunk_kernel")
    log("config 1, B4:", json.dumps({"us_per_chunk": b4_us,
                                     "us_per_step": b4_us / C1_K}))

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


def b5_operands(c, n, m, k, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    A = 3.0 * torch.randn((c, n, k), generator=g, device=dev)
    B = 3.0 * torch.randn((c, m, k), generator=g, device=dev)
    return A, B


def check_b5(dev):
    from bipymc_tpu_torch.testing import config4_data
    from bipymc_tpu_torch.ops.pallas_kernels import sqdist, sqdist_plain

    # config 4: each chain's inputs scaled by its length-scales, centred
    x, _ = config4_data()
    g = torch.Generator(device=dev).manual_seed(5)
    ls = torch.exp(0.3 * torch.randn((C4_CHAINS, 1, 2), generator=g,
                                     device=dev))
    xs = torch.as_tensor(x, device=dev) / ls
    xs = xs - xs.mean(-2, keepdim=True)
    cases = [("config 4", xs, xs)]
    # m % 4 in {1, 2, 3} takes the scalar stores; k = 8 is the last
    # register instance, k = 9 the first staged in passes of 8
    for c, n, m, k in ((1, 130, 140, 5), (3, 17, 9, 4), (2, 1000, 200, 33),
                       (5, 64, 64, 1), (7, 33, 300, 2), (2, 70, 129, 2),
                       (3, 50, 130, 8), (1, 33, 131, 9), (2, 64, 256, 8),
                       (2, 100, 260, 9), (1, 257, 5, 3)):
        A, B = b5_operands(c, n, m, k, seed=n + m + k, dev=dev)
        cases.append((f"c={c} n={n} m={m} k={k}", A, B))
    A, B = b5_operands(1, 40, 50, 3, seed=1, dev=dev)
    cases.append(("unbatched [40, 3] x [50, 3]", A[0], B[0]))
    # config 5, unbatched as one param set calls it: the design against
    # itself (the Gram of each Adam step and of fit) and against a
    # 1,024-row θ batch (the surrogate, once a DREAM generation)
    a5, t5 = config5_b5_operands(dev)
    cases += [("config 5 [256, 2] x [256, 2]", a5, a5),
              ("config 5 [256, 2] x [1024, 2]", a5, t5)]
    A, B = b5_operands(2, 40, 50, 3, seed=2, dev=dev)
    A[1, 7, 0] = torch.nan
    cases.append(("a NaN input row", A, B))
    errs = {}
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
        errs[label] = err
    main_err = errs["config 4"]
    c5_err = {k: v for k, v in errs.items() if k.startswith("config 5")}
    log(f"B5 sqdist: within atol 1e-3 of the plain version in {len(cases)} "
        f"cases; config-4 max abs error {main_err:.3g}; config 5's "
        f"{json.dumps(c5_err)}")
    if not max(c5_err.values()) <= C5_GRAM_TOL:
        raise AssertionError(f"B5 on config 5's operands: {c5_err} (limit "
                             f"{C5_GRAM_TOL})")

    kernel = lambda: sqdist(xs, xs)
    plain = lambda: sqdist_plain(xs, xs)
    library = lambda: torch.cdist(xs, xs)
    times = (device_ms(kernel), device_ms(plain), call_ms(kernel),
             call_ms(plain))
    c, n, k = C4_CHAINS, C4_N, 2
    n_bytes = 4 * (2 * c * n * k + c * n * n)
    n_ops = c * n * n * (2 * k + 3) + 2 * c * 2 * n * k
    rec = kernel_record(
        "sqdist", "bipymc_tpu_torch/csrc/sqdist.cu",
        "bipymc_tpu/ops/pallas_kernels.py:73", main_err, times, n_bytes,
        n_ops, library_ms=device_ms(library))
    rec["config5_max_abs_err"] = c5_err
    # config 5's unbatched calls (one a generation, one an Adam step)
    rec["config5_ms"] = {label: device_ms(lambda: sqdist(A, B))
                         for label, A, B in cases
                         if label.startswith("config 5")}
    log("B5 at config 5's shapes, device ms:", json.dumps(rec["config5_ms"]))
    return rec


def config5_b5_operands(dev):
    """B5's operands on config 5's path, as ``pairwise_sqdist`` forms
    them: the design [256, 2] over length-scales about where ``optimize``
    ends (phase 8), centred on its mean, and 1,024 θ over the prior's
    region, U(−2.5, 2.5)², scaled and centred alike."""
    x, _ = config5_data()
    ls = torch.exp(torch.tensor(C5_LOG_LENGTHSCALE, device=dev))
    xs = torch.as_tensor(x, device=dev) / ls
    g = torch.Generator(device=dev).manual_seed(9)
    th = (5.0 * torch.rand((C5_CHAINS, 2), generator=g, device=dev)
          - 2.5) / ls
    mu = xs.mean(0)
    return xs - mu, th - mu


# about where phase 7's chains end (its posterior mean)
C4_THETA_END = (-0.18, 0.45, -0.26, -1.57)
GRAM_TOL = (1e-5, 1e-4)       # max|dL|/max|L|, max|dz|/max|z| per matrix


def config4_grams(dev):
    """Config 4's Gram matrices as phase 7 factors them:
    ``GpRegressor._gram`` (B5 inside) over the config-4 data at 64 θ spread
    from phase 7's start, 0, to where its chains end, each moved by
    N(0, 0.3²) per coordinate; and y [64, 512]."""
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.testing import config4_data

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


def worst_rel(u, v):
    """max |u − v| / max |v| per leading entry, the largest."""
    u, v = u.double().flatten(1), v.double().flatten(1)
    return float(((u - v).abs().amax(1) / v.abs().amax(1)).max())


def rel_errors(L, z, L_ref, z_ref):
    """:func:`worst_rel` of L and of z against their references."""
    return worst_rel(L, L_ref), worst_rel(z, z_ref)


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
    from bipymc_tpu_torch.testing import spd_batch
    from bipymc_tpu_torch.ops.pallas_bchol import (cholesky_batched,
                                                   cholesky_solve_batched,
                                                   cholesky_solve_plain)
    from bipymc_tpu_torch.ops.pallas_bchol import plan as b6_plan

    # config 4's shape (two CTAs a matrix), older edge shapes, the non-PD
    # batch (two CTAs), then the new design's edges: config 4's n at one
    # CTA a matrix (b = 200 fills the card) and at b = 1, a tile and one
    # either side of it, 512 and 1,024 either side of a block, up to
    # MAX_N
    cases = [(C4_CHAINS, C4_N, False), (3, 64, False), (5, 200, False),
             (12, 256, False), (8, 1000, False), (8, 128, True),
             (200, C4_N, False), (1, C4_N, False), (4, 1, False),
             (4, 31, False), (4, 33, False), (3, 511, False),
             (3, 513, False), (2, 1024, False), (2, 1600, False)]
    errs, plans = {}, {}
    for i, (b, n, non_pd) in enumerate(cases):
        a, y = spd_batch(b, n, seed=i, dev=dev)
        if non_pd:                     # matrices 2 and 5: indefinite
            a[2] -= 10.0 * torch.eye(n, device=dev)
            a[5, n // 2, n // 2] = -1.0
        L, z = cholesky_solve_batched(a, y)
        p_solve = cholesky_solve_batched.last_plan
        L_only = cholesky_batched(a)
        p_only = cholesky_solve_batched.last_plan
        L_ref, z_ref = cholesky_solve_plain(a, y)
        torch.cuda.synchronize()
        want = b6_plan(b, n)
        if not p_solve == p_only == want:
            raise AssertionError(f"B6 at b={b} n={n} launched {p_solve} and "
                                 f"{p_only}, its plan is {want}")
        plans[(b, n)] = want
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
    if {p.P for p in plans.values()} != {1, 2}:
        raise AssertionError(f"B6's cases did not run both P = 1 and P = 2: "
                             f"{plans}")
    log(f"B6 bchol: L within 5e-6·max|L| and z within 1e-5·max|z| of the "
        f"plain version, L bit-equal between its two entry points, NaN in "
        f"the same matrices, in {len(cases)} cases; each launch its plan "
        f"(P, smem):",
        json.dumps({f"{b}x{n}": list(p) for (b, n), p in plans.items()}))
    check_b6_gram(dev)

    a, y = spd_batch(C4_CHAINS, C4_N, seed=99, dev=dev)
    kernel = lambda: cholesky_solve_batched(a, y)
    plain = lambda: cholesky_solve_plain(a, y)
    # the one library call of the two: L alone, beside the kernel's L alone
    library = lambda: torch.linalg.cholesky_ex(a)
    t = timed_launches(kernel, 50, 5, key="bchol")
    times = (t[0], device_ms(plain, reps=50, warmup=5),
             call_ms(kernel, reps=100, warmup=5),
             call_ms(plain, reps=100, warmup=5))
    library_ms = device_ms(library, reps=50, warmup=5)
    l_alone = timed_launches(lambda: cholesky_batched(a), 50, 5, key="bchol")
    log(f"B6 at config 4, device ms a launch over the launches the profiler "
        f"recorded: L and z {t[0]:.6f} ({t[1]} of 50), L alone "
        f"{l_alone[0]:.6f} ({l_alone[1]} of 50); "
        f"torch.linalg.cholesky_ex {library_ms:.6f}")
    b, n = C4_CHAINS, C4_N
    n_bytes = 4 * (2 * b * n * n + 2 * b * n)   # a in, L out, y in, z out
    n_ops = b * (n ** 3 // 3 + n * n)           # factor + forward solve
    rec = kernel_record(
        "bchol", "bipymc_tpu_torch/csrc/bchol.cu",
        "bipymc_tpu/ops/pallas_bchol.py:274", errs[(b, n)], times, n_bytes,
        n_ops, library_ms=library_ms)
    rec.update(recorded=t[1], l_alone_ms=l_alone[0],
               plan=list(plans[(b, n)]))
    return rec


# ---------------------------------------------------------------- phase 7
C4_STEPS = 2000


def np_log_ml(theta, x, y, normalize_y=False):
    """The GP log-ML in float64 NumPy at θ = (log ℓ₀, log ℓ₁, log σ_f,
    log σ_n) (``benchmarks/run_all.py:329-340``, with the port's jitter
    floor 4·n·ε_f32·σ_f² for its 1e-5·σ_f²); with ``normalize_y`` the
    targets standardised and −n log y_std added, as ``_lml_impl`` does."""
    x64, y64, t = (np.asarray(v, np.float64) for v in (x, y, theta))
    n = len(y64)
    y_std = y64.std() if normalize_y else 1.0
    if normalize_y:
        y64 = (y64 - y64.mean()) / y_std
    ls, sf2, sn2 = np.exp(t[0:2]), np.exp(2.0 * t[2]), np.exp(2.0 * t[3])
    sq = ((x64[:, None, :] - x64[None, :, :]) / ls) ** 2
    jitter = 4 * n * float(np.finfo(np.float32).eps)
    kmat = sf2 * np.exp(-0.5 * sq.sum(-1)) + (sn2 + jitter * sf2) * np.eye(n)
    L = np.linalg.cholesky(kmat)
    v = np.linalg.solve(L, y64)
    return (-0.5 * v @ v - np.sum(np.log(np.diag(L)))
            - 0.5 * n * np.log(2.0 * np.pi) - n * np.log(y_std))


def config4_path(dev):
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.testing import config4_data
    from bipymc_tpu_torch.ops.pallas_bchol import cholesky_solve_batched
    from bipymc_tpu_torch.ops.pallas_kernels import sqdist

    x, y = config4_data()
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    gp = bt.GpRegressor(device=dev)

    def params(theta):
        return {"log_lengthscale": theta[:, 0:2], "log_sigma_f": theta[:, 2],
                "log_sigma_n": theta[:, 3]}

    # config 4's target, as benchmarks/run_all.py:305-307 writes it:
    # _lml_impl, whose batch goes to B6 (the public log-ML is grad-safe)
    def log_post(theta):
        return (gp._lml_impl(params(theta), xt, yt)
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
    lml = gp._lml_impl(params(final.theta), xt, yt).cpu()
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
    _, rows = busy_share(s, n_units=50, per_unit=1, unit="step")
    log("config 4: B5 µs a step:", kernel_us(rows, 50, "sqdist_kernel"))
    b6 = [(us, count) for key, (us, count) in rows.items()
          if "(anonymous namespace)::bchol_kernel(" in key]
    if not b6 or sum(c for _, c in b6) == 0:
        raise AssertionError("config 4: the profile holds no B6 launch")
    b6_ms = sum(us for us, _ in b6) / sum(c for _, c in b6) / 1e3
    log(f"config 4: B6 device ms a launch inside the step (over the "
        f"{sum(c for _, c in b6)} launches the profiler recorded in 50 "
        f"steps): {b6_ms:.6f}")
    return launches, b6_ms


# ---------------------------------------------------------------- phase 2d
C5_CHAINS, C5_CAPACITY, C5_N, C5_STEPS = 1024, 32768, 256, 300
C5_TRUE = (1.2, -0.7)
C5_TRAJECTORY = (0, 10, 30, 100, 300)   # Adam steps of the Gram check
C5_LOG_LENGTHSCALE = (0.23, 0.35)       # about where optimize ends
# max|dg|/max|g| between B5's gradient and the plain version's autograd
# on config 5's operands; the first card readings 6.7e-8 ([256] x [256])
# and 9.5e-8 ([256] x [1024])
B5_GRAD_TOL = 1e-6
# max|dL|/max|L| on config 5's Gram matrices; the first card readings:
# kernel vs float64 4.5e-5, plain vs float64 6.5e-5, kernel vs plain 8.2e-5
C5_GRAM_TOL = 2e-4


def config5_data():
    """Config 5's design and scores, as ``benchmarks/run_all.py:439-452``
    makes them: 256 θ in U(−2, 2)², the Gaussian log-likelihood of an
    8-point forward model at each."""
    rng = np.random.default_rng(11)
    t_grid = np.linspace(0, 1, 8)
    true = np.array(C5_TRUE, dtype=np.float32)

    def fwd(th):
        return th[0] * np.exp(-2 * t_grid) + th[1] * t_grid ** 2

    y_obs = fwd(true) + rng.normal(0, 0.05, 8)
    design = rng.uniform(-2, 2, (C5_N, 2)).astype(np.float32)
    scores = np.array([
        -0.5 * float((fwd(t) - y_obs) @ (fwd(t) - y_obs)) / 0.05 ** 2
        for t in design], dtype=np.float32)
    return design, scores


def config5_grams(dev):
    """Config 5's Gram matrices along ``optimize``'s trajectory: the
    params after each of ``C5_TRAJECTORY`` Adam steps (library route), and
    ``GpRegressor._gram`` there, [5, 256, 256], with the standardised
    scores."""
    import bipymc_tpu_torch as bt

    x, y = config5_data()
    gp = bt.GpRegressor(normalize_y=True, device=dev)
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    grams = []
    for steps in C5_TRAJECTORY:
        p = (bt.gp.default_params(2, device=dev) if steps == 0 else
             gp.optimize(x, y, steps=steps)[0])
        grams.append(gp._gram(p, xt))
    return torch.stack(grams), gp._normalize(yt)[0]


def check_b5_grad(dev):
    """B5's gradient on config 5's operands against autograd through the
    plain version: d/dA and d/dB of sum(w ⊙ sqdist(A, B)), w fixed and
    random, with A = B the design (the Gram of each Adam step, both
    arguments one leaf as in ``pairwise_sqdist``) and at [256, 2] x
    [1024, 2]. The kernel's route must launch B5."""
    from bipymc_tpu_torch.ops.pallas_kernels import sqdist, sqdist_plain

    a5, t5 = config5_b5_operands(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    readings = {}
    for label, B in (("[256, 2] x [256, 2]", None),
                     ("[256, 2] x [1024, 2]", t5)):
        w = torch.randn((C5_N, C5_N if B is None else B.shape[0]),
                        generator=g, device=dev)
        grads = []
        for f in (sqdist, sqdist_plain):
            a = a5.clone().requires_grad_(True)
            b = a if B is None else B.clone().requires_grad_(True)
            before = sqdist.launches
            torch.sum(w * f(a, b)).backward()
            if (sqdist.launches > before) != (f is sqdist):
                raise AssertionError(f"B5's route at {label} launched "
                                     f"{sqdist.launches - before} times")
            grads.append(torch.cat([a.grad.flatten()] + (
                [] if B is None else [b.grad.flatten()])))
        readings[label] = worst_rel(grads[0][None], grads[1][None])
    log("B5 gradient on config 5's operands, max|dg|/max|g| against the "
        "plain version's autograd:", json.dumps(readings))
    if not max(readings.values()) <= B5_GRAD_TOL:
        raise AssertionError(f"B5's gradient differs from the plain "
                             f"route's: {readings} (limit {B5_GRAD_TOL})")
    return readings


def check_b7(dev):
    from bipymc_tpu_torch.testing import spd_batch
    from bipymc_tpu_torch.ops.pallas_bchol import cholesky_batched
    from bipymc_tpu_torch.ops.pallas_chol import (CLUSTER_MAX_N, _chol_kernel,
                                                  cholesky_pallas,
                                                  cholesky_plain, plan)

    # SPD cases (x xᵀ/24 + 3I): one matrix at config 5's n and at edges
    # (a tile, one past it, the cluster route's last n and the cooperative
    # route's first), batches of several clusters, and a batch with two
    # indefinite matrices
    cases = [(None, C5_N), (None, 4), (None, 33), (None, 200), (None, 1000),
             (5, 130), (3, 256), (None, 1), (None, 31), (None, 32),
             (None, 255), (None, 257), (None, 480), (None, 481),
             (None, 512), (None, 1024), (4, 256)]
    errs = {}
    for i, (b, n) in enumerate(cases):
        a, _ = spd_batch(b or 1, n, seed=40 + i, dev=dev)
        a = a if b else a[0]
        L, ref = cholesky_pallas(a), cholesky_plain(a)
        torch.cuda.synchronize()
        e = float((L - ref).abs().max())
        s = float(ref.abs().max())
        if not (e <= 5e-6 * s and bool(torch.all(torch.triu(L, 1) == 0))):
            raise AssertionError(f"B7 differs from its plain version at "
                                 f"b={b} n={n}: max |dL| {e:.3g} (bound "
                                 f"{5e-6 * s:.3g})")
        errs[(b, n)] = e
    a, _ = spd_batch(6, 128, seed=7, dev=dev)
    a[1] -= 10.0 * torch.eye(128, device=dev)
    a[4, 64, 64] = -1.0
    L = cholesky_pallas(a)
    bad = torch.isnan(L).flatten(1).all(1).tolist()
    if bad != [j in (1, 4) for j in range(6)] or not bool(
            torch.isfinite(L[[0, 2, 3, 5]]).all()):
        raise AssertionError(f"B7: NaN matrices {bad}, want 1 and 4")
    log(f"B7 chol: L within 5e-6·max|L| of the plain version in "
        f"{len(cases)} cases, NaN in exactly the indefinite matrices")

    # config 5's Gram matrices along the optimize trajectory, both float32
    # routes against a float64 factor of the same float32 matrices
    a, _ = config5_grams(dev)
    L, L_p = cholesky_pallas(a), cholesky_plain(a)
    L64 = torch.linalg.cholesky(a.double())
    cond = torch.linalg.cond(a.double()).cpu().numpy()
    k, p, d = worst_rel(L, L64), worst_rel(L_p, L64), worst_rel(L, L_p)
    readings = {"steps": list(C5_TRAJECTORY), "cond": cond.tolist(),
                "kernel_vs_f64": k, "plain_vs_f64": p, "kernel_vs_plain": d}
    log("B7 on config-5 Gram matrices, the worst max|dL|/max|L|:",
        json.dumps(readings))
    # each float32 route stands ~cond·ε from the float64 factor (cond up
    # to 8.3e5 at the trajectory's end): the kernel no further than 1.5 x
    # the plain version, and within C5_GRAM_TOL of float64 and of it
    if not (k <= 1.5 * p + 1e-7 and max(k, d) <= C5_GRAM_TOL):
        raise AssertionError(f"B7 on config-5 Gram matrices is off: "
                             f"{readings}, limits 1.5 x the plain version's "
                             f"distance from float64, {C5_GRAM_TOL} from "
                             f"it and from the plain version")

    # gradients through both routes: a GP-shaped loss of the Gram matrix
    g = a[-1].clone().requires_grad_(True)
    w = torch.randn(C5_N, C5_N, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    torch.sum(w * cholesky_pallas(g)).backward()
    gk = g.grad.clone()
    g.grad = None
    torch.sum(w * cholesky_plain(g)).backward()
    eg = worst_rel(gk[None], g.grad[None])
    log(f"B7 gradient at config 5's last Gram matrix: max|dA|/max|A| "
        f"{eg:.3g} between the routes")
    if not eg <= 1e-3:
        raise AssertionError(f"B7's gradient differs from the plain "
                             f"route's by {eg:.3g} (limit 1e-3)")

    a1 = a[-1].contiguous()
    kernel = lambda: cholesky_pallas(a1)
    plain = lambda: cholesky_plain(a1)
    library = lambda: torch.linalg.cholesky_ex(a1)
    times = (device_ms(kernel), device_ms(plain), call_ms(kernel),
             call_ms(plain))
    b6_ms = device_ms(lambda: cholesky_batched(a1[None]))
    log(f"B7 against B6's kernel on the same one matrix (b = 1), device "
        f"ms: B7 {times[0]:.6f}, B6 {b6_ms:.6f}")
    # the two routes on the same matrix in turns (cluster, cooperative,
    # cooperative, cluster), device ms
    coop = lambda: _chol_kernel(a1[None], "cooperative")
    turns = [device_ms(f) for f in (kernel, coop, coop, kernel)]
    log("B7 at [256, 256] in turns, device ms (cluster, cooperative, "
        "cooperative, cluster):", json.dumps(turns))
    n = C5_N
    p = plan(n)
    rec = kernel_record(
        "chol", "bipymc_tpu_torch/csrc/chol.cu",
        "bipymc_tpu/ops/pallas_chol.py:188", errs[(None, C5_N)], times,
        4 * 2 * n * n, n ** 3 // 3, library_ms=device_ms(library))
    rec["design"] = (f"{p.route}: one cluster of {p.cluster} CTAs a "
                     f"matrix, the factor in shared memory "
                     f"({p.smem} B a CTA), one cluster barrier a panel "
                     f"step; csrc/chol_coop.cu (cooperative, grid barrier "
                     f"in global memory) above n = {CLUSTER_MAX_N}")
    rec["turns_ms"] = {"cluster": [turns[0], turns[3]],
                       "cooperative": [turns[1], turns[2]]}
    rec["b6_one_matrix_ms"] = b6_ms
    rec["gram_readings"] = readings
    return rec


def check_b8(dev):
    from bipymc_tpu_torch.testing import spd_batch
    from bipymc_tpu_torch.ops.pallas_chol import cholesky_plain
    from bipymc_tpu_torch.ops.pallas_solve import (plan, solve_chol,
                                                   tri_solve,
                                                   tri_solve_plain,
                                                   tri_solve_t,
                                                   tri_solve_t_plain)

    g = torch.Generator(device=dev).manual_seed(8)

    def rhs(*shape):
        return torch.randn(shape, device=dev, generator=g)

    def factor(b, n, seed):
        a, _ = spd_batch(b or 1, n, seed=seed, dev=dev)
        L = cholesky_plain(a)
        return L if b else L[0]

    # (L batch, n, right-hand side shape): config 5's [256] and
    # [256, 1024], n not a multiple of 32, m a partial tile of 8 columns,
    # the batched and the shared-L forms
    cases = [(None, C5_N, (C5_N,)), (None, C5_N, (C5_N, C5_CHAINS)),
             (None, 4, (4,)), (None, 4, (4, 9)), (None, 200, (200, 9)),
             (None, 200, (200, 130)), (None, 1000, (1000,)),
             (None, 1000, (1000, 17)), (3, 96, (3, 96)),
             (3, 96, (3, 96, 5)), (None, 70, (4, 70, 3))]
    # n at a tile's edges, at the last n whose tiles all fit in shared
    # memory (256) and past it, and at the largest; m at the columns a
    # block takes (1..8) and past them; then a batched L and a shared L
    for n in (1, 31, 32, 33, 255, 256, 257, 1024, 4096):
        cases += [(None, n, (n,)), (None, n, (n, 7)), (None, n, (n, 8)),
                  (None, n, (n, 9))]
    for m in (1, 7, 8, 9):
        cases += [(3, C5_N, (3, C5_N, m)), (None, C5_N, (4, C5_N, m))]
    cases.append((3, C5_N, (3, C5_N)))
    errs = {}
    for i, (b, n, shape) in enumerate(cases):
        L, y = factor(b, n, seed=60 + i), rhs(*shape)
        for fn, ref_fn in ((tri_solve, tri_solve_plain),
                           (tri_solve_t, tri_solve_t_plain)):
            out, ref = fn(L, y), ref_fn(L, y)
            torch.cuda.synchronize()
            e = float((out - ref).abs().max())
            if not (out.shape == ref.shape and bool(
                    torch.isfinite(out).all()) and
                    e <= 1e-5 * float(ref.abs().max())):
                raise AssertionError(
                    f"B8 {fn.__name__} differs from its plain version at "
                    f"L batch {b}, n={n}, b {shape}: max |dx| {e:.3g}")
            errs[(b, n, shape, fn.__name__)] = e
    log(f"B8 trisolve: within 1e-5·max|x| of the plain version in "
        f"{2 * len(cases)} cases, every column of the partial tiles written")

    # on config 5's factors along the trajectory, against float64
    a, yn = config5_grams(dev)
    L = cholesky_plain(a)
    y = yn.expand(len(C5_TRAJECTORY), C5_N).contiguous()
    x64 = torch.linalg.solve_triangular(L.double(), y.double()[..., None],
                                        upper=False)[..., 0]
    k, p = worst_rel(tri_solve(L, y), x64), worst_rel(
        tri_solve_plain(L, y), x64)
    t64 = torch.linalg.solve_triangular(L.double().transpose(-1, -2),
                                        y.double()[..., None],
                                        upper=True)[..., 0]
    kt, pt = worst_rel(tri_solve_t(L, y), t64), worst_rel(
        tri_solve_t_plain(L, y), t64)
    readings = {"tri_solve": [k, p], "tri_solve_t": [kt, pt]}
    log("B8 on config-5 factors, the worst max|dx|/max|x| against float64 "
        "(kernel, plain):", json.dumps(readings))
    if not (k <= 1.5 * p + 1e-6 and kt <= 1.5 * pt + 1e-6):
        raise AssertionError(f"B8 on config-5 factors is off: {readings}")

    # gradients through both routes, and each backward launching the
    # other direction's kernel
    L1 = factor(None, 200, seed=5).requires_grad_(True)
    b1 = rhs(200, 7).requires_grad_(True)
    w = rhs(200, 7)
    grads = {}
    for route, fn in (("kernel", solve_chol), ("plain", lambda l, v:
                                               tri_solve_t_plain(
                                                   l, tri_solve_plain(l, v)))):
        before = tri_solve.launches
        torch.sum(w * fn(L1, b1) ** 2).backward()
        if route == "kernel" and tri_solve.launches - before != 4:
            raise AssertionError(f"solve_chol forward and backward launched "
                                 f"B8 {tri_solve.launches - before} times, "
                                 f"not 4")
        grads[route] = (L1.grad.clone(), b1.grad.clone())
        L1.grad = b1.grad = None
    el = worst_rel(torch.tril(grads["kernel"][0])[None],
                   torch.tril(grads["plain"][0])[None])
    eb = worst_rel(grads["kernel"][1][None], grads["plain"][1][None])
    log(f"B8 gradients (solve_chol, n=200, m=7): max|dL̄|/max|L̄| {el:.3g}, "
        f"max|db̄|/max|b̄| {eb:.3g} between the routes")
    if not (el <= 1e-4 and eb <= 1e-4):
        raise AssertionError(f"B8's gradients differ from the plain route's: "
                             f"{el:.3g}, {eb:.3g} (limit 1e-4)")

    Lc = L[-1].contiguous()
    n, m = C5_N, C5_CHAINS

    def timed(y):
        kernel = lambda: tri_solve(Lc, y)
        plain = lambda: tri_solve_plain(Lc, y)
        mm = 1 if y.dim() == 1 else y.shape[-1]
        times = (device_ms(kernel), device_ms(plain), call_ms(kernel),
                 call_ms(plain))
        n_bytes = 4 * (n * n + 2 * n * mm)
        n_ops = n * n * mm                   # n²/2 FMAs a column
        return times, n_bytes, n_ops, device_ms(plain)

    times, n_bytes, n_ops, lib = timed(yn.contiguous())
    rec = kernel_record("trisolve", "bipymc_tpu_torch/csrc/trisolve.cu",
                        "bipymc_tpu/ops/pallas_solve.py:181",
                        errs[(None, C5_N, (C5_N,), "tri_solve")], times,
                        n_bytes, n_ops, library_ms=lib)
    ks = rhs(n, m)
    times, n_bytes, n_ops, lib = timed(ks)
    wide = kernel_record("trisolve", "", "", None, times, n_bytes, n_ops,
                         library_ms=lib)
    rec["lcb_shape"] = {k_: wide[k_] for k_ in (
        "ms", "plain_ms", "call_ms", "plain_call_ms", "bound_ms",
        "bound_by", "library_ms")}
    rec["lcb_shape"]["shape"] = "L [256, 256], b [256, 1024]"
    rec["lcb_shape"]["max_abs_err"] = errs[(None, C5_N, (C5_N, m),
                                            "tri_solve")]
    rec["f64_readings"] = readings
    p1, pw = plan(n, 1), plan(n, m)
    rec["design"] = (f"L's {p1.ring} off-diagonal tiles copied into shared "
                     f"memory (cp.async, an mbarrier a tile) at the start, "
                     f"the diagonal blocks inverted up front, x_i = D⁻¹r_i "
                     f"plus one refinement step; {p1.cols} column a block "
                     f"at b [256] ({p1.smem} B), {pw.cols} a block, "
                     f"{pw.blocks} blocks at [256, 1024]")
    return rec


# ---------------------------------------------------------------- phase 8
def config5_path(dev):
    """BASELINE config 5 at full width, as ``benchmarks/run_all.py:437-482``
    runs it, with the kernel flags on."""
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.distinct_idx import distinct_idx
    from bipymc_tpu_torch.ops.dream_proposal import dream_propose
    from bipymc_tpu_torch.ops.pallas_bchol import cholesky_solve_batched
    from bipymc_tpu_torch.ops.pallas_chol import cholesky_pallas
    from bipymc_tpu_torch.ops.pallas_kernels import sqdist
    from bipymc_tpu_torch.ops.pallas_solve import tri_solve

    x, y = config5_data()
    gp = bt.GpRegressor(normalize_y=True, pallas_chol=True, pallas_solve=True,
                        device=dev)
    counters = (sqdist, cholesky_pallas, tri_solve, cholesky_solve_batched,
                distinct_idx, dream_propose)
    names = ("sqdist", "chol", "trisolve", "bchol", "distinct_idx",
             "dream_propose")

    def counts():
        return dict(zip(names, (c.launches for c in counters)))

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, lml = gp.optimize(x, y, steps=C5_STEPS, lr=0.05)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    after_opt = counts()
    fit = gp.fit(x, y, params=params)
    sur = gp.surrogate_log_like(fit)

    def log_post(th):
        return sur(th) - 0.5 * torch.sum((th / 2.0) ** 4, dim=-1)

    s = bt.DreamZs(log_post, n_chains=C5_CHAINS, seed=0, device=dev)
    kw = dict(rhat_tol=1.1, chunk=100, max_chunks=100, spread=1.0)
    t0 = time.perf_counter()
    warm = s.run_mcmc_until(torch.zeros(2), **kw)
    warm_s = time.perf_counter() - t0
    s.reset()
    t0 = time.perf_counter()
    info = s.run_mcmc_until(torch.zeros(2), **kw)
    wall = time.perf_counter() - t0
    launches = counts()
    gens = int(warm["steps"]) + int(info["steps"])
    # optimize: a step factors once (B7), solves forward once and, in its
    # backward, once transposed (B8), and builds one Gram (B5); the final
    # log-ML once more each but the backward; fit one factor, two solves,
    # one Gram; then each run_mcmc_until one B5 at the start and one a
    # generation, and one B2 and one B3 a generation
    want = {"chol": C5_STEPS + 2, "trisolve": 2 * C5_STEPS + 3,
            "sqdist": C5_STEPS + 2 + 2 + gens, "bchol": 0,
            "distinct_idx": gens, "dream_propose": gens}
    want_opt = {"chol": C5_STEPS + 1, "trisolve": 2 * C5_STEPS + 1,
                "sqdist": C5_STEPS + 1}
    if launches != want or any(after_opt[k] != v
                               for k, v in want_opt.items()):
        raise AssertionError(f"config 5 launches {launches} (after "
                             f"optimize {after_opt}), want {want} (after "
                             f"optimize {want_opt})")

    final = s.final_state
    theta = np.concatenate([params[k].cpu().numpy().reshape(-1) for k in (
        "log_lengthscale", "log_sigma_f", "log_sigma_n")])
    ref = np_log_ml(theta, x, y, normalize_y=True)
    rel = abs(float(lml) - ref) / abs(ref)
    # the same optimize on the CPU, the port's plain versions
    cpu_p, cpu_l = bt.GpRegressor(normalize_y=True, pallas_chol=True,
                                  pallas_solve=True, device="cpu").optimize(
        x, y, steps=C5_STEPS, lr=0.05)
    dp = max(float((params[k].cpu() - cpu_p[k]).abs().max()) for k in params)
    mean = info["mean"].mean(0)
    err = float(np.abs(mean - np.array(C5_TRUE)).max())

    # optimize with the library route (cholesky_ex, solve_triangular;
    # B5 still builds the Gram), between two more runs with the kernels
    lib = bt.GpRegressor(normalize_y=True, device=dev)

    def opt_wall(g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.optimize(x, y, steps=C5_STEPS, lr=0.05)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {"kernels_first_s": opt_s, "library_s": opt_wall(lib),
             "kernels_again_s": opt_wall(gp)}
    result = {
        "optimize": walls, "lml": float(lml), "lml_f64": ref,
        "lml_rel_err": rel, "params": {k: v.cpu().tolist()
                                       for k, v in params.items()},
        "params_max_abs_diff_vs_cpu": dp, "lml_cpu": float(cpu_l),
        "rhat_gens": int(info["steps"]), "wall_to_rhat_s": wall,
        "warm_call_s": warm_s, "warm_gens": int(warm["steps"]),
        "final_rhat": float(np.max(info["rhat"])),
        "posterior_mean": mean.tolist(), "posterior_mean_abs_err": err,
        "launches": launches}
    log("config 5:", json.dumps(result))
    if not bool(torch.all(torch.isfinite(final.logp))):
        raise AssertionError("config 5: a final logp is not finite")
    if not (math.isfinite(float(lml)) and rel < 1e-4):
        raise AssertionError(f"config 5: the optimised log-ML {float(lml)} "
                             f"is off the float64 one {ref} (rel {rel:.3g})")
    if not dp <= 1e-2:
        raise AssertionError(f"config 5: the card's optimised params differ "
                             f"from the CPU's by {dp:.3g} (limit 1e-2)")
    if not err < 0.1:
        raise AssertionError(f"config 5: posterior mean {mean.tolist()} is "
                             f"off the truth {C5_TRUE}")

    # the device's share of an Adam step and of a DREAM generation
    p0 = bt.gp.default_params(2, device=dev)
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    adam = lambda: gp._adam(xt, yt, p0, 20, 0.05)
    adam()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adam()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / 20 * 1e6
    rows = device_times(adam, 1)
    busy_us = sum(us for us, _ in rows.values()) / 20

    log("device, Adam step:", json.dumps({
        "wall_us_per_step": wall_us, "busy_us_per_step": busy_us,
        "busy_share": busy_us / wall_us,
        "kernels_per_step": sum(c for _, c in rows.values()) / 20,
        "b5_us_per_step": kernel_us(rows, 20, "sqdist_kernel"),
        "b7_us_per_step": kernel_us(rows, 20, "chol_kernel",
                                    "chol_coop_kernel"),
        "b8_us_per_step": kernel_us(rows, 20, "trisolve_kernel")}))
    for key, (us, count) in sorted(rows.items(),
                                   key=lambda r: -r[1][0])[:12]:
        log(f"  {us / 20:8.3f} us/step {count / 20:6.1f}/step  {key[:100]}")
    log("host, Adam step, self CPU µs a step by operator:")
    for us, count, key in host_times(adam):
        log(f"  {us / 20:8.1f} us/step {count / 20:6.1f}/step  {key[:80]}")
    busy_share(s, n_units=200)
    log("host, DREAM generation, self CPU µs a generation by operator:")
    for us, count, key in host_times(lambda: s.run_mcmc(50)):
        log(f"  {us / 50:8.1f} us/gen {count / 50:6.1f}/gen  {key[:80]}")

    # the lcb arm: 200 generations, B8 once a generation (and at the start)
    sur_lcb = gp.surrogate_log_like(fit, kind="lcb")
    s2 = bt.DreamZs(lambda th: sur_lcb(th) - 0.5 * torch.sum(
        (th / 2.0) ** 4, dim=-1), n_chains=C5_CHAINS, seed=0, device=dev)
    tri_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s2.run_mcmc(200, torch.zeros(2))
    torch.cuda.synchronize()
    lcb_s = time.perf_counter() - t0
    lcb = {"gens_per_sec": 200 / lcb_s, "trisolve_launches":
           tri_solve.launches, "acceptance": float(np.mean(
               s2.acceptance_fraction)),
           "mean_last_100": s2.get_chain(discard=100, flat=True).mean(
               0).tolist()}
    log("config 5, lcb:", json.dumps(lcb))
    if tri_solve.launches != 201 or not bool(
            torch.all(torch.isfinite(s2.final_state.logp))):
        raise AssertionError(f"config 5 lcb: B8 launched "
                             f"{tri_solve.launches} times in 200 "
                             f"generations (want 201), or a logp is not "
                             f"finite")
    return launches


# ---------------------------------------------------------------- phase 9
def stretch_run(s, x0, n_gens, want_launches):
    """A first run of ``n_gens`` from x0 and a timed continuation of as
    many; B9 must launch ``want_launches`` times in each. Returns the
    timed run's seconds and the two runs' launches."""
    from bipymc_tpu_torch.ops.fused_stretch import fused_stretch

    launches = []
    for start in (x0, None):
        fused_stretch.launches = 0
        t0 = time.perf_counter()
        s.run_mcmc(n_gens, start)
        elapsed = time.perf_counter() - t0
        launches.append(fused_stretch.launches)
    if launches != [want_launches] * 2:
        raise AssertionError(f"stretch: B9 launched {launches} times in two "
                             f"runs of {n_gens}, want {want_launches} each")
    return elapsed, launches


def stretch_rates(s, n_gens, elapsed):
    """gens/s, ESS and ESS/s of the timed run (its last 2,000 generations)
    and its acceptance."""
    import bipymc_tpu_torch as bt

    chains = s.get_chain(discard=s.super_chain.shape[1] - n_gens)
    gens_per_sec = n_gens / elapsed
    ess, ess_per_sec = bt.ess_rate(chains, gens_per_sec)
    acc = float(np.mean(s._history["accepted"][-n_gens:]))
    return chains, {"gens_per_sec": gens_per_sec, "ess_window": ess,
                    "ess_per_sec": ess_per_sec, "acceptance": acc,
                    "timed_s": elapsed}


def stretch_path(dev):
    """The stretch workload through ``EnsembleSampler``: fused (B9, 64
    generations a launch), then the per-generation engine from the same
    start and seed, their decisions held together, the posterior held to
    the truth, a chunk's profile, and the R̂ stop on both engines."""
    import bipymc_tpu_torch as bt
    from bipymc_tpu_torch.ops.fused_stretch import fused_stretch
    from bipymc_tpu_torch.samplers.stretch_fused import chunk_words
    from bipymc_tpu_torch.testing import (match_stretch_decisions,
                                          stretch_log_alpha)

    lp, scales, x0 = stretch_setup()
    per_run = -(-ST_GENS // ST_G)                  # 312 chunks of 64 + 32
    s = bt.EnsembleSampler(lp, n_chains=ST_N, seed=SEED, fused=True,
                           device=dev)
    elapsed, launches = stretch_run(s, x0, ST_GENS, per_run)
    chains, fused_res = stretch_rates(s, ST_GENS, elapsed)
    if chains.shape != (ST_N, ST_GENS, ST_D) or \
            not np.all(np.isfinite(chains)) or \
            not bool(torch.all(torch.isfinite(s.final_state.logp))):
        raise AssertionError(f"stretch history {chains.shape}, or a value "
                             "or final logp is not finite")
    # the posterior against the truth over the timed run: each mean within
    # 5 SE of 0 (SE from ess_rate's ESS over the whole run), each variance
    # within 10 % of scale²
    flat = chains.astype(np.float64)
    ess_run, _ = bt.ess_rate(chains, 1.0, window=ST_GENS)
    se = np.sqrt(flat.var(axis=(0, 1)) / ess_run)
    mean_z = np.abs(flat.mean(axis=(0, 1))) / se
    var_rel = flat.var(axis=(0, 1)) / scales ** 2 - 1.0
    del flat
    fused_res.update(ess_run=ess_run, max_mean_over_se=float(mean_z.max()),
                     max_abs_var_rel_err=float(np.abs(var_rel).max()),
                     launches=launches)
    log("stretch fused:", json.dumps(fused_res))
    if mean_z.max() > 5.0 or np.abs(var_rel).max() > 0.1 or \
            not 0.1 < fused_res["acceptance"] < 0.9:
        raise AssertionError(
            f"stretch posterior: max |mean|/SE {mean_z.max():.3g}, max "
            f"|var/scale² - 1| {np.abs(var_rel).max():.3g}, acceptance "
            f"{fused_res['acceptance']:.3g}")

    # the per-generation engine from the same start and seed: the fused
    # run's decisions over its first ST_PERGEN generations, a bit excused
    # only at the per-generation engine's own near tie
    p = bt.EnsembleSampler(lp, n_chains=ST_N, seed=SEED, device=dev)
    fused_stretch.launches = 0
    t0 = time.perf_counter()
    p.run_mcmc(ST_PERGEN, x0)
    p_elapsed = time.perf_counter() - t0
    if fused_stretch.launches:
        raise AssertionError("the per-generation engine launched B9")
    _, pergen_res = stretch_rates(p, ST_PERGEN, p_elapsed)
    xt = torch.from_numpy(x0).to(dev)
    ops = chunk_words(p._words, 0, ST_PERGEN, ST_N, ST_D, p.cfg.a,
                      torch.float32, dev)
    margin = (ops[2] - stretch_log_alpha(xt, lp(xt), *ops, lp)).abs()
    acc_f = torch.from_numpy(s._history["accepted"][:ST_PERGEN])
    acc_p = torch.from_numpy(p._history["accepted"])
    kept, excused = match_stretch_decisions(acc_f, acc_p, margin.cpu())
    n_same = int(kept[:, 0].sum())
    dx = np.abs(s._history["x"][:n_same] - p._history["x"][:n_same]).max()
    pergen_res.update(generations_compared=n_same, excused_bits=excused,
                      max_abs_dx_vs_fused=float(dx))
    log("stretch per generation:", json.dumps(pergen_res))
    if dx > 0.0:
        raise AssertionError(f"per-generation and fused positions differ "
                             f"before any decision did: {dx:.3g}")
    log("stretch engines, per generation vs fused:", json.dumps(
        {k: [pergen_res[k], fused_res[k]]
         for k in ("gens_per_sec", "ess_per_sec", "acceptance")}))

    busy_share(p, n_units=100)
    _, rows = busy_share(s, n_units=20, per_unit=ST_G, unit="chunk")
    log("stretch fused: B9 µs a chunk:",
        kernel_us(rows, 20, "fused_stretch_kernel"))

    # the R̂ stop on both engines: warm call, reset(), timed call; B9 two
    # launches a 100-generation chunk on the fused engine (64 + 36)
    stops = {}
    for name, smp in (("per_generation", p), ("fused", s)):
        fused_stretch.launches = 0
        warm = smp.reset().run_mcmc_until(x0, rhat_tol=1.1)
        smp.reset()
        t0 = time.perf_counter()
        info = smp.run_mcmc_until(x0, rhat_tol=1.1)
        wall = time.perf_counter() - t0
        n_chunks = (int(warm["steps"]) + int(info["steps"])) // 100
        want = 2 * n_chunks if name == "fused" else 0
        if fused_stretch.launches != want:
            raise AssertionError(f"stretch R-hat stop ({name}): B9 launched "
                                 f"{fused_stretch.launches} times, want "
                                 f"{want}")
        rhat = float(np.max(info["rhat"]))
        if not rhat < 1.1:
            raise AssertionError(f"stretch R-hat stop ({name}) not reached: "
                                 f"{rhat}")
        stops[name] = {"wall_s": wall, "gens": int(info["steps"]),
                       "rhat_max": rhat, "launches": fused_stretch.launches}
    log("stretch rhat stop:", json.dumps(stops))
    if stops["fused"]["gens"] != stops["per_generation"]["gens"]:
        raise AssertionError("stretch R-hat stop: the engines stopped at "
                             "different generations")
    return sum(launches)


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
    records[3]["config5_grad"] = check_b5_grad(dev)
    records += [check_b7(dev), check_b8(dev), check_b1(dev),
                check_b1_kernel_rng(dev), check_b9(dev), check_b11(dev),
                check_b10(dev)]
    launch_floor(dev)
    launches, s_pergen = main_path(dev)
    stream_launches, stream_res, s_stream = fused_path(dev)
    kernel_launches, kernel_res, s_kernel = fused_path(dev, rng="kernel")
    launches["fused_chunk"] = stream_launches["fused_chunk"]
    launches["fused_chunk_kernel_rng"] = \
        kernel_launches["fused_chunk_kernel_rng"]
    fused_modes_side_by_side(stream_res, kernel_res, s_stream, s_kernel)
    from bipymc_tpu_torch.ops.gather_rows import gather_rows
    if gather_rows.launches:          # since phase 3c's R-hat stop began
        raise AssertionError(f"B11 launched {gather_rows.launches} times "
                             "in phases 3, 3b and 3c (the defaults)")
    launches["gather_rows"] = gather_path(dev, s_kernel,
                                          kernel_res)["gather_rows"]
    from bipymc_tpu_torch.ops.accept_select import accept_select
    if accept_select.launches:        # since phase 3 began
        raise AssertionError(f"B10 launched {accept_select.launches} times "
                             "in phases 3-3d (the defaults)")
    launches["accept_select"] = accept_path(dev, s_pergen)
    fused_accept_path(dev, s_kernel)
    del s_pergen, s_stream, s_kernel
    accept_ab(dev)
    rhat_stop(dev)
    launches["fused_rw_chunk"] = config1_path(dev)
    rw_rhat_stop(dev)
    c4_launches, records[4]["in_step_ms"] = config4_path(dev)
    launches.update(c4_launches)
    c5 = config5_path(dev)
    launches.update(chol=c5["chol"], trisolve=c5["trisolve"])
    launches["fused_stretch"] = stretch_path(dev)
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
