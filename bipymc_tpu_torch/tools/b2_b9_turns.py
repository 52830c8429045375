#!/usr/bin/env python3
"""Kernels B2, B6 and B9 from two checkouts of the port, on one card.

Holds one tree's B2 (``dream_propose``), B6 (``cholesky_solve_batched``)
and B9 (``fused_stretch``) against another's (a parent commit unpacked
with ``git archive`` beside this one) on the same operands: B2 at config
3's [256, 100] (k = 6 rows; u_mask and u_e slices of a [n, 3d + 11]
uniform block, as the per-generation step passes them) and at config 5's
[1,024, 2]; B6 at config 4's [64, 512, 512] (``testing.spd_batch``'s
matrices, seed 99, as phase 2c times it); B9 at the stretch workload's
first chunk, [G, n, d] = [64, 256, 16]. It checks what a change did to
their outputs and device times, which ``chip_smoke.py`` (one tree)
cannot. B6 is timed five ways, in turns within the run (the order below,
then back): L and z warm; L and z with 128 MB written over L2 before each
call; inside config 4's step (``Dram`` over ``GpRegressor._lml_impl`` on
config 4's data, as phase 7 runs it: 2 x 50 steps profiled after 50 of
warm-up, the step's other kernels before each launch); L alone; and B7's
cooperative route (``csrc/chol_coop.cu``) on the same matrices, L alone. Run the trees in turns, each ``run`` its own process
(each imports its own ``bipymc_tpu_torch`` and builds its own kernels),
from the root of the checkout::

    python bipymc_tpu_torch/tools/b2_b9_turns.py ops OPS.pt
    python bipymc_tpu_torch/tools/b2_b9_turns.py run PARENT_ROOT OPS.pt p1.pt
    python bipymc_tpu_torch/tools/b2_b9_turns.py run . OPS.pt c1.pt
    python bipymc_tpu_torch/tools/b2_b9_turns.py run . OPS.pt c2.pt
    python bipymc_tpu_torch/tools/b2_b9_turns.py run PARENT_ROOT OPS.pt p2.pt
    python bipymc_tpu_torch/tools/b2_b9_turns.py compare p1.pt c1.pt c2.pt p2.pt

``ops`` makes the operands with this checkout's package; ``run`` prints
one JSON line with each kernel's device ms a launch (the kernels' own
durations from ``torch.profiler`` over the launches it recorded of 200,
after 20 of warm-up), that count, and ms a launch by CUDA events around
the same 200, and saves the outputs; ``compare`` holds every run's
outputs to the first's (B9's bit for bit; B2's within x_star rtol 1e-5 /
atol 1e-6 and log_jac rtol 1e-5 / atol 1e-4, B6's L within
5e-6·max|L| and z within 1e-5·max|z|, phase 2c's bounds: a redesign may
sum in another order) and prints one JSON line. Needs a CUDA card.
"""

import json
import os
import sys

import numpy as np
import torch

# the checkout's root: this file is bipymc_tpu_torch/tools/b2_b9_turns.py
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 0
B2_SHAPES = {"config3": (256, 100), "config5": (1024, 2)}
B2_KW = dict(n_pairs=3, b=1e-4, b_star=1e-6)
ST_N, ST_D, ST_G = 256, 16, 64
B6_B, B6_N = 64, 512
# B6's five timings, in this order and then back (one turn each way)
B6_MODES = ("warm", "l2_overwritten", "in_step", "l_alone", "b7_coop")


def _package(root):
    sys.path.insert(0, os.path.abspath(root))
    import bipymc_tpu_torch as bt
    return bt


def _b2_operands(n, d, seed, dev):
    """x, rows, the [n, 3d + 11] uniform block (u_mask and u_e its
    slices), eps and scal, as ``chip_smoke.py`` phase 2 builds B2's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(generator=g, device=dev, dtype=torch.float32)
    x = torch.randn((n, d), **f32)
    rows = x[:, None, :] + 2.0 * torch.randn((n, 6, d), **f32)
    block = torch.rand((n, 3 * d + 11), **f32)
    eps = torch.randn((n, d), **f32)
    delta = torch.clamp_max(1.0 + torch.floor(torch.rand(n, **f32) * 3), 3.0)
    cr = torch.randint(1, 4, (n,), generator=g, device=dev).float() / 3.0
    gamma_s = 1.2 + torch.rand(n, **f32)
    is_snk = (torch.rand(n, **f32) < 0.5).float()
    scal = torch.stack([delta, cr, gamma_s, is_snk,
                        torch.zeros(n, device=dev)], dim=1)
    return {"x": x, "rows": rows, "block": block, "eps": eps, "scal": scal}


def _b2_views(ops, d, dev):
    block = ops["block"].to(dev)
    return (ops["x"].to(dev), ops["rows"].to(dev), block[:, 11:11 + d],
            block[:, 11 + d:11 + 2 * d], ops["eps"].to(dev),
            ops["scal"].to(dev))


def make_ops(out):
    bt = _package(HERE)
    from bipymc_tpu_torch.samplers.stretch_fused import chunk_words

    dev = torch.device("cuda", 0)
    saved = {f"b2_{k}": {a: t.cpu() for a, t in
                         _b2_operands(n, d, 99 + i, dev).items()}
             for i, (k, (n, d)) in enumerate(B2_SHAPES.items())}
    # the stretch workload (chip_smoke.py stretch_setup), its first chunk
    scales = np.linspace(0.5, 3.0, ST_D).astype(np.float32)
    lp = bt.correlated_gaussian(np.zeros(ST_D),
                                np.diag(scales.astype(np.float64) ** 2))
    x0 = (np.random.default_rng(SEED).standard_normal((ST_N, ST_D))
          * scales).astype(np.float32)
    s = bt.EnsembleSampler(lp, n_chains=ST_N, seed=SEED, fused=True,
                           device=dev)
    x0 = torch.from_numpy(x0).to(dev)
    s._ensure_state(x0, 1.0)
    words = chunk_words(s._words, 0, ST_G, ST_N, ST_D, s.cfg.a,
                        torch.float32, dev)
    saved["b9"] = {"x0": x0.cpu(), "scales": torch.from_numpy(scales),
                   "ops": [a.cpu() for a in words]}
    from bipymc_tpu_torch.testing import config4_data, spd_batch

    a, y = spd_batch(B6_B, B6_N, seed=99, dev=dev)
    x4, y4 = config4_data()
    saved["b6"] = {"a": a.cpu(), "y": y.cpu(), "x4": torch.from_numpy(x4),
                   "y4": torch.from_numpy(y4)}
    torch.save(saved, out)


def timed(fn, key, reps=200, warmup=20):
    """Device ms a launch of the kernels whose name holds ``key``, over
    the launches the profiler recorded of ``reps``; that count; ms a
    launch by CUDA events around the same ``reps``."""
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
    n = sum(e.count for e in rows)
    if n == 0:
        raise AssertionError(f"the profiler recorded no launch of {key}")
    us = sum(e.self_device_time_total for e in rows)
    return us / n / 1e3, n, e0.elapsed_time(e1) / reps


def b6_step_sampler(bt, x4, y4, dev):
    """Config 4's sampler as ``chip_smoke.py`` phase 7 builds it, after 50
    steps: ``Dram(seed=1)`` of 64 chains over the GP log-ML plus a
    N(0, 2²) prior, two B6 launches a step."""
    gp = bt.GpRegressor(device=dev)

    def log_post(theta):
        p = {"log_lengthscale": theta[:, 0:2], "log_sigma_f": theta[:, 2],
             "log_sigma_n": theta[:, 3]}
        return (gp._lml_impl(p, x4, y4)
                - 0.5 * torch.sum((theta / 2.0) ** 2, dim=-1))

    s = bt.Dram(log_post, seed=1, n_chains=B6_B, device=dev)
    s.run_mcmc(50, np.zeros(4), cov_est=np.eye(4) * 0.05)
    return s


def b6_times(bt, b6, dev):
    """B6's device ms a launch in :data:`B6_MODES`' five ways, in turns;
    and its outputs (L, z) warm."""
    from bipymc_tpu_torch.ops.pallas_bchol import (cholesky_batched,
                                                   cholesky_solve_batched)
    from bipymc_tpu_torch.ops.pallas_chol import _chol_kernel

    a, y = b6["a"].to(dev), b6["y"].to(dev)
    x4, y4 = b6["x4"].to(dev), b6["y4"].to(dev)
    junk = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)

    def overwritten():
        junk.fill_(1.0)                 # 128 MB over the 50 MB L2
        cholesky_solve_batched(a, y)

    s = b6_step_sampler(bt, x4, y4, dev)
    calls = {"warm": (lambda: cholesky_solve_batched(a, y), "bchol", 200),
             "l2_overwritten": (overwritten, "bchol", 200),
             "in_step": (lambda: s.run_mcmc(50), "bchol", 2),
             "l_alone": (lambda: cholesky_batched(a), "bchol", 200),
             "b7_coop": (lambda: _chol_kernel(a, "cooperative"),
                         "chol_coop", 200)}
    res = {m: [] for m in B6_MODES}
    for m in B6_MODES + B6_MODES[::-1]:
        fn, key, reps = calls[m]
        ms, rec, _ = timed(fn, key, reps=reps, warmup=min(20, reps))
        res[m].append({"device_ms": ms, "recorded": rec})
    L, z = cholesky_solve_batched(a, y)
    return res, [L.cpu(), z.cpu()]


def run(root, ops_path, out):
    bt = _package(root)
    from bipymc_tpu_torch.ops.dream_proposal import dream_propose
    from bipymc_tpu_torch.ops.fused_stretch import fused_stretch

    dev = torch.device("cuda", 0)
    saved = torch.load(ops_path)
    res, outs = {"root": root, "card": torch.cuda.get_device_name(0)}, {}
    for k, (n, d) in B2_SHAPES.items():
        ops = _b2_views(saved[f"b2_{k}"], d, dev)
        call = lambda ops=ops, d=d: dream_propose(*ops, d_true=d, **B2_KW)
        outs[f"b2_{k}"] = [a.cpu() for a in call()]
        ms, rec, ev = timed(call, "dream_propose")
        res[f"b2_{k}"] = {"device_ms": ms, "recorded": rec, "events_ms": ev}
    b9 = saved["b9"]
    scales = b9["scales"].numpy().astype(np.float64)
    lp = bt.correlated_gaussian(np.zeros(ST_D), np.diag(scales ** 2))
    x0 = b9["x0"].to(dev)
    lp0 = lp(x0)
    ops = [a.to(dev) for a in b9["ops"]]
    call = lambda: fused_stretch(x0, lp0, *ops, lp, ST_N // 2)
    outs["b9"] = [a.cpu() for a in call()]
    ms, rec, ev = timed(call, "fused_stretch")
    res["b9"] = {"device_ms": ms, "recorded": rec, "events_ms": ev,
                 "plan": fused_stretch.last_plan}
    res["b6"], outs["b6"] = b6_times(bt, saved["b6"], dev)
    torch.cuda.synchronize()
    torch.save(outs, out)
    print(json.dumps(res), flush=True)


def compare(paths):
    first = torch.load(paths[0])
    readings, ok = {}, True
    for p in paths[1:]:
        other = torch.load(p)
        r = {"b9_bit_equal": all(torch.equal(a, b) for a, b in
                                 zip(first["b9"], other["b9"]))}
        ok &= r["b9_bit_equal"]
        for k in B2_SHAPES:
            (x1, j1), (x2, j2) = first[f"b2_{k}"], other[f"b2_{k}"]
            dx, dj = (x2 - x1).abs(), (j2 - j1).abs()
            within = (bool(torch.all(dx <= 1e-6 + 1e-5 * x1.abs()))
                      and bool(torch.all(dj <= 1e-4 + 1e-5 * j1.abs())))
            r[f"b2_{k}"] = {"max_abs_dx": float(dx.max()),
                            "max_abs_dlogjac": float(dj.max()),
                            "bit_equal": bool(torch.equal(x1, x2)
                                              and torch.equal(j1, j2)),
                            "within_tolerance": within}
            ok &= within
        (L1, z1), (L2, z2) = first["b6"], other["b6"]
        dl, dz = float((L2 - L1).abs().max()), float((z2 - z1).abs().max())
        within = (dl <= 5e-6 * float(L1.abs().max())
                  and dz <= 1e-5 * float(z1.abs().max()))
        r["b6"] = {"max_abs_dL": dl, "max_abs_dz": dz,
                   "bit_equal": bool(torch.equal(L1, L2)
                                     and torch.equal(z1, z2)),
                   "within_tolerance": within}
        ok &= within
        readings[p] = r
    print(json.dumps({"against": paths[0], "readings": readings}))
    return 0 if ok else 1


def main(argv):
    if not torch.cuda.is_available():
        print("b2_b9_turns: needs a CUDA card", file=sys.stderr)
        return 1
    cmd, args = argv[0], argv[1:]
    if cmd == "ops":
        make_ops(*args)
    elif cmd == "run":
        run(*args)
    elif cmd == "compare":
        return compare(args)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["help"]))
