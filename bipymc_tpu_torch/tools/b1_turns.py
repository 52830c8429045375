#!/usr/bin/env python3
"""Kernel B1 from two checkouts of the port, on one card, in either mode.

Holds one tree's B1 against another's (a parent commit unpacked with
``git archive`` beside this one) on the same operands: config 3's first
fused chunk after its 500 burn-in generations, [G, n, k, d] =
[10, 256, 6, 100], in stream mode (the chunk's draws) or kernel-RNG mode
(its rows and scalars, the main path's run key, t0 = 500). It checks
what a change to B1 did to its decisions and device time, which
``chip_smoke.py`` (one tree) cannot. Run the trees in turns, each
``run`` its own process (each imports its own ``bipymc_tpu_torch`` and
builds its own kernels), from the root of the checkout::

    python bipymc_tpu_torch/tools/b1_turns.py ops OPS.pt
    python bipymc_tpu_torch/tools/b1_turns.py run PARENT_ROOT OPS.pt p1.pt
    python bipymc_tpu_torch/tools/b1_turns.py run . OPS.pt c1.pt
    python bipymc_tpu_torch/tools/b1_turns.py run . OPS.pt c2.pt
    python bipymc_tpu_torch/tools/b1_turns.py run PARENT_ROOT OPS.pt p2.pt
    python bipymc_tpu_torch/tools/b1_turns.py compare p1.pt c1.pt c2.pt p2.pt

and the same with ``kernel`` after each ``run``'s output file for
kernel-RNG mode. ``wide`` times this checkout's B1 on the correlated
Gaussian past the shared route (n = 256, G = 10, d = 240 and 300, both
modes) four ways, to tell a slow kernel from a slow reading: launch by
launch after the card idled a second (CUDA events around each launch,
synchronised), back to back (events around 200 launches), by the
profiler over 200 launches after 20 of warm-up (as ``chip_smoke.py``
times it) and over 20 after 3, while ``nvidia-smi`` samples the SM and
memory clocks, the power draw and the temperature every 100 ms::

    python bipymc_tpu_torch/tools/b1_turns.py wide ``ops`` makes the operands of both modes with this
checkout's package; ``run`` prints one JSON line with B1's device time a
launch (the kernels' own durations from ``torch.profiler`` over 200
launches after 20 of warm-up, as ``chip_smoke.py`` times it) and saves
the outputs; ``compare`` holds every run's accept bits, x and logp to
the first's and prints one JSON line. Needs a CUDA card.
"""

import json
import os
import sys

import torch

# the checkout's root: this file is bipymc_tpu_torch/tools/b1_turns.py
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED, N_CHAINS, D, CAPACITY, BURNIN = 0, 256, 100, 8192, 500
KW = dict(n_pairs=3, d_true=D, b=1e-4, b_star=1e-6)


def _package(root):
    sys.path.insert(0, os.path.abspath(root))
    import bipymc_tpu_torch as bt
    return bt


def make_ops(out):
    bt = _package(HERE)
    from bipymc_tpu_torch.samplers.dream_fused import (
        chunk_operands, chunk_operands_kernel_rng)

    dev = torch.device("cuda", 0)
    means = bt.baseline_config3_means(D)
    g = torch.Generator(device=dev).manual_seed(SEED)
    theta0 = bt.stratified_mode_init(g, means, N_CHAINS, var=4.0, device=dev)
    s = bt.DreamZs(bt.gaussian_mixture(means, sigma=1.0), n_chains=N_CHAINS,
                   seed=SEED, burnin_gens=BURNIN, archive_capacity=CAPACITY,
                   device=dev)
    s.run_mcmc(BURNIN, theta0)
    st = s.final_state
    ops = chunk_operands(st, s._words, BURNIN, s.cfg)
    rows, scal, _ = chunk_operands_kernel_rng(st, s._words, BURNIN, s.cfg)
    torch.save({"x0": st.x.cpu(), "lp0": st.logp.cpu(),
                "ops": [a.contiguous().cpu() for a in ops],
                "kernel_ops": [rows.cpu(), scal.cpu()],
                "key": s._words.key}, out)


def device_ms(fn, reps=200, warmup=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return us / reps / 1e3


def run(root, ops_path, out, mode="stream"):
    bt = _package(root)
    from bipymc_tpu_torch.ops.fused_chunk import fused_chunk

    dev = torch.device("cuda", 0)
    saved = torch.load(ops_path)
    x0, lp0 = saved["x0"].to(dev), saved["lp0"].to(dev)
    lp = bt.gaussian_mixture(bt.baseline_config3_means(D), sigma=1.0)
    if mode == "kernel":
        rows, scal = (a.to(dev) for a in saved["kernel_ops"])
        call = lambda: fused_chunk(x0, lp0, rows, None, None, None, scal, lp,
                                   rng="kernel", run_key=saved["key"],
                                   t0=BURNIN, **KW)
    else:
        ops = [a.to(dev) for a in saved["ops"]]
        call = lambda: fused_chunk(x0, lp0, *ops, lp, **KW)
    res = call()
    torch.cuda.synchronize()
    ms = device_ms(call)
    torch.save([a.cpu() for a in res], out)
    print(json.dumps({"root": root, "mode": mode, "b1_device_ms": ms,
                      "acceptance": float(res[2].float().mean()),
                      "card": torch.cuda.get_device_name(0)}), flush=True)


def _wide_operands(G, n, d, seed, dev):
    """x0, rows, u_mask, u_e, eps, scal as ``chip_smoke.py`` phase 2e
    builds its wide cases."""
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


def _events_ms(fn, reps, each):
    """ms a launch by CUDA events: around each launch, synchronised after
    it (``each``: the list of launches), or around ``reps`` launches back
    to back (their mean)."""
    e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    if not each:
        e[0].record()
        for _ in range(reps):
            fn()
        e[1].record()
        torch.cuda.synchronize()
        return e[0].elapsed_time(e[1]) / reps
    out = []
    for _ in range(reps):
        e[0].record()
        fn()
        e[1].record()
        torch.cuda.synchronize()
        out.append(e[0].elapsed_time(e[1]))
    return out


def wide():
    import subprocess
    import threading
    import time

    import numpy as np

    bt = _package(HERE)
    from bipymc_tpu_torch.ops.fused_chunk import fused_chunk

    dev = torch.device("cuda", 0)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    samples = []
    reader = threading.Thread(target=lambda: samples.extend(smi.stdout),
                              daemon=True)
    reader.start()
    try:
        for i, d in enumerate((240, 300)):
            rng = np.random.default_rng(d)
            a = rng.standard_normal((d, d))
            lp = bt.correlated_gaussian(rng.standard_normal(d),
                                        a @ a.T / d + np.eye(d))
            x0, rows, um, ue, ep, scal = _wide_operands(10, N_CHAINS, d,
                                                        4 + i, dev)
            lp0 = lp(x0)
            kw = dict(KW, d_true=d)
            for mode in ("stream", "kernel"):
                if mode == "kernel":
                    fn = lambda: fused_chunk(
                        x0, lp0, rows, None, None, None, scal, lp,
                        rng="kernel", run_key=0xF123456789ABCDEF, t0=40,
                        **kw)
                else:
                    fn = lambda: fused_chunk(x0, lp0, rows, um, ue, ep,
                                             scal, lp, **kw)
                fn()
                torch.cuda.synchronize()
                time.sleep(1.0)
                t0 = len(samples)
                each = _events_ms(fn, 40, True)
                back = _events_ms(fn, 200, False)
                prof = device_ms(fn)
                after = _events_ms(fn, 20, True)
                time.sleep(1.0)
                short = device_ms(fn, reps=20, warmup=3)
                print(json.dumps({
                    "d": d, "mode": mode,
                    "each_after_idle_ms": each,
                    "back_to_back_200_ms": back,
                    "profiler_200_after_20_ms": prof,
                    "each_after_those_ms": after,
                    "profiler_20_after_3_after_idle_ms": short,
                    "smi_samples": [x.strip() for x in samples[t0:]],
                    "card": torch.cuda.get_device_name(0)}), flush=True)
    finally:
        smi.terminate()
        smi.wait(timeout=30)


def compare(paths):
    first = torch.load(paths[0])
    readings = {}
    for p in paths[1:]:
        other = torch.load(p)
        readings[p] = {
            "decisions_equal": bool(torch.equal(first[2], other[2])),
            "max_abs_dx": float((first[0] - other[0]).abs().max()),
            "max_abs_dlogp": float((first[1] - other[1]).abs().max())}
    print(json.dumps({"against": paths[0], "readings": readings}))
    if not all(r["decisions_equal"] for r in readings.values()):
        return 1
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("b1_turns: needs a CUDA card", file=sys.stderr)
        return 1
    cmd, args = argv[0], argv[1:]
    if cmd == "ops":
        make_ops(*args)
    elif cmd == "run":
        run(*args)
    elif cmd == "compare":
        return compare(args)
    elif cmd == "wide":
        wide()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
