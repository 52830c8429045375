#!/usr/bin/env python3
"""Kernel B1 in stream mode from two checkouts of the port, on one card.

Holds one tree's B1 against another's (a parent commit unpacked with
``git archive`` beside this one) on the same operands: config 3's first
fused chunk after its 500 burn-in generations, [G, n, k, d] =
[10, 256, 6, 100]. It checks that a change to B1 left stream mode's
decisions and device time as they were, which ``chip_smoke.py`` (one
tree) cannot. Run the trees in turns, each ``run`` its own process (each
imports its own ``bipymc_tpu_torch`` and builds its own kernels), from
the root of the checkout::

    python bipymc_tpu_torch/tools/b1_turns.py ops OPS.pt
    python bipymc_tpu_torch/tools/b1_turns.py run PARENT_ROOT OPS.pt p1.pt
    python bipymc_tpu_torch/tools/b1_turns.py run . OPS.pt c1.pt
    python bipymc_tpu_torch/tools/b1_turns.py run . OPS.pt c2.pt
    python bipymc_tpu_torch/tools/b1_turns.py run PARENT_ROOT OPS.pt p2.pt
    python bipymc_tpu_torch/tools/b1_turns.py compare p1.pt c1.pt c2.pt p2.pt

``ops`` makes the operands with this checkout's package; ``run`` prints
one JSON line with B1's device time a launch (the kernels' own durations
from ``torch.profiler`` over 200 launches after 20 of warm-up, as
``chip_smoke.py`` times it) and saves the outputs; ``compare`` holds
every run's accept bits, x and logp to the first's and prints one JSON
line. Needs a CUDA card.
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
    from bipymc_tpu_torch.samplers.dream_fused import chunk_operands

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
    torch.save({"x0": st.x.cpu(), "lp0": st.logp.cpu(),
                "ops": [a.contiguous().cpu() for a in ops]}, out)


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


def run(root, ops_path, out):
    bt = _package(root)
    from bipymc_tpu_torch.ops.fused_chunk import fused_chunk

    dev = torch.device("cuda", 0)
    saved = torch.load(ops_path)
    x0, lp0 = saved["x0"].to(dev), saved["lp0"].to(dev)
    ops = [a.to(dev) for a in saved["ops"]]
    lp = bt.gaussian_mixture(bt.baseline_config3_means(D), sigma=1.0)
    call = lambda: fused_chunk(x0, lp0, *ops, lp, **KW)
    res = call()
    torch.cuda.synchronize()
    ms = device_ms(call)
    torch.save([a.cpu() for a in res], out)
    print(json.dumps({"root": root, "b1_stream_device_ms": ms,
                      "acceptance": float(res[2].float().mean()),
                      "card": torch.cuda.get_device_name(0)}), flush=True)


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
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
