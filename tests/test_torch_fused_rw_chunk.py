"""Port ↔ JAX: kernel B4's plain version against ``fused_rw_chunk_pallas``
in interpret mode, on the same NumPy ``x0, logp0, dy1, dy2, scal``.

The JAX kernel evaluates ``block_logp_from_scalar(correlated_gaussian)``,
the port's plain version the batched ``correlated_gaussian``. Accept
decisions and stages must be identical; positions and logp are held
within rtol 1e-5 / atol 1e-6 (the packages sum the quadratic form in
different orders). A target with a +inf region must be rejected
identically by both. On the CPU the wrapper takes the plain version; on
a device with no kernel it raises.
"""

import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bipymc_tpu_torch as bt

from bipymc_tpu.models import targets as jtargets
from bipymc_tpu.ops.fused_chunk import block_logp_from_scalar
from bipymc_tpu.ops.fused_rw_chunk import fused_rw_chunk_pallas
from bipymc_tpu_torch.models import targets
from bipymc_tpu_torch.ops import fused_chunk, fused_stretch
from bipymc_tpu_torch.ops import fused_rw_chunk as b4
from bipymc_tpu_torch.ops.fused_rw_chunk import (fused_rw_chunk,
                                                 fused_rw_chunk_plain)

torch.set_num_threads(2)

KAPPA_ISK = float(np.float32(1.0) / np.sqrt(np.float32(5.0)))
CSRC = Path(b4.__file__).resolve().parents[1] / "csrc"


def _operands(n, d, K, seed, scale=0.9):
    """x0, dy1, dy2, scal as the fused runner builds them: z draws against
    one Cholesky factor, the whitened norms, log u."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    L = np.linalg.cholesky(scale * (a @ a.T / d + np.eye(d)))
    z1 = rng.standard_normal((K, n, d))
    z2 = rng.standard_normal((K, n, d))
    u = rng.uniform(1e-7, 1.0, (2, K, n))
    w = z1 - KAPPA_ISK * z2
    scal = np.stack([np.sum(z1 ** 2, -1), np.sum(w ** 2, -1), np.log(u[0]),
                     np.log(u[1])], -1)
    x0 = rng.standard_normal((n, d))
    f32 = lambda v: np.ascontiguousarray(v, dtype=np.float32)
    return (f32(x0), f32(z1 @ L.T), f32(KAPPA_ISK * (z2 @ L.T)), f32(scal))


def _both(x0, dy1, dy2, scal, jblock, port_lp, delayed, lp0):
    jout = fused_rw_chunk_pallas(
        jnp.asarray(x0), jnp.asarray(lp0), jnp.asarray(dy1),
        jnp.asarray(dy2) if delayed else None, jnp.asarray(scal), jblock,
        delayed=delayed, interpret=True)
    t = [torch.from_numpy(a) for a in (x0, lp0, dy1, dy2, scal)]
    out = fused_rw_chunk(t[0], t[1], t[2], t[3] if delayed else None, t[4],
                         port_lp, delayed)
    return [np.asarray(a) for a in jout], [a.numpy() for a in out]


@pytest.mark.parametrize("delayed", [False, True])
@pytest.mark.parametrize("n", [1, 4, 9])
@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("K", [7, 20])
def test_plain_matches_pallas_interpret(delayed, n, d, K):
    rng = np.random.default_rng(d)
    mean = rng.standard_normal(d)
    a = rng.standard_normal((d, d))
    cov = a @ a.T / d + np.eye(d)
    jlp = jtargets.correlated_gaussian(mean, cov)
    lp = targets.correlated_gaussian(mean, cov)
    x0, dy1, dy2, scal = _operands(n, d, K, seed=100 * n + 10 * d + K)
    lp0 = lp(torch.from_numpy(x0)).numpy()
    (jx, jl, ja, js), (x, l, acc, st) = _both(
        x0, dy1, dy2, scal, block_logp_from_scalar(jlp, d), lp, delayed,
        lp0)
    np.testing.assert_array_equal(acc, ja)
    np.testing.assert_array_equal(st, js)
    np.testing.assert_allclose(x, jx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l, jl, rtol=1e-5, atol=1e-6)
    assert x.shape == (K, n, d) and st.dtype == np.int32


def test_stages_covered_at_a_larger_case():
    """One case long enough to hold every outcome: rejects, stage-1 and
    stage-2 accepts, all identical to the Pallas kernel's."""
    d, n, K = 3, 16, 40
    mean, cov = np.zeros(d), np.eye(d) + 0.5
    jlp = jtargets.correlated_gaussian(mean, cov)
    lp = targets.correlated_gaussian(mean, cov)
    x0, dy1, dy2, scal = _operands(n, d, K, seed=5, scale=4.0)
    lp0 = lp(torch.from_numpy(x0)).numpy()
    (jx, _, ja, js), (x, _, acc, st) = _both(
        x0, dy1, dy2, scal, block_logp_from_scalar(jlp, d), lp, True, lp0)
    np.testing.assert_array_equal(st, js)
    assert set(np.unique(st)) == {0, 1, 2}
    np.testing.assert_allclose(x, jx, rtol=1e-5, atol=1e-6)


def test_nonfinite_target_rejects_identically():
    """A +inf region: log_a1 itself is sanitised to −inf, so stage 2's
    Green–Mira denominator stays right, and no chain lands in it."""
    def jscalar(theta):
        base = -0.5 * jnp.sum(theta ** 2)
        return jnp.where((theta[0] > 0.4) & (theta[1] > 0.4), jnp.inf, base)

    def port_lp(x):
        base = -0.5 * torch.sum(x ** 2, dim=-1)
        inside = (x[:, 0] > 0.4) & (x[:, 1] > 0.4)
        return torch.where(inside, torch.inf, base)

    n, d, K = 8, 2, 60
    x0, dy1, dy2, scal = _operands(n, d, K, seed=9)
    x0 = -np.abs(x0)                      # start outside the region
    lp0 = port_lp(torch.from_numpy(x0)).numpy()
    for delayed in (False, True):
        (jx, _, ja, js), (x, lp, acc, st) = _both(
            x0, dy1, dy2, scal, block_logp_from_scalar(jscalar, d), port_lp,
            delayed, lp0)
        np.testing.assert_array_equal(st, js)
        np.testing.assert_allclose(x, jx, rtol=1e-5, atol=1e-6)
        assert not np.any((x[..., 0] > 0.4) & (x[..., 1] > 0.4))
        assert np.all(np.isfinite(lp))
        # the proposals did enter the region, and were all refused
        y1 = x0[None] + dy1
        assert np.any((y1[..., 0] > 0.4) & (y1[..., 1] > 0.4))


def test_wrapper_takes_plain_on_cpu_and_raises_elsewhere():
    lp = targets.correlated_gaussian(np.zeros(2), np.eye(2))
    x0, dy1, dy2, scal = (torch.from_numpy(a) for a in
                          _operands(3, 2, 5, seed=0))
    lp0 = lp(x0)
    for a, b in zip(fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, True),
                    fused_rw_chunk_plain(x0, lp0, dy1, dy2, scal, lp, True)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dy2"):
        fused_rw_chunk(x0, lp0, dy1, None, scal, lp, True)
    with pytest.raises(ValueError, match="divide"):
        fused_rw_chunk(x0, lp0, dy1, dy2, scal, lp, True, steps_per_cell=2)
    with pytest.raises(ValueError, match="scal"):
        fused_rw_chunk(x0, lp0, dy1, dy2, scal[..., :3], lp, True)
    meta = [a.to("meta") for a in (x0, lp0, dy1, dy2, scal)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_rw_chunk(*meta, lp, True)
    with pytest.raises(ValueError, match="kernel form"):
        fused_rw_chunk(*meta, lambda x: x.sum(-1), True)
    mix = targets.gaussian_mixture(np.zeros((17, 2)))
    with pytest.raises(ValueError, match="at most 16 modes"):
        fused_rw_chunk(*meta, mix, True)


@pytest.mark.parametrize("delayed", [False, True])
def test_plain_matches_pallas_interpret_at_d240(delayed):
    """A Gaussian past the old shared-memory limit of the port's B4
    (d = 239): the function B4 must now compute there is the
    reference's."""
    test_plain_matches_pallas_interpret(delayed, 2, 240, 3)


def _c_plans(queries, tmp_path):
    """``csrc/fused_rw_plan.cuh::rw_plan`` built with the host's C++
    compiler, run on each (n, d, K, kind, n_modes, force) at the H100's
    shared memory: its plan as ``plan`` writes it, or None."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the C plan with")
    src = tmp_path / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "fused_rw_plan.cuh"\n'
        "int main() {\n  int q[7];\n"
        '  while (std::scanf("%d %d %d %d %d %d %d", q, q + 1, q + 2, q + 3,'
        " q + 4, q + 5, q + 6) == 7) {\n"
        "    b4plan::Plan p;\n"
        "    if (!b4plan::rw_plan(q[0], q[1], q[2], q[3], q[4], q[5], q[6],"
        " &p))\n"
        '      std::puts("None");\n'
        "    else\n"
        '      std::printf("%d %d %d %zu %d\\n", p.route, p.cpb, p.threads,'
        " p.smem, p.stage);\n  }\n}\n")
    exe = tmp_path / "plan"
    subprocess.run([cxx, "-std=c++17", "-O1", f"-I{CSRC}", str(src), "-o",
                    str(exe)], check=True, capture_output=True, timeout=120)
    text = "".join(f"{n} {d} {K} {kind} {m} {f} {b4.MAX_SHARED_BYTES}\n"
                   for n, d, K, kind, m, f in queries)
    out = subprocess.run([str(exe)], input=text, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    plans = []
    for line in out.splitlines():
        if line == "None":
            plans.append(None)
            continue
        route, cpb, threads, smem, stage = map(int, line.split())
        plans.append((b4.ROUTES[route], cpb, threads, smem,
                      b4.STAGING[stage]))
    return plans


def test_plan_matches_the_c_plan(tmp_path):
    """``plan`` mirrors the C plan the launch makes, over a grid of
    shapes, targets and forced routes."""
    queries = [(n, d, K, kind, m, force)
               for n in (1, 2, 37, 127, 128, 256, 1000, 1024, 5000)
               for d in (1, 2, 31, 32, 33, 100, 128, 129, 240, 300, 513,
                         5000)
               for K in (1, 5, 50, 200)
               for kind, m in ((0, 0), (1, 4), (1, 16), (1, 17))
               for force in (-1, 0, 1, 2)]
    want = [b4.plan(n, d, K, kind, m, None if f < 0 else b4.ROUTES[f])
            for n, d, K, kind, m, f in queries]
    assert _c_plans(queries, tmp_path) == want
    assert sum(p is None for p in want) > 0


@pytest.mark.parametrize("n,d,K,kind,route,cpb,staging", [
    (1, 2, 50, 0, "latency", 1, "whole"),         # config 1
    (256, 100, 50, 0, "throughput", 2, "whole"),  # the wide shape
    (256, 300, 4, 0, "global", 2, "none"),
    (2, 240, 5, 0, "global", 1, "none"),
    (256, 2, 50, 1, "latency", 2, "whole"),
    (256, 100, 50, 1, "global", 2, "none"),
    (4096, 128, 50, 0, "throughput", 8, "ring"),
    (4096, 128, 3, 0, "throughput", 8, "whole"),
    (37, 129, 7, 0, "global", 1, "none"),
])
def test_plan_routes(n, d, K, kind, route, cpb, staging):
    """The route each shape takes, its chains a block and its staging;
    at n = 256, 128 blocks; the routes that do not take a shape."""
    m = 4 if kind else 0
    p = b4.plan(n, d, K, kind, m)
    assert (p[0], p[1], p[4]) == (route, cpb, staging)
    assert p[3] <= b4.MAX_SHARED_BYTES and p[2] % 32 == 0
    if n == 256:
        assert -(-n // p[1]) == 128
    assert (b4.plan(n, d, K, kind, m, "latency") is None) == (d > 32)
    assert (b4.plan(n, d, K, kind, m, "throughput") is None) == (
        kind == 1 or d > 128)
    assert b4.plan(n, d, K, kind, m, "global")[0] == "global"
    assert b4.plan(n, d, K, 1, 17) is None


def _b1_meta(G, n, d, rng):
    meta = dict(device="meta", dtype=torch.float32)
    draws = [torch.empty((G, n, d), **meta) for _ in range(3)]
    if rng == "kernel":
        draws = [None] * 3
    return (torch.empty((n, d), **meta), torch.empty((n,), **meta),
            torch.empty((G, n, 6, d), **meta), *draws,
            torch.empty((G, n, 6), **meta))


@pytest.mark.parametrize("rng,limit", [("stream", 238), ("kernel", 237)])
def test_b1_limit_is_the_wrappers_check(rng, limit):
    """B1 held the correlated Gaussian's constants in shared memory and so
    refused it past d = ``limit`` (238 in stream mode, 237 in kernel-RNG
    mode), in its wrapper and in ``DreamZs(fused=True)`` on a CUDA device.
    Its global route now takes it at every d: the plan finds a launch
    there and the wrapper goes on to its device check rather than
    refusing."""
    kw = dict(n_pairs=3, b=1e-4, b_star=1e-6, rng=rng)
    if rng == "kernel":
        kw.update(run_key=1, t0=0)
    for d in (limit, limit + 1, 240, 300, 1000):
        lp = targets.correlated_gaussian(np.zeros(d), np.eye(d))
        route = "shared" if d <= 230 else "global"
        assert fused_chunk.plan(3, d, 2, 3, 0)[0] == route
        ops = _b1_meta(2, 3, d, rng)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fused_chunk.fused_chunk(*ops, lp, d_true=d, **kw)


def _b9_meta(G, n, d):
    meta = dict(device="meta", dtype=torch.float32)
    return (torch.empty((n, d), **meta), torch.empty((n,), **meta),
            torch.empty((G, n), device="meta", dtype=torch.int32),
            torch.empty((G, n), **meta), torch.empty((G, n), **meta))


@pytest.mark.parametrize("n,limit", [(32, 236), (256, 236), (512, 231),
                                     (1024, 225)])
def test_b9_limit_is_the_plans(n, limit):
    """B9 held the correlated Gaussian's constants in shared memory and so
    refused it past d = ``limit`` at n walkers, in its wrapper and in
    ``EnsembleSampler(fused=True)`` on a CUDA device. Past that d it now
    reads them from device memory: the plan finds a launch there, and
    the wrapper goes on to its device check rather than refusing. What
    limit remains (each walker's residual in shared memory) is far past
    B4's d = 20,832."""
    for d in (limit, limit + 1, 240, 300, 1000):
        lp = targets.correlated_gaussian(np.zeros(d), np.eye(d))
        consts = "shared" if d <= limit else "device"
        assert fused_stretch.plan(n, d, 0)[1] == consts
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fused_stretch.fused_stretch(*_b9_meta(2, n, d), lp, n // 2)
    top = fused_stretch.max_d(n, 0)
    assert top >= 40_316 > 20_832
    assert fused_stretch.plan(n, top, 0)[1] == "device"
    assert fused_stretch.plan(n, top + 1, 0) is None


def test_fused_samplers_refuse_at_construction_for_cuda():
    """On a CUDA device the fused samplers refuse at construction only what
    no kernel takes (a target without a kernel form, float64), and build
    on the 240-d Gaussian that ``EnsembleSampler(fused=True)`` once refused
    there (B9 reads its constants from device memory), as
    ``DreamZs(fused=True)`` (B1, both modes) and ``Dram(fused=True)``
    (B4) do; nothing touches the card, and the CPU takes every one."""
    d = 240
    lp = targets.correlated_gaussian(np.zeros(d), np.eye(d))
    for device in ("cuda", "cpu"):
        for rng in ("stream", "kernel"):
            bt.DreamZs(lp, n_chains=32, fused=True, fused_rng=rng,
                       device=device)
        bt.EnsembleSampler(lp, n_chains=32, fused=True, device=device)
        bt.Dram(lp, n_chains=2, fused=True, device=device)
    user = lambda x: -0.5 * torch.sum(x * x, dim=-1)
    for kw in (dict(log_like_fn=user), dict(log_like_fn=lp,
                                            dtype=torch.float64)):
        with pytest.raises(ValueError, match="kernel B9|float32"):
            bt.EnsembleSampler(n_chains=32, fused=True, device="cuda", **kw)


def test_max_d_is_where_the_plan_ends():
    """B4 takes the correlated Gaussian up to ``max_d`` (its residuals in
    shared memory), 87 × the 239 of the kernel before the routes, and the
    mixture at any d."""
    limit = b4.max_d(0)
    assert limit == 20832
    assert b4.plan(1, limit, 50, 0) is not None
    assert b4.plan(1, limit + 1, 50, 0) is None
    assert b4.max_d(1, 16) is None
    assert b4.plan(1, 100_000, 50, 1, 16)[0] == "global"
