"""Kernel B10, the DREAM-zs accept and state update, and the route through
it, on the CPU.

The port's plain version (``ops/accept_select.py::accept_select_reference``,
what the dispatcher runs on a CPU tensor) is held bit-equal to the JAX
package's ``accept_select_pallas(interpret=True)`` on the same NumPy
inputs (the pairing of ``tests/test_accept_select.py``), at [n, d] in
{(200, 37), (256, 100) (config 3), (1, 1), (7, 129)} in float32 and at
(256, 100) in float64. Every case carries the edge rows: logp* NaN, +inf
and −inf; the current logp NaN, −inf and +inf; log_jac NaN; log u = −inf;
and logp* = logp with log_jac = 0. Every op is exact (compare, select,
min, add), so the outputs are compared by bit pattern: NaN ≠ NaN defeats
an equality test.

The route: ``DreamZs(pallas_accept=True)`` must give histories bit-equal
to the default on all three engine settings, and launch nothing on the
CPU. The per-generation step with ``pallas_accept=True`` is held to the
JAX step in ``tests/test_torch_dream_slice.py``. Last, the dispatcher's
refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bipymc_tpu_torch as bt
from bipymc_tpu.ops.accept_select import accept_select_pallas
from bipymc_tpu_torch.ops.accept_select import (accept_select,
                                                accept_select_reference)
from bipymc_tpu_torch.samplers import dream
from bipymc_tpu_torch.testing import (ACCEPT_EDGE_ROWS, ACCEPT_FIELDS,
                                      accept_edge_groups, accept_operands,
                                      check_accept_edges)

torch.set_num_threads(2)

def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.int32, 8: np.int64, 1: np.uint8}[a.dtype.itemsize])


def _hold(ops, edges):
    port = accept_select(*(torch.from_numpy(ops[k]) for k in ACCEPT_FIELDS))
    ref = accept_select_pallas(*(jnp.asarray(ops[k]) for k in ACCEPT_FIELDS),
                               interpret=True)
    names = ("x_new", "logp_new", "logp_sum_new", "accepted")
    for name, a, b in zip(names, port, ref):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                      err_msg=name)
    acc = port[3].numpy()
    check_accept_edges(acc, edges)
    return acc


@pytest.mark.parametrize("n,d", [(200, 37), (256, 100), (1, 1), (7, 129)])
def test_plain_matches_pallas_interpret(n, d):
    accs = [_hold(accept_operands(n, d, seed=n + d + i, edges=edges), edges)
            for i, edges in enumerate(accept_edge_groups(n))]
    if n > 1:
        acc = np.concatenate(accs)
        assert acc.any() and not acc.all()


def test_plain_matches_pallas_interpret_float64():
    n, d = 256, 100
    with jax.enable_x64(True):
        acc = _hold(accept_operands(n, d, seed=3, dtype=np.float64),
                    ACCEPT_EDGE_ROWS)
    assert acc.any() and not acc.all()


def test_plain_is_the_default_route():
    """The plain version is the per-generation step's default tail:
    ``metropolis_select``, then the ``logp_sum`` add, bit for bit."""
    from bipymc_tpu_torch.ops.fused_chunk import metropolis_select
    ops = {k: torch.from_numpy(v) for k, v in
           accept_operands(64, 5, 4).items()}
    x_new, lp_new, acc, _ = metropolis_select(
        ops["x"], ops["logp"], ops["x_star"], ops["logp_star"],
        ops["log_jac"], ops["log_u"])
    out = accept_select_reference(*(ops[k] for k in ACCEPT_FIELDS))
    for a, b in zip(out, (x_new, lp_new, ops["logp_sum"] + lp_new, acc)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))


def test_empty_population():
    ops = [torch.from_numpy(v)
           for v in accept_operands(0, 4, 5, edges=()).values()]
    before = accept_select.launches
    x_new, lp_new, lp_sum, acc = accept_select(*ops)
    assert x_new.shape == (0, 4) and lp_new.shape == lp_sum.shape == (0,)
    assert acc.shape == (0,) and acc.dtype == torch.bool
    assert accept_select.launches == before


def test_dispatcher_rejects_what_it_does_not_take():
    ops = [torch.from_numpy(v)
           for v in accept_operands(8, 3, 6, edges=()).values()]
    x, x_star, *vecs = ops
    with pytest.raises(ValueError, match=r"same \[n, d\]"):
        accept_select(x, x_star[:, :2], *vecs)
    with pytest.raises(ValueError, match=r"same \[n, d\]"):
        accept_select(x[0], x_star[0], *vecs)
    with pytest.raises(ValueError, match=r"log_jac must be \[n\]"):
        accept_select(x, x_star, *vecs[:2], vecs[2][:7], *vecs[3:])
    with pytest.raises(ValueError, match="log_u on meta"):
        accept_select(x, x_star, *vecs[:3], vecs[3].to("meta"), vecs[4])
    meta = [t.to("meta") for t in ops]
    with pytest.raises(TypeError, match="no kernel for dtype"):
        accept_select(*(t.to(torch.int32) for t in meta))
    with pytest.raises(TypeError, match="one dtype"):
        accept_select(*meta[:6], meta[6].double())
    with pytest.raises(ValueError, match="no kernel for device"):
        accept_select(*meta)
    before = accept_select.launches
    accept_select(*ops)
    assert accept_select.launches == before    # the CPU takes the plain


# ---------------------------------------------------------------- the route
def _lp():
    means = np.zeros((2, 4), dtype=np.float32)
    means[1, 0] = 4.0
    return bt.gaussian_mixture(means)


def test_config_takes_pallas_accept():
    assert dream.DreamConfig(8).pallas_accept is False
    cfg = dream.DreamConfig(8, pallas_accept=True)
    dream.check_config(cfg, "cpu")
    dream.make_step(_lp(), cfg)


@pytest.mark.parametrize("base", [{}, {"fused": True},
                                  {"fused": True, "fused_rng": "kernel"}],
                         ids=["per_generation", "fused", "fused_kernel_rng"])
def test_api_pallas_accept_takes_the_default_route_decisions(base):
    def run(**kw):
        s = bt.DreamZs(_lp(), n_chains=8, seed=3, burnin_gens=30,
                       archive_thin=5, archive_capacity=64, device="cpu", **kw)
        s.run_mcmc(60, np.zeros(4, np.float32), spread=2.0)
        return s

    ref = run(**base)
    before = accept_select.launches
    got = run(**base, pallas_accept=True)
    assert accept_select.launches == before
    assert 0 < float(np.mean(ref._history["accepted"])) < 1
    for key in ref._history:
        np.testing.assert_array_equal(got._history[key], ref._history[key],
                                      err_msg=f"{base} {key}")
    for a, b in ((got.final_state.logp_sum, ref.final_state.logp_sum),
                 (got.final_state.x, ref.final_state.x)):
        assert torch.equal(a, b)
