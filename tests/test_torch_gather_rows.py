"""Kernel B11, the archive row gather, and the two routes through it, on
the CPU.

The port's plain version (``ops/gather_rows.py::gather_rows_reference``,
what the dispatcher runs on a CPU tensor) is held bit-equal to the JAX
package's ``gather_rows_pallas(interpret=True)`` on the same NumPy
inputs: index shapes (37,), (4, 9) and (10, 16, 7) into [512, 100],
duplicate rows (with ``rows_per_cell=4`` and the default), the empty
set, indices below 0 and at or above the capacity (clamped, not
wrapped), int64 indices, and float64 and bfloat16 buffers. A copy is a
copy, so every case is exact.

The routes: ``make_chunk_runner(gather_mode="kernel")`` must be bit-equal
to ``"block"`` in both RNG modes and with ``collect="rhat"``, and the
port's runner with ``gather_mode="kernel"`` must take the JAX package's
runner's decisions with the same mode in stream mode, on the JAX
runner's own words (the pairing of ``tests/test_gather_rows.py::
test_fused_engine_gather_kernel_matches_block``): decisions identical, x,
logp and the archive within rtol 1e-5 / atol 1e-5 (the tolerance of
``tests/test_torch_fused_chunk.py``: the packages sum over d and the
modes in other orders). The per-generation step with
``gather_kernel=True`` is held to the JAX step in
``tests/test_torch_dream_slice.py``. Last, the API's checks of the two
flags, in the JAX package's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bipymc_tpu_torch as bt
from bipymc_tpu.core.rng import step_key
from bipymc_tpu.models import targets as jtargets
from bipymc_tpu.ops.gather_rows import gather_rows_pallas
from bipymc_tpu.samplers import dream as jdream
from bipymc_tpu.samplers.dream_fused import make_chunk_runner as jax_runner
from bipymc_tpu_torch import convert
from bipymc_tpu_torch.ops.gather_rows import (gather_rows,
                                              gather_rows_reference)
from bipymc_tpu_torch.samplers import dream
from bipymc_tpu_torch.samplers.dream_fused import make_chunk_runner

torch.set_num_threads(2)

RTOL = ATOL = 1e-5


def _buf(cap, d, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((cap, d)).astype(dtype)


def _both(buf, idx, **jax_kw):
    """The port's dispatcher on CPU tensors, and the JAX kernel in
    interpret mode, on the same arrays; as NumPy."""
    port = gather_rows(torch.from_numpy(buf), torch.from_numpy(idx))
    ref = gather_rows_pallas(jnp.asarray(buf), jnp.asarray(idx),
                             interpret=True, **jax_kw)
    return port.numpy(), np.asarray(ref)


# ---------------------------------------------------------- the plain version
@pytest.mark.parametrize("shape", [(37,), (4, 9), (10, 16, 7)])
def test_plain_matches_pallas_interpret(shape):
    buf = _buf(512, 100, 0)
    idx = np.random.default_rng(1).integers(0, 512, shape).astype(np.int32)
    port, ref = _both(buf, idx)
    assert port.shape == (*shape, 100)
    np.testing.assert_array_equal(port, ref)
    direct = gather_rows_reference(torch.from_numpy(buf),
                                   torch.from_numpy(idx))
    np.testing.assert_array_equal(direct.numpy(), ref)


@pytest.mark.parametrize("rows_per_cell", [4, None])
def test_duplicate_rows(rows_per_cell):
    buf = _buf(64, 5, 2)
    idx = np.array([3, 3, 0, 63, 3, 0], np.int32)
    kw = {} if rows_per_cell is None else {"rows_per_cell": rows_per_cell}
    port, ref = _both(buf, idx, **kw)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, buf[idx])


@pytest.mark.parametrize("shape", [(0,), (3, 0)])
def test_empty_index_set(shape):
    buf = _buf(64, 12, 3)
    port, ref = _both(buf, np.zeros(shape, np.int32))
    assert port.shape == ref.shape == (*shape, 12)
    assert port.dtype == np.float32


def test_out_of_range_and_negative_indices_clamp():
    buf = _buf(64, 12, 4)
    idx = np.array([-1000, -5, -1, 0, 1, 63, 64, 1000], np.int32)
    port, ref = _both(buf, idx)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, buf[np.clip(idx, 0, 63)])
    # plain indexing wraps -1 to the last row; the gather reads row 0
    assert not np.array_equal(port[2], buf[-1])
    np.testing.assert_array_equal(port[2], buf[0])


def test_int64_indices():
    buf = _buf(512, 100, 5)
    idx = np.random.default_rng(6).integers(-3, 515, (10, 16, 7))
    port = gather_rows(torch.from_numpy(buf), torch.from_numpy(idx))
    ref = gather_rows_pallas(jnp.asarray(buf),
                             jnp.asarray(idx.astype(np.int32)),
                             interpret=True)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_float64_buffer():
    buf = _buf(128, 33, 7, np.float64)
    idx = np.random.default_rng(8).integers(-2, 130, (4, 9)).astype(np.int32)
    with jax.enable_x64(True):
        ref = np.asarray(gather_rows_pallas(jnp.asarray(buf),
                                            jnp.asarray(idx),
                                            interpret=True))
    port = gather_rows(torch.from_numpy(buf), torch.from_numpy(idx))
    assert port.dtype == torch.float64 and ref.dtype == np.float64
    np.testing.assert_array_equal(port.numpy(), ref)


def test_bfloat16_buffer():
    buf = _buf(128, 3, 9)
    idx = np.random.default_rng(10).integers(0, 128, (37,)).astype(np.int32)
    port = gather_rows(torch.from_numpy(buf).to(torch.bfloat16),
                       torch.from_numpy(idx))
    ref = gather_rows_pallas(jnp.asarray(buf).astype(jnp.bfloat16),
                             jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(port.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))


def test_dispatcher_rejects_what_it_does_not_take():
    buf, idx = torch.zeros((8, 3)), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[cap, d\]"):
        gather_rows(torch.zeros((2, 8, 3)), idx)
    with pytest.raises(TypeError, match="dtype"):
        gather_rows(buf.to(torch.int32), idx)
    with pytest.raises(TypeError, match="int32 or int64"):
        gather_rows(buf, idx.float())
    with pytest.raises(ValueError, match="empty buf"):
        gather_rows(torch.zeros((0, 3)), idx)
    with pytest.raises(ValueError, match="meta"):
        gather_rows(buf, idx.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        gather_rows(buf.to("meta"), idx.to("meta"))
    before = gather_rows.launches
    gather_rows(buf, idx)
    assert gather_rows.launches == before      # the CPU takes the plain


# ---------------------------------------------------------- the fused engine
def _mixture_means(d):
    means = np.zeros((2, d), dtype=np.float32)
    means[1, 0] = 4.0
    return means


def _burned_in(d=6, n=8):
    """A CPU sampler after 20 per-generation generations (burn-in 10,
    archive_thin 5): the state the fused runner starts from."""
    x0 = (2.0 * np.random.default_rng(1).standard_normal((n, d))
          ).astype(np.float32)
    s = bt.DreamZs(bt.gaussian_mixture(_mixture_means(d)), n_chains=n,
                   seed=7, archive_thin=5, burnin_gens=10,
                   archive_capacity=64, device="cpu")
    s.run_mcmc(20, x0)
    return s


def _clone(state):
    return state._replace(archive=state.archive._replace(
        buf=state.archive.buf.clone()))


@pytest.mark.parametrize("rng_mode,collect", [
    ("stream", "all"), ("kernel", "all"), ("stream", "rhat"),
    ("kernel", "rhat")])
def test_fused_gather_kernel_matches_block(rng_mode, collect):
    s = _burned_in()
    out = {mode: make_chunk_runner(s.log_like_fn, s.cfg, collect=collect,
                                   rng=rng_mode, gather_mode=mode)(
        _clone(s.final_state), s._words, 30, 20)
        for mode in ("block", "kernel")}
    (st_b, h_b), (st_k, h_k) = out["block"], out["kernel"]
    assert 0 < float(h_b["accepted"].float().mean()) < 1
    for key in ("logp", "accepted", "snooker"):
        assert torch.equal(h_b[key], h_k[key]), key
    if collect == "all":
        assert torch.equal(h_b["x"], h_k["x"])
    else:
        for key in ("mean", "m2"):
            assert torch.equal(getattr(h_b["rhat"], key),
                               getattr(h_k["rhat"], key)), key
    assert torch.equal(st_b.x, st_k.x)
    assert torch.equal(st_b.archive.buf, st_k.archive.buf)
    assert (st_b.archive.fill, st_b.archive.head, st_b.gen) == \
        (st_k.archive.fill, st_k.archive.head, st_k.gen)


class _JaxWords:
    """The JAX fused runner's words as a port word source: generation t,
    chain i draws ``bits(fold_in(step_key(key, t), i), (n_words,))``."""

    def __init__(self, key):
        self.base = key

    def block(self, t0, n_steps, n, n_words, device):
        draw = jax.jit(lambda k: jax.vmap(lambda i: jax.random.bits(
            jax.random.fold_in(k, i), (n_words,), jnp.uint32))(
                jnp.arange(n, dtype=jnp.int32)))
        blk = np.stack([np.asarray(draw(step_key(self.base, t)))
                        for t in range(t0, t0 + n_steps)])
        return torch.from_numpy(blk.view(np.int32)).to(device)


def _jax_fields(state):
    f = {name: np.asarray(getattr(state, name)) for name in
         ("x", "logp", "cr_p", "cr_cum", "cr_jump", "cr_count",
          "logp_sum", "gen")}
    for name in ("buf", "fill", "head"):
        f[f"archive.{name}"] = np.asarray(getattr(state.archive, name))
    return f


def test_fused_gather_kernel_matches_jax_runner():
    d, n, cap, gens = 6, 8, 64, 20
    means = _mixture_means(d)
    rng = np.random.default_rng(2)
    x0 = (2.0 * rng.standard_normal((n, d))).astype(np.float32)
    z0 = (2.0 * rng.standard_normal((n, d))).astype(np.float32)
    jlp = jtargets.gaussian_mixture(means, sigma=1.0)
    jcfg = jdream.DreamConfig(n_chains=n, archive_thin=5, burnin_gens=0,
                              pallas_proposal=True)
    jstate = jdream.init(jnp.asarray(x0), jlp, jcfg, cap, jnp.asarray(z0))
    key = jax.random.key(5)
    jst, jh = jax_runner(jlp, jcfg, gather_mode="kernel")(jstate, key,
                                                          gens, 0)

    cfg = dream.DreamConfig(n_chains=n, archive_thin=5, burnin_gens=0)
    state = convert.dream_state_from_numpy(_jax_fields(jstate), "cpu")
    st, h = make_chunk_runner(bt.gaussian_mixture(means, sigma=1.0), cfg,
                              gather_mode="kernel")(
        state, _JaxWords(key), gens, 0)

    np.testing.assert_array_equal(h["accepted"].numpy(),
                                  np.asarray(jh["accepted"]))
    np.testing.assert_array_equal(h["snooker"].numpy(),
                                  np.asarray(jh["snooker"]))
    assert 0 < float(h["accepted"].float().mean()) < 1
    for name, a, b in (("x", h["x"], jh["x"]), ("logp", h["logp"], jh["logp"]),
                       ("archive", st.archive.buf, jst.archive.buf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert (st.archive.fill, st.archive.head) == \
        (int(jst.archive.fill), int(jst.archive.head))


# ---------------------------------------------------------------- the API
def _lp():
    return bt.gaussian_mixture(_mixture_means(4))


def test_api_gather_flags_take_the_default_route_decisions():
    def run(**kw):
        s = bt.DreamZs(_lp(), n_chains=8, seed=3, burnin_gens=10,
                       archive_thin=5, archive_capacity=64, device="cpu", **kw)
        s.run_mcmc(40, np.zeros(4, np.float32), spread=2.0)
        return s._history

    for base in ({}, {"fused": True}, {"fused": True, "fused_rng": "kernel"}):
        ref = run(**base)
        flags = {"gather_kernel": True}
        if base:
            flags["fused_gather"] = "kernel"
        got = run(**base, **flags)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key],
                                          err_msg=f"{base} {key}")


def test_api_gather_flag_checks():
    lp = _lp()
    with pytest.raises(ValueError, match="fused_gather"):
        bt.DreamZs(lp, n_chains=8, fused_gather="onehot", device="cpu")
    # the JAX package's order: an unknown mode before fused=False
    with pytest.raises(ValueError, match="expected one of"):
        bt.DreamZs(lp, n_chains=8, fused=True, fused_gather="onehot",
                   device="cpu")
    for mode in ("kernel", "pergen"):
        with pytest.raises(ValueError, match="gather_kernel=True"):
            bt.DreamZs(lp, n_chains=8, fused_gather=mode, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bt.DreamZs(lp, n_chains=8, fused=True, fused_gather="pergen",
                   device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_chunk_runner(lp, dream.DreamConfig(8), gather_mode="pergen")
    with pytest.raises(ValueError, match="gather_mode"):
        make_chunk_runner(lp, dream.DreamConfig(8), gather_mode="onehot")
    # gather_kernel needs an archive to gather from
    with pytest.raises(ValueError, match="use_archive"):
        bt.DreamZs(lp, n_chains=16, gather_kernel=True, use_archive=False,
                   p_snooker=0.0, device="cpu")
    with pytest.raises(ValueError, match="use_archive"):
        dream.make_step(lp, dream.dream_config(16, gather_kernel=True))
