"""User-facing sampler classes with the reference's ergonomics.

Counterpart of the parts of ``bipymc_tpu/samplers/api.py`` that DREAM-zs,
the random-walk family (``Metropolis``, ``AdaptiveMetropolis``,
``DrMetropolis``, ``Dram``) and the stretch ensemble sampler
(``EnsembleSampler``) use: ``sampler = Dram(log_prob, ...);
sampler.run_mcmc(n, theta_0)``, results through ``chain`` / ``get_chain``
/ ``acceptance_fraction``, the R̂-stopped ``run_mcmc_until``, the
continuation contract and ``reset``.

``log_prob`` is a **batched** target, ``[n, d] → [n]`` (the JAX package
maps a per-row function with ``vmap``; here the batch dimension is
written out). Every entry point runs on ``device="cuda"`` unless the
caller passes another device; nothing moves to the CPU because CUDA is
missing.

Randomness: one seed gives a generator for the start points (and, for
DREAM-zs, one for the initial archive) and a key whose words depend on
the global step alone (``core/rng.StepWords``), so the per-generation
and fused engines read the same words. ``reset()`` reruns identically
and a continued run draws fresh words from where the last run stopped.
"""

import warnings

import numpy as np
import torch

from bipymc_tpu_torch.core.rng import StepWords, seed_ints
from bipymc_tpu_torch.models.targets import KERNEL_TARGETS, kernel_form
from bipymc_tpu_torch.ops.fused_stretch import check_walkers
from bipymc_tpu_torch.parallel.pool import ChainPool
from bipymc_tpu_torch.samplers import dream, rw, stretch
from bipymc_tpu_torch.samplers.dream_fused import (GATHER_MODES,
                                                   check_fusable,
                                                   check_gather_mode,
                                                   make_chunk_runner)
from bipymc_tpu_torch.samplers.rw_fused import (check_rw_fusable,
                                                make_rw_chunk_runner)
from bipymc_tpu_torch.samplers.stretch_fused import \
    make_chunk_runner as make_stretch_runner
from bipymc_tpu_torch.utils.diagnostics import acceptance_fraction
from bipymc_tpu_torch.utils.init import var_ball

_FUSED_ITEM = ("ROADMAP Queue A item 18b (the rest of the DREAM-zs fused "
               "engine)")
_MESH_ITEM = "ROADMAP Queue A item 15 (multi-GPU)"
_API_ITEM = "ROADMAP Queue A item 7 (pool and API)"
_RW_BLOCK_ITEM = ("ROADMAP Queue A item 10 (RW family: user targets in "
                  "kernel B4)")
_BLOCK_ITEM = ("ROADMAP Queue A item 18b (user targets in the fused "
               "kernels)")


def _as_2d_theta0(theta_0, n_chains, gen, spread, dtype, device):
    """Accept [d] (dispersed via var_ball) or [n_chains, d] start points."""
    theta_0 = torch.as_tensor(theta_0, dtype=dtype, device=device)
    if theta_0.dim() == 1:
        if n_chains == 1:
            return theta_0[None, :]
        var = torch.full((theta_0.shape[-1],), spread ** 2, dtype=dtype)
        return var_ball(gen, var, n_chains, center=theta_0, dtype=dtype,
                        device=device)
    if theta_0.shape[0] != n_chains:
        raise ValueError(
            f"theta_0 has {theta_0.shape[0]} rows but n_chains={n_chains}")
    return theta_0


class McmcSampler:
    """Base: history access and acceptance stats shared by the samplers.

    History accumulates as a list of device-resident chunks (one per
    ``run_mcmc`` call); the host copy is made once, at first access.
    """

    def __init__(self, log_like_fn, seed=0, dtype=torch.float32,
                 device="cuda"):
        self.log_like_fn = log_like_fn
        self.seed = int(seed)
        self.dtype = dtype
        self.device = torch.device(device)
        self._chunks = []          # each: dict of [T, M, ...] tensors
        self._history_np = None
        self._super_chain_np = None
        self._final_state = None
        self._steps_run = 0

    # -- results ----------------------------------------------------------
    @property
    def _history(self):
        """Full kept history as host NumPy (copied once per run)."""
        self._require_run()
        if self._history_np is None:
            self._history_np = {
                k: np.concatenate([c[k].cpu().numpy() if isinstance(
                    c[k], torch.Tensor) else c[k] for c in self._chunks])
                for k in self._chunks[0]}
            self._chunks = [self._history_np]
        return self._history_np

    @property
    def chain(self):
        """History of chain 0 as host NumPy, shape [n_kept, d]."""
        return self._history["x"][:, 0, :]

    @property
    def super_chain(self):
        """All chains, [n_chains, n_kept, d] (host NumPy, cached)."""
        if self._super_chain_np is None:
            self._super_chain_np = np.ascontiguousarray(
                np.swapaxes(self._history["x"], 0, 1))
        return self._super_chain_np

    def get_chain(self, discard=0, thin=1, flat=False):
        sc = self.super_chain[:, discard::thin, :]
        return sc.reshape(-1, sc.shape[-1]) if flat else sc

    @property
    def acceptance_fraction(self):
        """Per-chain acceptance fraction over the kept history."""
        return acceptance_fraction(
            np.swapaxes(self._history["accepted"], 0, 1))

    @property
    def final_state(self):
        """Sampler state after ``run_mcmc`` or ``run_mcmc_until``."""
        if self._final_state is None:
            raise RuntimeError("call run_mcmc or run_mcmc_until first")
        return self._final_state

    def reset(self):
        """Discard history, final state and step counter; the next run
        starts afresh from its ``theta_0`` and the sampler's seed."""
        self._chunks = []
        self._history_np = None
        self._super_chain_np = None
        self._final_state = None
        self._steps_run = 0
        return self

    def _require_run(self):
        if not self._chunks:
            raise RuntimeError("call run_mcmc first")

    def _continuing(self, theta_0, spread=1.0, cov_est=None):
        """Continuation contract: after a run, further runs continue from
        ``final_state`` and IGNORE start-only arguments (with a warning).
        Call ``reset()`` first to start afresh."""
        if self._final_state is None:
            if theta_0 is None:
                raise ValueError(
                    "theta_0 is required for the first run (no state to "
                    "continue from)")
            return False
        ignored = [name for name, v in
                   (("theta_0", theta_0), ("cov_est", cov_est))
                   if v is not None]
        if spread != 1.0:
            ignored.append("spread")
        if ignored:
            warnings.warn(
                f"continuing from the previous run's state: {ignored} "
                "only affect a fresh start and are IGNORED. Pass "
                "theta_0=None to continue silently, or call reset() to "
                "restart from a new start point.", UserWarning, stacklevel=3)
        return True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _store(self, final_state, history, n_steps):
        self._final_state = final_state
        self._chunks.append(history)
        # wait once, so wall-clock timing by callers is honest
        self._sync()
        self._history_np = None
        self._super_chain_np = None
        self._steps_run += n_steps


def _host(info):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in info.items()}


class EnsembleSampler(McmcSampler):
    """Affine-invariant ensemble sampler: the Goodman & Weare (2010)
    stretch move with emcee's red-black parallel update
    (``samplers/stretch.py``). Use n_chains ≥ 2d + 2 walkers.

    ``fused=True`` runs every ``run_mcmc`` with ``thin == 1`` and every
    ``run_mcmc_until`` on the fused engine (``samplers/stretch_fused.py``:
    64 generations per launch of kernel B9, a shorter last chunk). Both
    engines read the same words for the same generation
    (``core/rng.StepWords``), so they take the same decisions. The fused
    engine takes at most 1,024 walkers, is float32-only and needs a
    target with a kernel form (``models/targets.KERNEL_TARGETS``).

    Not ported, raising ``NotImplementedError``: ``move="walk"``,
    ``mesh=``, ``log_prob_block`` and ``progress_every``.
    """

    def __init__(self, log_like_fn, n_chains=32, seed=0, dtype=torch.float32,
                 mesh=None, fused=False, log_prob_block=None, device="cuda",
                 **config_kw):
        if mesh is not None:
            raise NotImplementedError(f"mesh= is not ported: {_MESH_ITEM}")
        if log_prob_block is not None:
            raise NotImplementedError(
                f"log_prob_block= is not ported: {_BLOCK_ITEM}")
        super().__init__(log_like_fn, seed=seed, dtype=dtype, device=device)
        self.n_chains = int(n_chains)
        self.cfg = stretch.StretchConfig(n_chains=self.n_chains, **config_kw)
        self._pool_obj = ChainPool(
            step=stretch.make_step(log_like_fn, self.cfg),
            n_words=stretch.n_words, collect_fn=self._collect)
        self.fused = bool(fused)
        self._words = None
        if self.fused:
            check_walkers(self.n_chains)
            if dtype != torch.float32:
                raise ValueError("fused=True is float32-only (kernel B9 "
                                 "computes in float32)")
            if kernel_form(log_like_fn) is None:
                raise ValueError(
                    "fused=True needs a target that kernel B9 evaluates in "
                    f"device code: {', '.join(KERNEL_TARGETS)} "
                    "(bipymc_tpu_torch.models.targets); run other targets "
                    "with fused=False")

    @staticmethod
    def _collect(state, info):
        return {"x": state.x, "logp": info.logp, "accepted": info.accepted}

    def reset(self):
        self._words = None
        return super().reset()

    def _ensure_state(self, theta_0, spread):
        if self._continuing(theta_0, spread=spread):
            return self._final_state
        init_seed, run_key = seed_ints(self.seed, 2)
        g_init = torch.Generator(device=self.device).manual_seed(init_seed)
        self._words = StepWords(run_key)
        x0 = _as_2d_theta0(theta_0, self.n_chains, g_init, spread,
                           self.dtype, self.device)
        return stretch.init(x0, self.log_like_fn)

    def run_mcmc(self, n_gens, theta_0=None, thin=1, spread=1.0,
                 progress_every=None):
        """Run ``n_gens`` generations from ``theta_0`` ([d], dispersed by
        ``spread``, or [n_chains, d]), keeping every ``thin``-th."""
        if progress_every is not None:
            raise NotImplementedError(
                f"progress_every is not ported: {_API_ITEM}")
        state = self._ensure_state(theta_0, spread)
        if self.fused and thin == 1:
            final_state, history = make_stretch_runner(
                self.log_like_fn, self.cfg)(state, self._words, n_gens,
                                            self._steps_run)
        else:
            final_state, history = self._pool_obj.run(
                state, self._words, n_gens, thin=thin, t0=self._steps_run)
        self._store(final_state, history, n_gens)
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        """Run until the streamed R̂ < rhat_tol. Keeps no history; returns
        a dict with ``steps`` taken, the final ``rhat`` [d], and the
        streamed per-walker ``mean``/``var`` ([n_chains, d]), as host
        NumPy. With ``fused=True`` every chunk runs on the fused engine."""
        state = self._ensure_state(theta_0, spread)
        runner = (make_stretch_runner(self.log_like_fn, self.cfg,
                                      collect="rhat") if self.fused
                  else None)
        final_state, info = self._pool_obj.run_until(
            state, self._words, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run, chunk_runner=runner)
        self._final_state = final_state
        self._sync()
        self._steps_run += int(info["steps"])
        return _host(info)


class DreamZs(McmcSampler):
    """DREAM-zs: archive-Z DE proposals + snooker + CR adaptation, on one
    device.

    ``fused=True`` runs the aligned post-burn-in generations on the fused
    engine (``samplers/dream_fused.py``: ``archive_thin`` generations per
    launch of kernel B1), with the per-generation engine
    (``samplers/dream.py``) for burn-in and any unaligned head or tail,
    and for every run with ``thin != 1``. Both engines read the same words
    for the same generation (``core/rng.StepWords``), so they take the
    same decisions. The fused engine is float32-only and needs a target
    with a kernel form (``models/targets.KERNEL_TARGETS``).

    ``fused_rng="kernel"`` (as ``bench.py`` runs the JAX package): B1
    draws each generation's crossover uniforms, multiplicative uniforms
    and normals itself, from Philox keyed by the run key, the generation
    and the chain (``core/rng.kernel_draw_bits``), so the fused chunks
    sample the same distributions as stream mode with other draws. On
    the CPU the plain version draws the same words in torch ops (the JAX
    package refuses the mode off the TPU). With ``fused=False`` it is
    ignored, as in the JAX package.

    ``fused_gather="kernel"`` gathers each fused chunk's archive rows
    with kernel B11 (``ops/gather_rows.py``) instead of torch indexing;
    ``gather_kernel=True``, a ``DreamConfig`` field, does the same in the
    per-generation engine. The rows, and so the run, are the same. Both
    are off by default, as in the JAX package.

    ``pallas_accept=True``, a ``DreamConfig`` field, runs the
    per-generation engine's accept and state update through kernel B10
    (``ops/accept_select.py``) in one launch: with ``fused=True`` in
    burn-in and any unaligned head or tail, as the chunks' kernel B1
    carries its own accept. Its ops are exact, so the run is the same
    bit for bit. Off by default, as in the JAX package.

    Not ported, raising ``NotImplementedError``: ``mesh=``,
    ``fused=True`` with ``fused_z_update > 1``, ``fused_gather="pergen"``
    and ``log_prob_block``. ``fused_z_update < 1``, or ``> 1`` without
    ``fused=True``, raises the JAX package's ``ValueError``.
    """

    def __init__(self, log_like_fn, n_chains=8, seed=0, dtype=torch.float32,
                 mesh=None, archive_capacity=None, n_archive_init=None,
                 fused=False, fused_rng="stream", fused_z_update=1,
                 fused_gather="block", log_prob_block=None, device="cuda",
                 **config_kw):
        if mesh is not None:
            raise NotImplementedError(f"mesh= is not ported: {_MESH_ITEM}")
        # the JAX package's order (bipymc_tpu/samplers/api.py:1224-1240)
        if fused_gather not in GATHER_MODES:
            raise ValueError(
                f"fused_gather={fused_gather!r}: expected one of "
                f"{GATHER_MODES}")
        if fused_z_update < 1:
            raise ValueError(
                f"fused_z_update={fused_z_update}: must be >= 1")
        if fused_z_update > 1 and not fused:
            raise ValueError(
                "fused_z_update > 1 is a fused-engine execution knob; "
                "pass fused=True")
        if fused_gather != "block" and not fused:
            raise ValueError(
                "fused_gather is a fused-engine execution knob; pass "
                "fused=True (the per-generation engine's equivalent is "
                "the DreamConfig field gather_kernel=True)")
        if fused_rng not in ("stream", "kernel"):
            raise ValueError(
                f"fused_rng={fused_rng!r}: expected 'stream' or 'kernel'")
        check_gather_mode(fused_gather)
        # past the checks above, fused_z_update != 1 means fused=True
        unported = [name for name, v, default in (
            ("fused_z_update", fused_z_update, 1),
            ("log_prob_block", log_prob_block, None)) if v != default]
        if unported:
            raise NotImplementedError(
                f"{unported}: not ported (the fused engine runs one archive "
                "update a chunk and the built-in targets): "
                f"{_FUSED_ITEM}")
        super().__init__(log_like_fn, seed=seed, dtype=dtype, device=device)
        self.n_chains = int(n_chains)
        self.cfg = dream.DreamConfig(n_chains=self.n_chains, **config_kw)
        dream.check_config(self.cfg, self.device)
        self.archive_capacity = archive_capacity
        self.n_archive_init = n_archive_init
        self.fused = bool(fused)
        self.fused_rng = fused_rng
        self.fused_gather = fused_gather
        self._words = None
        if self.fused:
            check_fusable(self.cfg)
            if dtype != torch.float32:
                raise ValueError("fused=True is float32-only (kernel B1 "
                                 "computes in float32)")
            if kernel_form(log_like_fn) is None:
                raise ValueError(
                    "fused=True needs a target with a kernel form, which "
                    "kernel B1 evaluates in device code: "
                    f"{', '.join(KERNEL_TARGETS)} "
                    "(bipymc_tpu_torch.models.targets); run other targets "
                    "with fused=False")
        self._pool_obj = ChainPool(
            step=dream.make_step(log_like_fn, self.cfg),
            n_words=lambda d: dream.n_words(self.cfg, d),
            collect_fn=self._collect)

    @staticmethod
    def _collect(state, info):
        return {"x": state.x, "logp": info.logp,
                "accepted": info.accepted, "snooker": info.snooker}

    def reset(self):
        self._words = None
        return super().reset()

    def _ensure_state(self, theta_0, spread, n_gens_hint,
                      auto_capacity_cap=65536):
        if self._continuing(theta_0, spread=spread):
            return self._final_state
        init_seed, z_seed, run_key = seed_ints(self.seed, 3)
        g_init = torch.Generator(device=self.device).manual_seed(init_seed)
        g_z = torch.Generator(device=self.device).manual_seed(z_seed)
        self._words = StepWords(run_key)
        x0 = _as_2d_theta0(theta_0, self.n_chains, g_init, spread,
                           self.dtype, self.device)
        capacity = self.archive_capacity
        if capacity is None:
            appended = self.n_chains * (
                n_gens_hint // self.cfg.archive_thin + 1)
            capacity = int(min(max(256, appended), auto_capacity_cap, 65536))
        n_z0 = self.n_archive_init or max(
            dream.n_rows(self.cfg), self.n_chains, 10)
        n_z0 = min(n_z0, capacity)
        center = torch.mean(x0, dim=0)
        var = torch.clamp_min(torch.var(x0, dim=0, correction=0),
                              spread ** 2)
        z0 = var_ball(g_z, var, n_z0, center=center, dtype=self.dtype,
                      device=self.device)
        return dream.init(x0, self.log_like_fn, self.cfg,
                          archive_capacity=capacity, z0=z0)

    def run_mcmc(self, n_gens, theta_0=None, thin=1, spread=1.0,
                 progress_every=None):
        """Run ``n_gens`` generations, keeping every ``thin``-th."""
        if progress_every is not None:
            raise NotImplementedError(
                f"progress_every is not ported: {_API_ITEM}")
        state = self._ensure_state(theta_0, spread, n_gens)
        if not (self.fused and thin == 1):
            final_state, history = self._pool_obj.run(
                state, self._words, n_gens, thin=thin, t0=self._steps_run)
            self._store(final_state, history, n_gens)
            return self
        # [per-generation: burn-in + alignment] → [fused steady state] →
        # [per-generation remainder], each stored as its own history chunk
        G = self.cfg.archive_thin
        t = self._steps_run
        n1 = max(0, self.cfg.burnin_gens - t)
        if (t + n1) % G:
            n1 += G - (t + n1) % G
        n1 = min(n1, n_gens)
        n2 = (n_gens - n1) // G * G
        for kind, n_seg in (("per_gen", n1), ("fused", n2),
                            ("per_gen", n_gens - n1 - n2)):
            if n_seg == 0:
                continue
            t = self._steps_run
            if kind == "fused":
                final_state, history = make_chunk_runner(
                    self.log_like_fn, self.cfg, rng=self.fused_rng,
                    gather_mode=self.fused_gather)(
                        state, self._words, n_seg, t)
            else:
                final_state, history = self._pool_obj.run(
                    state, self._words, n_seg, thin=1, t0=t)
            self._store(final_state, history, n_seg)
            state = final_state
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        """Run until the streamed R̂ < rhat_tol (BASELINE config 5).

        Keeps no history; returns a dict with ``steps`` taken, the final
        ``rhat`` [d], and the streamed per-chain ``mean``/``var``
        ([n_chains, d]), as host NumPy.

        With ``fused=True`` ``chunk`` is rounded up to a multiple of
        ``archive_thin``, and the chunks that start after burn-in run on
        the fused engine, unless the run continues from a generation
        that is not a multiple of ``archive_thin``: that run stays on the
        per-generation engine.
        """
        chunk_runner, fused_after = None, 0
        if self.fused:
            G = self.cfg.archive_thin
            if chunk % G:
                chunk += G - chunk % G
            if self._steps_run % G == 0:
                chunk_runner = make_chunk_runner(
                    self.log_like_fn, self.cfg, collect="rhat",
                    rng=self.fused_rng, gather_mode=self.fused_gather)
                fused_after = self.cfg.burnin_gens
        # the auto ring is capped at 32 population snapshots, as in the
        # JAX package: chunk·max_chunks is a worst case a run rarely nears
        state = self._ensure_state(
            theta_0, spread, chunk * max_chunks,
            auto_capacity_cap=max(8192, 32 * self.n_chains))
        final_state, info = self._pool_obj.run_until(
            state, self._words, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run, chunk_runner=chunk_runner,
            fused_after=fused_after)
        self._final_state = final_state
        self._sync()
        self._steps_run += int(info["steps"])
        return _host(info)


# ===========================================================================
# Random-walk family (batched over chains)
# ===========================================================================

def _rw_position(state):
    """The RW family's position, by identity (``ChainPool.run_until``
    checks it against the fused runner's ``position_field``)."""
    return state.theta


class _RwSampler(McmcSampler):
    """The random-walk family on one device, per-step or fused.

    ``fused=True`` runs aligned steady segments on the fused engine
    (``samplers/rw_fused.py``: K steps per launch of kernel B4,
    K = ``adapt_interval`` for the adaptive family, else 100), with the
    per-step engine for the unaligned head and the remainder. Both
    engines read the same words for the same global step
    (``core/rng.StepWords``), so they take the same accept decisions.
    The fused engine is float32-only and needs a target with a kernel
    form (``models/targets.KERNEL_TARGETS``); ``log_prob_block=`` raises
    ``NotImplementedError``.
    """

    _make_config = staticmethod(rw.metropolis_config)

    def __init__(self, log_like_fn, seed=0, n_chains=1, dtype=torch.float32,
                 fused=False, log_prob_block=None, device="cuda",
                 **config_kw):
        if log_prob_block is not None:
            raise NotImplementedError(
                f"log_prob_block= is not ported: {_RW_BLOCK_ITEM}")
        super().__init__(log_like_fn, seed=seed, dtype=dtype, device=device)
        self.n_chains = int(n_chains)
        self.cfg = self._make_config(**config_kw)
        self.fused = bool(fused)
        self._runner = None
        self._words = None
        if self.fused:
            check_rw_fusable(self.cfg)
            if dtype != torch.float32:
                raise ValueError("fused=True is float32-only (kernel B4 "
                                 "computes in float32)")
            if kernel_form(log_like_fn) is None:
                raise ValueError(
                    "fused=True needs a target that kernel B4 evaluates in "
                    f"device code: {', '.join(KERNEL_TARGETS)} "
                    "(bipymc_tpu_torch.models.targets); run other targets "
                    "with fused=False")
            self._runner = make_rw_chunk_runner(
                log_like_fn, self.cfg, self.n_chains,
                chunk_steps=self._fused_K)
        self._pool = ChainPool(step=rw.make_step(log_like_fn, self.cfg),
                               n_words=rw.n_words, collect_fn=self._collect)

    @property
    def _fused_K(self):
        return int(self.cfg.adapt_interval) if self.cfg.adapt else 100

    @staticmethod
    def _collect(state, info):
        return {"x": state.theta, "logp": info.logp,
                "accepted": info.accepted}

    def _prepare(self, theta_0, cov_est, spread):
        """The start state: a fresh one from ``theta_0`` and the seed, or
        the last run's final state."""
        if self._continuing(theta_0, spread=spread, cov_est=cov_est):
            return self._final_state
        init_seed, run_key = seed_ints(self.seed, 2)
        g_init = torch.Generator(device=self.device).manual_seed(init_seed)
        self._words = StepWords(run_key)
        theta0 = _as_2d_theta0(theta_0, self.n_chains, g_init, spread,
                               self.dtype, self.device)
        d = theta0.shape[-1]
        if cov_est is None:
            cov_est = torch.eye(d, dtype=self.dtype) * spread ** 2
        cov_est = torch.as_tensor(np.asarray(cov_est), dtype=self.dtype,
                                  device=self.device)
        return rw.init(theta0, self.log_like_fn, cov_est)

    def _per_step(self, state, n_steps, thin=1):
        return self._pool.run(state, self._words, n_steps, thin=thin,
                              t0=self._steps_run, position_fn=_rw_position)

    def run_mcmc(self, n_samples, theta_0=None, cov_est=None, thin=1,
                 spread=1.0, progress_every=None):
        """Run ``n_samples`` steps from ``theta_0`` ([d] or [n_chains, d]),
        keeping every ``thin``-th.

        cov_est: the initial proposal covariance ([d] diagonal or [d, d];
        default: identity scaled by ``spread²``).
        """
        if progress_every is not None:
            raise NotImplementedError(
                f"progress_every is not ported: {_API_ITEM}")
        state = self._prepare(theta_0, cov_est, spread)
        if not (self.fused and thin == 1):
            final_state, history = self._per_step(state, n_samples, thin)
            self._store(final_state, history, n_samples)
            return self
        # [per-step to a chunk boundary] → [fused K-step chunks] →
        # [per-step remainder]; only the adaptive family needs its chunk
        # starts on refresh boundaries (t % K == 0)
        K = self._fused_K
        n1 = (K - self._steps_run % K) % K if self.cfg.adapt else 0
        n1 = min(n1, n_samples)
        n2 = (n_samples - n1) // K * K
        for kind, n_seg in (("per_step", n1), ("fused", n2),
                            ("per_step", n_samples - n1 - n2)):
            if n_seg == 0:
                continue
            if kind == "fused":
                final_state, history = self._runner(
                    state, self._words, n_seg, self._steps_run)
            else:
                final_state, history = self._per_step(state, n_seg)
            self._store(final_state, history, n_seg)
            state = final_state
        return self

    def run_mcmc_until(self, theta_0=None, cov_est=None, rhat_tol=1.05,
                       chunk=100, max_chunks=200, warmup_chunks=2,
                       spread=1.0):
        """Run until the streamed R̂ across the chains drops below
        ``rhat_tol`` (needs n_chains ≥ 2). Keeps no history; returns a
        dict with ``steps``, the final ``rhat`` [d] and the per-chain
        ``mean`` / ``var`` [n_chains, d], as host NumPy.

        With ``fused=True`` the chunk is rounded up to a multiple of K and
        every chunk is fused, unless an adaptive sampler continues from a
        step that is not a multiple of K: that run stays per-step.
        """
        if self.n_chains < 2:
            raise ValueError("R-hat early stop needs n_chains >= 2")
        state = self._prepare(theta_0, cov_est, spread)
        chunk_runner = None
        if self.fused:
            K = self._fused_K
            if chunk % K:
                chunk += K - chunk % K
            if not self.cfg.adapt or self._steps_run % K == 0:
                chunk_runner = self._runner
        final_state, info = self._pool.run_until(
            state, self._words, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            position_fn=_rw_position, t0=self._steps_run,
            chunk_runner=chunk_runner)
        self._final_state = final_state
        self._sync()
        self._steps_run += int(info["steps"])
        return _host(info)


class Metropolis(_RwSampler):
    """Metropolis-Hastings with a Gaussian random walk."""
    _make_config = staticmethod(rw.metropolis_config)


class AdaptiveMetropolis(_RwSampler):
    """Haario adaptive Metropolis."""
    _make_config = staticmethod(rw.adaptive_metropolis_config)


class DrMetropolis(_RwSampler):
    """Two-stage delayed-rejection Metropolis."""
    _make_config = staticmethod(rw.dr_metropolis_config)


class Dram(_RwSampler):
    """DRAM: delayed rejection with adaptive Metropolis."""
    _make_config = staticmethod(rw.dram_config)
