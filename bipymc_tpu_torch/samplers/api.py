"""User-facing sampler classes with the reference's ergonomics.

Counterpart of the parts of ``bipymc_tpu/samplers/api.py`` that DREAM-zs
uses: ``sampler = DreamZs(log_prob, ...); sampler.run_mcmc(n, theta_0)``,
results through ``chain`` / ``get_chain`` / ``acceptance_fraction``, the
R̂-stopped ``run_mcmc_until``, the continuation contract and ``reset``.

``log_prob`` is a **batched** target, ``[n, d] → [n]`` (the JAX package
maps a per-row function with ``vmap``; here the batch dimension is
written out). Every entry point runs on ``device="cuda"`` unless the
caller passes another device; nothing moves to the CPU because CUDA is
missing.

Randomness: one seed gives three generators on the device (start
points, initial archive, run), so ``reset()`` reruns identically and a
continued run draws fresh words from where the last run stopped.
"""

import warnings

import numpy as np
import torch

from bipymc_tpu_torch.core.rng import seeded_generators
from bipymc_tpu_torch.parallel.pool import ChainPool
from bipymc_tpu_torch.samplers import dream
from bipymc_tpu_torch.utils.diagnostics import acceptance_fraction
from bipymc_tpu_torch.utils.init import var_ball

_FUSED_ITEM = "ROADMAP Queue A item 5 (DREAM-zs fused engine)"
_MESH_ITEM = "ROADMAP Queue A item 15 (multi-GPU)"
_API_ITEM = "ROADMAP Queue A item 7 (pool and API)"


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

    def _continuing(self, theta_0, spread=1.0):
        """Continuation contract: after a run, further runs continue from
        ``final_state`` and IGNORE start-only arguments (with a warning).
        Call ``reset()`` first to start afresh."""
        if self._final_state is None:
            if theta_0 is None:
                raise ValueError(
                    "theta_0 is required for the first run (no state to "
                    "continue from)")
            return False
        ignored = ["theta_0"] if theta_0 is not None else []
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


class DreamZs(McmcSampler):
    """DREAM-zs: archive-Z DE proposals + snooker + CR adaptation, on the
    per-generation engine (``samplers/dream.py``), one device.

    The fused multi-generation engine (``fused=True`` and its knobs) and
    the mesh are not ported yet; passing any of them raises
    ``NotImplementedError``.
    """

    def __init__(self, log_like_fn, n_chains=8, seed=0, dtype=torch.float32,
                 mesh=None, archive_capacity=None, n_archive_init=None,
                 fused=False, fused_rng=None, fused_z_update=None,
                 fused_gather=None, log_prob_block=None, device="cuda",
                 **config_kw):
        if mesh is not None:
            raise NotImplementedError(f"mesh= is not ported: {_MESH_ITEM}")
        fused_opts = {"fused": fused or None, "fused_rng": fused_rng,
                      "fused_z_update": fused_z_update,
                      "fused_gather": fused_gather,
                      "log_prob_block": log_prob_block}
        passed = [k for k, v in fused_opts.items() if v is not None]
        if passed:
            raise NotImplementedError(
                f"{passed}: the fused engine is not ported: {_FUSED_ITEM}")
        super().__init__(log_like_fn, seed=seed, dtype=dtype, device=device)
        self.n_chains = int(n_chains)
        self.cfg = dream.DreamConfig(n_chains=self.n_chains, **config_kw)
        dream.check_config(self.cfg, self.device)
        self.archive_capacity = archive_capacity
        self.n_archive_init = n_archive_init
        self._gen_run = None
        self._pool_obj = ChainPool(
            step=dream.make_step(log_like_fn, self.cfg),
            n_words=lambda d: dream.n_words(self.cfg, d),
            collect_fn=self._collect)

    @staticmethod
    def _collect(state, info):
        return {"x": state.x, "logp": info.logp,
                "accepted": info.accepted, "snooker": info.snooker}

    def reset(self):
        self._gen_run = None
        return super().reset()

    def _ensure_state(self, theta_0, spread, n_gens_hint,
                      auto_capacity_cap=65536):
        if self._continuing(theta_0, spread=spread):
            return self._final_state
        g_init, g_z, self._gen_run = seeded_generators(
            self.seed, 3, self.device)
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
        final_state, history = self._pool_obj.run(
            state, self._gen_run, n_gens, thin=thin, t0=self._steps_run)
        self._store(final_state, history, n_gens)
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        """Run until the streamed R̂ < rhat_tol (BASELINE config 5).

        Keeps no history; returns a dict with ``steps`` taken, the final
        ``rhat`` [d], and the streamed per-chain ``mean``/``var``
        ([n_chains, d]), as host NumPy.
        """
        # the auto ring is capped at 32 population snapshots, as in the
        # JAX package: chunk·max_chunks is a worst case a run rarely nears
        state = self._ensure_state(
            theta_0, spread, chunk * max_chunks,
            auto_capacity_cap=max(8192, 32 * self.n_chains))
        final_state, info = self._pool_obj.run_until(
            state, self._gen_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run)
        self._final_state = final_state
        self._sync()
        self._steps_run += int(info["steps"])
        return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in info.items()}
