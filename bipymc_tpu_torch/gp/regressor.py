"""Gaussian-process regression: fit, predict, the log marginal
likelihood, hyperparameter training and the GP surrogate.

Counterpart of ``bipymc_tpu/gp/regressor.py``:

  fit:      L = chol(K + σ_n² I);  α = Lᵀ \\ (L \\ y)
  predict:  μ* = k*ᵀ α;  σ*² = k** − ‖L \\ k*‖²
  log-ML:   −½ yᵀα − Σ log L_ii − (n/2) log 2π

The params may carry a leading chain axis (``log_lengthscale`` [C, d],
``log_sigma_f`` and ``log_sigma_n`` [C]): :meth:`GpRegressor._lml_impl`
then returns the C log-MLs at once, the port's form of the reference's
``vmap(_lml_impl)`` (BASELINE config 4's target, one Gram factorisation
per chain per DR stage). With ``batched_chol=True``, float32, C ≥ 8 and
n ≤ 1024 on a CUDA device, that batch goes to kernel B6, which factors
and solves in one launch (the reference's gate at ``:120-122``, "tpu"
read as "cuda"); otherwise it takes the plain route, ``cholesky_ex`` and
``solve_triangular``, as the reference takes XLA's. Either way a Gram
matrix that is not positive definite gives a NaN log-ML, which a sampler
rejects.

``pallas_chol=True`` routes a float32 factorisation with n ≤ 1024 to
kernel B7 (ahead of B6, as the reference's ``_cholesky`` does), and
``pallas_solve=True`` routes the triangular solves to kernel B8; then the
log-ML takes the factor and the solve apart, not B6's fused pair. On a
CPU tensor each wrapper takes its plain version, through the same
``torch.autograd.Function`` the card uses, so the flags give the default
path's numbers there. :meth:`GpRegressor.optimize` maximises the log-ML
with Adam through autograd: ``grad_safe=True``, as in the reference,
skips B6 (its gradient is the generic adjoint), and what it reaches on
the card is B5 and its gradient (n² ≥ 128²) and, with the flags, B7 and
B8 and their gradients. :meth:`GpRegressor.surrogate_log_like` turns a
fit into the batched target of BASELINE config 5.
"""

import math
from typing import Callable, NamedTuple

import torch

from bipymc_tpu_torch.gp.kernels import squared_exp
from bipymc_tpu_torch.ops import pallas_chol as b7
from bipymc_tpu_torch.ops import pallas_solve as b8
from bipymc_tpu_torch.ops.pallas_bchol import (cholesky_batched,
                                               cholesky_solve_batched,
                                               cholesky_solve_plain)

BATCHED_MIN, BATCHED_MAX_N = 8, 1024     # the reference's B6 gate
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


class GpFit(NamedTuple):
    params: dict
    x: torch.Tensor        # [n, d] training inputs
    chol: torch.Tensor     # [n, n] chol(K + σ_n² I)
    alpha: torch.Tensor    # [n]
    y_mean: torch.Tensor   # [] target standardisation (identity: 0, 1)
    y_std: torch.Tensor    # []


def default_params(d, dtype=torch.float32, device="cuda"):
    return {
        "log_lengthscale": torch.zeros((d,), dtype=dtype, device=device),
        "log_sigma_f": torch.zeros((), dtype=dtype, device=device),
        "log_sigma_n": torch.tensor(-2.3, dtype=dtype, device=device),
    }


class GpRegressor:
    """SE-ARD GP regressor (kernel pluggable; see ``gp.kernels``).

    jitter: extra diagonal, times σ_f², that keeps a float32 Cholesky
    SPD; it is floored at 4·n·ε of the params' dtype (:meth:`_diag_shift`).
    normalize_y: standardise the targets before fitting and undo it in
    predict. pallas_chol / pallas_solve: route the factorisation to
    kernel B7 (float32, n ≤ 1024) and the triangular solves to kernel B8
    (float32, n ≤ 4096). batched_chol: route a log-ML batched over chains
    to kernel B6 where the gate allows (module docstring). device: where
    ``fit``, ``predict``, ``log_marginal_likelihood`` and ``optimize``
    put their inputs.
    """

    def __init__(self, kernel: Callable = squared_exp, jitter: float = 1e-5,
                 normalize_y: bool = False, pallas_solve: bool = False,
                 pallas_chol: bool = False, batched_chol: bool = True,
                 device="cuda"):
        self.kernel = kernel
        self.jitter = jitter
        self.normalize_y = normalize_y
        self.pallas_solve = pallas_solve
        self.pallas_chol = pallas_chol
        self.batched_chol = batched_chol
        self.device = torch.device(device)

    # ---- implementations -------------------------------------------------
    def _diag_shift(self, params, n=None):
        """σ_n² + jitter·σ_f², [...], the jitter floored at 4·n·ε(dtype):
        an SE Gram over n clustered points has eigenvalues below the
        dtype's round-off scale (≈ n·ε·σ_f²), so a fixed jitter safe at
        small n falls below it at larger n (the reference's finding,
        ``gp/regressor.py:235-258``)."""
        sn2 = torch.exp(2.0 * params["log_sigma_n"])
        sf2 = torch.exp(2.0 * params["log_sigma_f"])
        jitter = self.jitter
        if n is not None:
            eps = float(torch.finfo(params["log_sigma_f"].dtype).eps)
            jitter = max(jitter, 4.0 * n * eps)
        return sn2 + jitter * sf2

    def _gram(self, params, x):
        n = x.shape[-2]
        k = self.kernel(params, x)
        eye = torch.eye(n, dtype=k.dtype, device=k.device)
        return k + self._diag_shift(params, n)[..., None, None] * eye

    def _normalize(self, y):
        if self.normalize_y:
            y_mean = torch.mean(y)
            y_std = torch.clamp_min(torch.std(y, correction=0), 1e-12)
        else:
            y_mean = torch.zeros((), dtype=y.dtype, device=y.device)
            y_std = torch.ones((), dtype=y.dtype, device=y.device)
        return (y - y_mean) / y_std, y_mean, y_std

    def _cholesky(self, kmat, grad_safe=False):
        """Lower factor of one Gram matrix or a batch of them: kernel B7
        with ``pallas_chol`` (float32, n ≤ 1024), else kernel B6 where
        :meth:`_batched_route` allows and not ``grad_safe``, else the plain
        version; NaN for a matrix that is not positive definite, as
        ``jnp.linalg.cholesky`` gives (``torch.linalg.cholesky`` would
        raise)."""
        if self.pallas_chol and kmat.dtype == torch.float32 and \
                kmat.shape[-1] <= b7.MAX_N:
            return b7.cholesky_pallas(kmat)
        if self._batched_route(kmat) and not grad_safe:
            return cholesky_batched(kmat)
        return b7.cholesky_plain(kmat)

    def _solve_route(self, chol) -> bool:
        return (self.pallas_solve and chol.dtype == torch.float32
                and chol.shape[-1] <= b8.MAX_N)

    def _solve_lower(self, chol, b):
        """L⁻¹ b for b [..., n] or [..., n, m]: kernel B8 with
        ``pallas_solve``."""
        if self._solve_route(chol):
            return b8.tri_solve(chol, b)
        return b8.tri_solve_plain(chol, b)

    def _solve_lower_t(self, chol, b):
        """L⁻ᵀ b."""
        if self._solve_route(chol):
            return b8.tri_solve_t(chol, b)
        return b8.tri_solve_t_plain(chol, b)

    def _batched_route(self, kmat) -> bool:
        return (self.batched_chol and kmat.dim() == 3
                and kmat.dtype == torch.float32
                and kmat.shape[-1] <= BATCHED_MAX_N
                and kmat.shape[0] >= BATCHED_MIN
                and kmat.device.type == "cuda")

    def _fit_impl(self, params, x, y):
        yn, y_mean, y_std = self._normalize(y)
        kmat = self._gram(params, x)
        chol = self._cholesky(kmat)
        v = self._solve_lower(chol, yn)
        alpha = self._solve_lower_t(chol, v)
        return GpFit(params=params, x=x, chol=chol, alpha=alpha,
                     y_mean=y_mean, y_std=y_std)

    def _prior_diag(self, params, xs):
        """k(x*, x*) per test row: ``kernel.diag`` where the kernel has
        one, else the kernel evaluated row by row."""
        diag_fn = getattr(self.kernel, "diag", None)
        if diag_fn is not None:
            return diag_fn(params, xs)
        return torch.stack([self.kernel(params, r[None, :])[..., 0, 0]
                            for r in xs], dim=-1)

    def _predict_impl(self, fit: GpFit, xs):
        ks = self.kernel(fit.params, fit.x, xs)               # [n, m]
        mu = ks.transpose(-1, -2) @ fit.alpha
        w = self._solve_lower(fit.chol, ks)
        prior = self._prior_diag(fit.params, xs)
        var = torch.clamp_min(prior - torch.sum(w * w, dim=-2), 1e-12)
        return fit.y_mean + fit.y_std * mu, fit.y_std ** 2 * var

    def _lml_impl(self, params, x, y, grad_safe=False):
        """The log-ML at one param set, or at a batch of C param sets
        ([C] out), for training data x [n, d], y [n]. Kernel B6 factors
        and solves a batch in one launch where its gate allows, unless
        ``grad_safe`` or a kernel flag is set (the reference's routing,
        ``:333-356``)."""
        n = x.shape[-2]
        y, _, y_std = self._normalize(y)
        kmat = self._gram(params, x)
        if self.pallas_chol or self.pallas_solve or grad_safe:
            chol = self._cholesky(kmat, grad_safe=grad_safe)
            v = self._solve_lower(chol, y.expand(kmat.shape[:-1]))
        elif self._batched_route(kmat):
            chol, v = cholesky_solve_batched(
                kmat, y.expand(kmat.shape[0], n).contiguous())
        else:
            chol, v = cholesky_solve_plain(
                kmat, y.expand(kmat.shape[:-1]))
        return (-0.5 * torch.sum(v * v, dim=-1)
                - torch.sum(torch.log(torch.diagonal(chol, dim1=-2,
                                                     dim2=-1)), dim=-1)
                - 0.5 * n * math.log(2.0 * math.pi)
                - n * torch.log(y_std))

    # ---- public API --------------------------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def _params(self, params, d, dtype):
        if params is None:
            return default_params(d, dtype=dtype, device=self.device)
        return {k: self._tensor(v) for k, v in params.items()}

    def fit(self, x, y, params=None) -> GpFit:
        """Factorise at fixed hyperparameters → :class:`GpFit`."""
        x = torch.atleast_2d(self._tensor(x))
        y = self._tensor(y)
        return self._fit_impl(self._params(params, x.shape[-1], x.dtype),
                              x, y)

    def predict(self, fit: GpFit, xs, return_var=True):
        """Posterior mean (and variance) at test inputs [m, d]."""
        xs = torch.atleast_2d(self._tensor(xs))
        mu, var = self._predict_impl(fit, xs)
        return (mu, var) if return_var else mu

    def log_marginal_likelihood(self, params, x, y):
        """The log-ML at ``params``, one set or a batch over a leading
        chain axis, differentiable: routed with ``grad_safe=True``, as the
        reference's public log-ML is (a batch does not go to B6; BASELINE
        config 4's target calls :meth:`_lml_impl`, which does)."""
        x = torch.atleast_2d(self._tensor(x))
        return self._lml_impl(self._params(params, x.shape[-1], x.dtype),
                              x, self._tensor(y), grad_safe=True)

    def optimize(self, x, y, params=None, steps=300, lr=0.05, key=None,
                 n_restarts=1, restart_scale=0.5):
        """Maximise the exact log-ML with Adam over the log-hyperparameters
        → ``(best_params, best_lml)``.

        Adam is optax's (``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8,
        bias-corrected), written out over the params dict in optax's order
        of operations; the gradient is autograd's through
        ``_lml_impl(grad_safe=True)``. A step whose loss or gradient is not
        finite keeps both the params and the Adam state, decided on the
        device, so the host loop of ``steps`` iterations never waits for
        the card. Restarts (``n_restarts > 1``) start from the params plus
        ``restart_scale`` times standard normals drawn, leaf by leaf in
        the params' sorted key order, from a CPU ``torch.Generator``
        seeded with ``key`` (an int, default 0, or a Generator): they
        cannot match the JAX package's ``jax.random`` draws. Raises
        ``ValueError`` when every restart ends with a non-finite log-ML.
        """
        x = torch.atleast_2d(self._tensor(x))
        y = self._tensor(y)
        params = self._params(params, x.shape[-1], x.dtype)

        inits = [params]
        if n_restarts > 1:
            gen = key if isinstance(key, torch.Generator) else \
                torch.Generator().manual_seed(0 if key is None else int(key))
            for _ in range(n_restarts - 1):
                inits.append({
                    name: params[name] + restart_scale * torch.randn(
                        params[name].shape, generator=gen,
                        dtype=params[name].dtype).to(self.device)
                    for name in sorted(params)})

        best_p, best_l = None, -math.inf
        for p0 in inits:
            p = self._adam(x, y, p0, steps, lr)
            with torch.no_grad():
                lml = self._lml_impl(p, x, y, grad_safe=True)
            if math.isfinite(float(lml)) and float(lml) > float(best_l):
                best_p, best_l = p, lml
        if best_p is None:
            # every restart diverged (NaNs in y, duplicated rows with tiny
            # jitter, ...): fail here, not later in fit()
            raise ValueError(
                "optimize(): log marginal likelihood was non-finite for "
                "every restart — check the data for NaNs/duplicate rows "
                "or raise the jitter")
        return best_p, best_l

    def _adam(self, x, y, p0, steps, lr):
        """``steps`` Adam steps on −log-ML from ``p0`` (see
        :meth:`optimize`); returns the params."""
        names = sorted(p0)
        p = {k: p0[k].detach().clone() for k in names}
        mu = {k: torch.zeros_like(p[k]) for k in names}
        nu = {k: torch.zeros_like(p[k]) for k in names}
        count = torch.zeros((), dtype=p[names[0]].dtype, device=self.device)
        for _ in range(steps):
            leaves = {k: p[k].clone().requires_grad_(True) for k in names}
            loss = -self._lml_impl(leaves, x, y, grad_safe=True)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            with torch.no_grad():
                ok = torch.isfinite(loss)
                for g in grads:
                    ok = ok & torch.all(torch.isfinite(g))
                count_new = count + 1
                bc1 = 1 - ADAM_B1 ** count_new
                bc2 = 1 - ADAM_B2 ** count_new
                for k, g in zip(names, grads):
                    mu_k = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
                    nu_k = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * nu[k]
                    upd = (mu_k / bc1) / (torch.sqrt(nu_k / bc2) + ADAM_EPS)
                    p[k] = torch.where(ok, p[k] + (-lr) * upd, p[k])
                    mu[k] = torch.where(ok, mu_k, mu[k])
                    nu[k] = torch.where(ok, nu_k, nu[k])
                count = torch.where(ok, count_new, count)
        return p

    def surrogate_log_like(self, fit: GpFit, kind="mean"):
        """The fitted GP as a batched surrogate log-likelihood, θ [C, d] →
        ℓ̂(θ) [C] (or θ [d] → a scalar), BASELINE config 5.

        kind="mean": the posterior mean. kind="lcb": mean − ½σ², which
        keeps chains out of regions the surrogate is unsure about; its
        variance solve is one B8 launch for all C columns with
        ``pallas_solve``. "mean" computes the mean alone. The fit stays
        where it is (on the device).

        An SE-kernel surrogate reverts to its zero mean away from the
        training data, so combine it with a prior that covers the trained
        region (log_post = surrogate(θ) + log_prior(θ)).
        """
        if kind not in ("mean", "lcb"):
            raise ValueError(f"kind must be 'mean' or 'lcb', got {kind!r}")

        def log_like(theta):
            th = torch.atleast_2d(theta)
            ks = self.kernel(fit.params, fit.x, th)             # [n, C]
            out = fit.y_mean + fit.y_std * (ks.transpose(-1, -2)
                                            @ fit.alpha)
            if kind == "lcb":
                w = self._solve_lower(fit.chol, ks)
                prior = self._prior_diag(fit.params, th)
                var = torch.clamp_min(prior - torch.sum(w * w, dim=-2),
                                      1e-12)
                out = out - 0.5 * fit.y_std ** 2 * var
            return out if theta.dim() > 1 else out[0]
        return log_like
