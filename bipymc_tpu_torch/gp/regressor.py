"""Gaussian-process regression: fit, predict and the log marginal
likelihood.

Counterpart of ``bipymc_tpu/gp/regressor.py``, forward only:

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

Not ported here, each raising ``NotImplementedError``: ``pallas_chol``
(kernel B7), ``pallas_solve`` (kernel B8) and ``optimize``, which needs
the VJPs of B5 and B6.
"""

import math
from typing import Callable, NamedTuple

import torch

from bipymc_tpu_torch.gp.kernels import squared_exp
from bipymc_tpu_torch.ops.pallas_bchol import (cholesky_batched,
                                               cholesky_solve_batched,
                                               cholesky_solve_plain)
from bipymc_tpu_torch.ops.pallas_kernels import VJP_ITEM

_B7_ITEM = "ROADMAP Queue B item B7 (cholesky_pallas)"
_B8_ITEM = "ROADMAP Queue B item B8 (tri_solve)"
BATCHED_MIN, BATCHED_MAX_N = 8, 1024     # the reference's B6 gate


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
    predict. batched_chol: route a log-ML batched over chains to kernel
    B6 where the gate allows (module docstring). device: where ``fit``,
    ``predict`` and ``log_marginal_likelihood`` put their inputs.
    """

    def __init__(self, kernel: Callable = squared_exp, jitter: float = 1e-5,
                 normalize_y: bool = False, pallas_solve: bool = False,
                 pallas_chol: bool = False, batched_chol: bool = True,
                 device="cuda"):
        if pallas_chol:
            raise NotImplementedError(
                f"pallas_chol=True is not ported: {_B7_ITEM}")
        if pallas_solve:
            raise NotImplementedError(
                f"pallas_solve=True is not ported: {_B8_ITEM}")
        self.kernel = kernel
        self.jitter = jitter
        self.normalize_y = normalize_y
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

    def _cholesky(self, kmat):
        """Lower factor of one Gram matrix or a batch of them (kernel B6
        where :meth:`_batched_route` allows); NaN for a matrix that is not
        positive definite, as ``jnp.linalg.cholesky`` gives
        (``torch.linalg.cholesky`` would raise)."""
        if self._batched_route(kmat):
            return cholesky_batched(kmat)
        return cholesky_solve_plain(kmat)

    @staticmethod
    def _solve(chol, b, upper):
        vec = b.dim() == 1 or b.dim() == chol.dim() - 1
        out = torch.linalg.solve_triangular(
            chol.transpose(-1, -2) if upper else chol,
            b[..., None] if vec else b, upper=upper)
        return out[..., 0] if vec else out

    def _solve_lower(self, chol, b):
        """L⁻¹ b for b [..., n] or [..., n, m]."""
        return self._solve(chol, b, upper=False)

    def _solve_lower_t(self, chol, b):
        """L⁻ᵀ b."""
        return self._solve(chol, b, upper=True)

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

    def _lml_impl(self, params, x, y):
        """The log-ML at one param set, or at a batch of C param sets
        ([C] out), for training data x [n, d], y [n]."""
        n = x.shape[-2]
        y, _, y_std = self._normalize(y)
        kmat = self._gram(params, x)
        if self._batched_route(kmat):
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
        chain axis (then routed as :meth:`_lml_impl` routes it)."""
        x = torch.atleast_2d(self._tensor(x))
        return self._lml_impl(self._params(params, x.shape[-1], x.dtype),
                              x, self._tensor(y))

    def optimize(self, *args, **kwargs):
        raise NotImplementedError(
            f"optimize needs the gradients of kernels B5 and B6: {VJP_ITEM}")
