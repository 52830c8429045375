"""Analytic targets: BASELINE config 1 (correlated Gaussian) and 3
(Gaussian mixture).

Counterpart of ``bipymc_tpu/models/targets.py``. A target here is a
**batched** callable, ``log_prob(x[n, d]) -> [n]``: the JAX package
writes a per-row density and maps it over chains with ``vmap``; the
batch dimension written out is the PyTorch form of that map.

A CUDA kernel cannot inline an arbitrary user function the way a Pallas
kernel inlines a jaxpr, so each built-in target also carries a
:class:`KernelForm`: the name of its device function and its constants.
Kernels B1 (``ops/fused_chunk.py``) and B4 (``ops/fused_rw_chunk.py``)
evaluate targets through it (``csrc/target.cuh``) and refuse a target
that has none.
"""

import numpy as np
import torch

from bipymc_tpu_torch.utils.init import var_ball


def baseline_config3_means(d=100, n_modes=4, spread=5.0, seed=1234):
    """Mode centres of BASELINE config 3: the JAX package's NumPy draw,
    copied so the port needs nothing of that package."""
    rng = np.random.default_rng(seed)
    return (spread * rng.standard_normal((n_modes, d))).astype(np.float32)


def stratified_mode_init(gen, means, n, var=4.0, dtype=torch.float32,
                         device="cuda"):
    """Start points spread over all modes: chain ``i`` starts in a
    ``var_ball`` of per-dimension variance ``var`` around mode ``i % k``.
    means: [k, d]. Returns [n, d] on ``device``."""
    means = torch.as_tensor(np.asarray(means), dtype=dtype, device=device)
    k, d = means.shape
    centers = means[torch.arange(n, device=device) % k]
    noise = var_ball(gen, torch.full((d,), var, dtype=dtype), n,
                     dtype=dtype, device=device)
    return centers + noise


class KernelForm:
    """A built-in target as a CUDA kernel evaluates it in device code.

    ``name`` names the device function (``csrc/target.cuh``);
    ``arrays`` and ``scalars`` hold its constants. :meth:`tensors` moves
    the arrays to a device once per (device, dtype): the kernels read them
    in float32, and the target's torch form reads them in its input's
    dtype.
    """

    def __init__(self, name: str, arrays: dict, scalars: dict):
        self.name = name
        self.arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        self.scalars = {k: float(v) for k, v in scalars.items()}
        self._on = {}

    def tensors(self, device, dtype=torch.float32) -> dict:
        key = (torch.device(device), dtype)
        if key not in self._on:
            self._on[key] = {k: torch.as_tensor(v, dtype=dtype, device=key[0])
                             for k, v in self.arrays.items()}
        return self._on[key]


# the targets that carry a kernel form, by KernelForm.name
KERNEL_TARGETS = ("correlated_gaussian", "gaussian_mixture")
MAX_MODES = 16                   # kMaxModes in csrc/target.cuh


def kernel_form(log_prob):
    """The target's :class:`KernelForm`, or None for a target that has
    none (any user function)."""
    return getattr(log_prob, "kernel_form", None)


def kernel_operands(log_prob, device, d: int, kernel: str):
    """``(kind, c0, c1, n_modes, f0, f1)``: the target's kernel form as
    ``csrc/target.cuh::load_target`` takes it, with the arrays float32 on
    ``device``. Raises ``ValueError``, naming ``kernel``, for a target
    with no kernel form, one of another dimension than ``d``, or a
    mixture of more than :data:`MAX_MODES` modes."""
    form = kernel_form(log_prob)
    if form is None:
        raise ValueError(
            f"{kernel} on {device}: the target has no kernel form; the "
            f"kernel evaluates only {', '.join(KERNEL_TARGETS)} "
            "(bipymc_tpu_torch.models.targets)")
    t = form.tensors(device)
    if form.name == "correlated_gaussian":
        if t["mean"].shape != (d,):
            raise ValueError(f"the target is {t['mean'].shape[0]}-d, the "
                             f"chains {d}-d")
        return (0, t["mean"], t["inv"], 0, form.scalars["log_det"],
                form.scalars["log_2pi_d"])
    if form.name == "gaussian_mixture":
        k, dm = t["means"].shape
        if dm != d:
            raise ValueError(f"the target is {dm}-d, the chains {d}-d")
        if k > MAX_MODES:
            raise ValueError(f"{kernel} takes at most {MAX_MODES} modes, "
                             f"got {k}")
        return (1, t["means"], t["log_w"], k, form.scalars["norm"],
                form.scalars["sigma2"])
    raise ValueError(f"no device function for kernel form {form.name!r}")


def correlated_gaussian(mean, cov):
    """Correlated-Gaussian log-density N(mean, cov) (BASELINE config 1).

    Returns a batched ``log_prob(x[n, d]) -> [n]`` with the JAX package's
    ``inv``, ``log_det`` and term order, ``−½(q + log_det + d·log 2π)``
    with ``q = Σ((r @ inv) · r)``, constants included.
    """
    mean = np.asarray(mean)
    cov = np.asarray(cov)
    d = mean.shape[-1]
    chol = np.linalg.cholesky(cov)
    log_det = 2.0 * float(np.sum(np.log(np.diagonal(chol))))
    inv = np.linalg.inv(cov)
    log_2pi_d = d * float(np.log(2.0 * np.pi))
    form = KernelForm("correlated_gaussian", {"mean": mean, "inv": inv},
                      {"log_det": log_det, "log_2pi_d": log_2pi_d})

    def log_prob(x):
        t = form.tensors(x.device, x.dtype)
        r = x - t["mean"]
        q = torch.sum((r @ t["inv"]) * r, dim=-1)
        return -0.5 * (q + log_det + log_2pi_d)

    log_prob.kernel_form = form
    return log_prob


def gaussian_mixture(means, sigma=1.0, weights=None):
    """Isotropic Gaussian mixture in d dims (BASELINE config 3 posterior).

    means: [k, d] centres (NumPy); sigma: shared std; weights: [k].
    Returns a batched ``log_prob(x[n, d]) -> [n]`` with the JAX package's
    ``log_w`` and ``norm`` constants and its term order, summed over modes
    by ``logsumexp``. The constants move to a device once per
    (device, dtype), through the kernel form, and are then reused.
    """
    means = np.asarray(means)
    if not np.issubdtype(means.dtype, np.floating):
        means = means.astype(np.float32)
    k, d = means.shape
    if weights is None:
        log_w = np.full((k,), -np.log(k), dtype=means.dtype)
    else:
        w = np.asarray(weights)
        log_w = np.log(w / np.sum(w))
    norm = -0.5 * d * float(np.log(2.0 * np.pi * sigma ** 2))
    form = KernelForm("gaussian_mixture", {"means": means, "log_w": log_w},
                      {"norm": norm, "sigma2": sigma ** 2})

    def log_prob(x):
        t = form.tensors(x.device, x.dtype)
        sq = torch.sum((x[:, None, :] - t["means"]) ** 2, dim=-1)  # [n, k]
        return torch.logsumexp(t["log_w"] + norm - 0.5 * sq / sigma ** 2,
                               dim=-1)

    log_prob.kernel_form = form
    return log_prob
