"""Convergence and multimodality diagnostics, on the host.

Counterpart of the parts of ``bipymc_tpu/utils/diagnostics.py`` that the
DREAM-zs slice is scored with: split R̂, the FFT autocorrelation ESS with
emcee's auto-window, ``ess_rate`` over the fixed ``ESS_WINDOW_GENS``
window, and the nearest-mode occupancy. They take NumPy arrays (or CPU
tensors) and compute in float64 NumPy.

Chain-history convention: ``chains[M, N, d]`` = M chains × N steps × d
dims (1-d histories ``[M, N]`` are promoted).
"""

import numpy as np

# ESS is window-dependent (the auto-window τ grows with chain length), so
# throughput is reported over a FIXED window: ESS of the last
# ESS_WINDOW_GENS kept generations over that window's time.
ESS_WINDOW_GENS = 2000


def _promote(chains):
    chains = np.asarray(chains, dtype=np.float64)
    if chains.ndim == 2:
        chains = chains[..., None]
    return chains


def gelman_rubin(chains, split=True):
    """Split-R̂ per dimension [d] (Gelman et al. BDA3); chains [M, N, d].
    ``split=True`` halves each chain first (detects within-chain drift)."""
    chains = _promote(chains)
    m, n, _ = chains.shape
    if split:
        half = n // 2
        chains = np.concatenate([chains[:, :half], chains[:, n - half:]],
                                axis=0)
        n = half
    means = chains.mean(axis=1)
    w = chains.var(axis=1, ddof=1).mean(axis=0)
    b_over_n = means.var(axis=0, ddof=1)
    v_hat = (n - 1) / n * w + b_over_n
    return np.sqrt(v_hat / w)


def _acf_normalized(chains):
    """Per-chain/dim normalised ACF via zero-padded FFT: [M,N,d]→[M,N,d].
    A zero-variance chain/dim gives ρ := 0, not NaN."""
    n = chains.shape[1]
    x = chains - chains.mean(axis=1, keepdims=True)
    f = np.fft.rfft(x, n=2 * n, axis=1)
    acf = np.fft.irfft(f * np.conj(f), n=2 * n, axis=1)[:, :n, :]
    acf0 = acf[:, :1, :]
    return np.where(acf0 > 0.0, acf / np.maximum(acf0, 1e-30), 0.0)


def autocorr_fn(chains, max_lag=None):
    """Normalised autocorrelation ρ_t averaged over chains and dims."""
    chains = _promote(chains)
    rho = _acf_normalized(chains).mean(axis=(0, 2))
    return rho if max_lag is None else rho[:max_lag]


def _tau_from_rho(rho, c):
    """Sokal auto-window: the smallest w with w ≥ c·τ(w)."""
    taus = 2.0 * np.cumsum(rho) - 1.0
    ok = np.arange(rho.shape[0]) >= c * taus
    window = int(np.argmax(ok)) if ok.any() else rho.shape[0] - 1
    return max(float(taus[window]), 1.0)


def integrated_autocorr_time(chains, c=5.0, per_dim=False):
    """Integrated autocorrelation time τ with the auto-window; a scalar
    from the chain/dim-averaged ρ, or [d] with ``per_dim=True``."""
    chains = _promote(chains)
    if not per_dim:
        return _tau_from_rho(autocorr_fn(chains), c)
    rho = _acf_normalized(chains).mean(axis=0)               # [n, d]
    return np.array([_tau_from_rho(rho[:, j], c)
                     for j in range(rho.shape[1])])


def effective_sample_size(chains, c=5.0, per_dim=False):
    """ESS = M·N / τ over all chains; ``per_dim=True`` takes the
    worst dimension's τ."""
    chains = _promote(chains)
    m, n, _ = chains.shape
    tau = integrated_autocorr_time(chains, c=c, per_dim=per_dim)
    if per_dim:
        tau = float(np.max(tau))
    return m * n / tau


def ess_rate(chains, gens_per_sec, window=ESS_WINDOW_GENS, c=5.0):
    """(ESS, ESS/s) over the final ``window`` kept generations of
    ``chains`` [M, N, d] (all N when shorter)."""
    n = chains.shape[1]
    w = min(int(window), n)
    ess = float(effective_sample_size(chains[:, n - w:], c=c))
    return ess, ess * float(gens_per_sec) / w


def acceptance_fraction(accepted):
    """Mean acceptance per chain. accepted: [..., N] bool → [...]."""
    return np.asarray(accepted, dtype=np.float64).mean(axis=-1)


def nearest_mode(positions, means):
    """Index of the nearest mode centre for each position [..., d];
    means [k, d]. Returns int [...]."""
    positions = np.asarray(positions, dtype=np.float64)
    means = np.asarray(means, dtype=np.float64)
    sq = (np.sum(positions ** 2, -1)[..., None] + np.sum(means ** 2, -1)
          - 2.0 * positions @ means.T)
    return np.argmin(sq, axis=-1)


def mode_occupancy(positions, means):
    """Chains per nearest mode: positions [M, d] (or pooled [M·T, d]),
    means [k, d] → counts [k]. R̂ and ESS are blind to a lost mode; this
    is the check for it."""
    idx = nearest_mode(positions, means)
    return np.bincount(idx.reshape(-1), minlength=np.shape(means)[0])
