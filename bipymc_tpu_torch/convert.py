"""Sampler states to and from NumPy, under the JAX package's field names.

A JAX ``DreamState`` flattened with ``np.asarray`` under its field names
(``x``, ``logp``, ``archive.buf``, ``archive.fill``, ``archive.head``,
``cr_p``, ``cr_cum``, ``cr_jump``, ``cr_count``, ``logp_sum``, ``gen``)
becomes the port's state and back, so both packages can start from, and
be compared at, the same state. The same holds for the random-walk
family's batched ``RwState``, the stretch sampler's ``StretchState``,
and for the GP's params dict (both ways:
an ``optimize`` result can go either way) and ``GpFit``. Nothing here imports JAX.
"""

import numpy as np
import torch

from bipymc_tpu_torch.ensemble.archive import Archive
from bipymc_tpu_torch.gp.regressor import GpFit
from bipymc_tpu_torch.samplers.dream import DreamState
from bipymc_tpu_torch.samplers.rw import RwState
from bipymc_tpu_torch.samplers.stretch import StretchState

_TENSORS = ("x", "logp", "cr_p", "cr_cum", "cr_jump", "cr_count",
            "logp_sum")


def dream_state_from_numpy(fields: dict, device) -> DreamState:
    """``{name: array}`` under the JAX field names → ``DreamState``."""
    # copies: the port writes the archive in place, and must not write
    # into a buffer the caller still holds
    t = {name: torch.as_tensor(np.array(fields[name]), device=device)
         for name in _TENSORS}
    archive = Archive(
        buf=torch.as_tensor(np.array(fields["archive.buf"]),
                            device=device),
        fill=int(fields["archive.fill"]), head=int(fields["archive.head"]))
    return DreamState(archive=archive, gen=int(fields["gen"]), **t)


def dream_state_to_numpy(state: DreamState) -> dict:
    """``DreamState`` → ``{name: np.ndarray}`` under the JAX field names
    (the counters as int32 scalars, as the JAX state holds them)."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in _TENSORS}
    out["archive.buf"] = state.archive.buf.detach().cpu().numpy()
    for name, v in (("archive.fill", state.archive.fill),
                    ("archive.head", state.archive.head),
                    ("gen", state.gen)):
        out[name] = np.int32(v)
    return out


_RW_TENSORS = ("theta", "logp", "mean", "m2", "chol")


def rw_state_from_numpy(fields: dict, device) -> RwState:
    """``{name: array}`` of a batched JAX ``RwState`` (``theta, logp,
    mean, m2, count, chol``, each with a leading chain axis) →
    ``RwState``. Every chain of a run carries the same ``count``."""
    count = np.asarray(fields["count"])
    if count.size and not np.all(count == count.flat[0]):
        raise ValueError("the chains' counts differ: the port keeps one "
                         "count for every chain")
    t = {name: torch.as_tensor(np.array(fields[name]), device=device)
         for name in _RW_TENSORS}
    return RwState(count=int(count.flat[0]), **t)


def rw_state_to_numpy(state: RwState) -> dict:
    """``RwState`` → ``{name: np.ndarray}`` under the JAX field names,
    ``count`` as the JAX state holds it, [n_chains] int32."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in _RW_TENSORS}
    out["count"] = np.full(state.theta.shape[0], state.count, np.int32)
    return out


def stretch_state_from_numpy(fields: dict, device) -> StretchState:
    """``{name: array}`` of a JAX ``StretchState`` (``x``, ``logp``,
    ``gen``) → ``StretchState``."""
    return StretchState(
        x=torch.as_tensor(np.array(fields["x"]), device=device),
        logp=torch.as_tensor(np.array(fields["logp"]), device=device),
        gen=int(fields["gen"]))


def stretch_state_to_numpy(state: StretchState) -> dict:
    """``StretchState`` → ``{name: np.ndarray}`` under the JAX field
    names, ``gen`` as an int32 scalar."""
    return {"x": state.x.detach().cpu().numpy(),
            "logp": state.logp.detach().cpu().numpy(),
            "gen": np.int32(state.gen)}


def gp_params(params: dict, device) -> dict:
    """The JAX package's GP params (``log_lengthscale``, ``log_sigma_f``,
    ``log_sigma_n``, as arrays of any leading shape) → the port's dict of
    tensors on ``device`` (copies, in the arrays' own dtype)."""
    return {name: torch.as_tensor(np.array(v), device=device)
            for name, v in params.items()}


def gp_params_to_numpy(params: dict) -> dict:
    """GP params (the port's tensors or the JAX package's arrays, e.g. an
    ``optimize`` result or a restart's start) → ``{name: np.ndarray}``."""
    return {name: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v)) for name, v in params.items()}


def gp_fit(fit, device) -> GpFit:
    """A JAX ``GpFit`` (or any object with its fields) → the port's."""
    return GpFit(params=gp_params(fit.params, device),
                 **{name: torch.as_tensor(np.array(getattr(fit, name)),
                                          device=device)
                    for name in GpFit._fields if name != "params"})
