"""Kernel B2: the DREAM-zs proposal math, and its plain version.

Counterpart of ``bipymc_tpu/ops/dream_proposal.py``. :func:`propose_block`
is the plain PyTorch version and follows the Pallas path's math: the
masked sum over δ DE pairs, the crossover mask with the FIRST minimum
lane forced in, γ = 2.38·rsqrt(2δ·d_eff) (1 on jump generations), the
snooker projection with its log Jacobian, and the 1e-30 clamps. The
kernel is ``bipymc_tpu_torch/csrc/dream_proposal.cu`` (one block per
chain); it matches the plain version up to float re-association.

:func:`dream_propose` has the signature and returns of
``dream_propose_pallas``. A tensor on the CPU goes to the plain version;
a CUDA tensor goes to the kernel, or the call raises.
``dream_propose.launches`` counts the kernel's launches.
"""

import torch

from bipymc_tpu_torch.ops import _build

# columns of the packed per-chain scalars
S_DELTA, S_CR, S_GS, S_SNK, S_GJUMP = 0, 1, 2, 3, 4
N_SCAL = 5


def propose_block(x, rows, u, ue, eps, delta, cr, gamma_s, is_snk,
                  gamma_jump, n_pairs, d_true, b, b_star):
    """DREAM-zs proposal for a block of chains.

    x, u, ue, eps: [n, d]; rows: [n, k, d] gathered archive rows
    (k ≥ max(2·n_pairs, 3)); delta, cr, gamma_s, is_snk, gamma_jump:
    [n, 1] per-chain scalars as floats. Returns (x_star [n, d],
    log_jac [n, 1], snk [n, 1] bool).
    """
    # ---- parallel-direction move ------------------------------------
    diff = torch.zeros_like(x)
    for j in range(n_pairs):
        w = (float(j) < delta).to(x.dtype)
        diff = diff + w * (rows[:, j, :] - rows[:, n_pairs + j, :])

    mask = (u < cr).to(x.dtype)
    # guarantee ≥1 crossed dim: the FIRST lane holding the min uniform
    umin = torch.amin(u, dim=1, keepdim=True)
    lane = torch.arange(u.shape[1], device=u.device)
    first_min = torch.amin(
        torch.where(u == umin, lane, u.shape[1]), dim=1, keepdim=True)
    mask = torch.maximum(mask, (lane == first_min).to(x.dtype))
    d_eff = torch.sum(mask, dim=1, keepdim=True)

    gamma = 2.38 * torch.rsqrt(2.0 * delta * d_eff)
    gamma = torch.where(gamma_jump > 0.5, 1.0, gamma)
    e = b * (2.0 * ue - 1.0)
    x_par = x + mask * ((1.0 + e) * gamma * diff + b_star * eps)

    # ---- snooker move ------------------------------------------------
    z = rows[:, 0, :]
    zr1 = rows[:, 1, :]
    zr2 = rows[:, 2, :]
    u_dir = x - z
    denom = torch.clamp_min(
        torch.sum(u_dir * u_dir, dim=1, keepdim=True), 1e-30)
    dots = torch.sum((zr1 - zr2) * u_dir, dim=1, keepdim=True)
    x_snk = x + gamma_s * (dots / denom) * u_dir
    num = torch.clamp_min(
        torch.sum((x_snk - z) ** 2, dim=1, keepdim=True), 1e-30)
    log_jac_snk = (d_true - 1) * 0.5 * (torch.log(num) - torch.log(denom))

    snk = is_snk > 0.5
    x_star = torch.where(snk, x_snk, x_par)
    log_jac = torch.where(snk, log_jac_snk, 0.0)
    return x_star, log_jac, snk


def propose_plain(x, rows, u_mask, u_e, eps, scal, n_pairs, d_true, b,
                  b_star):
    """:func:`propose_block` with :func:`dream_propose`'s signature."""
    col = lambda c: scal[:, c:c + 1]
    x_star, log_jac, _ = propose_block(
        x, rows, u_mask, u_e, eps, col(S_DELTA), col(S_CR), col(S_GS),
        col(S_SNK), col(S_GJUMP), n_pairs, d_true, b, b_star)
    return x_star, log_jac[:, 0]


def dream_propose(x, rows, u_mask, u_e, eps, scal, n_pairs, d_true, b,
                  b_star):
    """The proposal for every chain: returns (x_star [n, d], log_jac [n]).

    x [n, d]; rows [n, k, d] with k ≥ max(2·n_pairs, 3); u_mask, u_e,
    eps [n, d]; scal [n, 5] packed per-chain scalars (delta, cr, gamma_s,
    is_snooker, gamma_jump as floats). On the card every operand is
    float32; the [n, d] ones may have any row stride with unit stride
    along d (slices of the generation's uniform block need no copy).
    """
    n, d = x.shape
    k = rows.shape[1] if rows.dim() == 3 else -1
    if rows.shape != (n, k, d) or k < max(2 * n_pairs, 3):
        raise ValueError(f"rows must be [{n}, >= {max(2 * n_pairs, 3)}, "
                         f"{d}], got {tuple(rows.shape)}")
    for name, a in (("u_mask", u_mask), ("u_e", u_e), ("eps", eps)):
        if a.shape != (n, d):
            raise ValueError(f"{name} must be [{n}, {d}], got "
                             f"{tuple(a.shape)}")
    if scal.shape != (n, N_SCAL):
        raise ValueError(f"scal must be [{n}, {N_SCAL}], got "
                         f"{tuple(scal.shape)}")
    if x.device.type == "cpu":
        return propose_plain(x, rows, u_mask, u_e, eps, scal, n_pairs,
                             d_true, b, b_star)
    _check_cuda(x, rows, u_mask, u_e, eps, scal)
    x_star = torch.empty((n, d), dtype=x.dtype, device=x.device)
    log_jac = torch.empty((n,), dtype=x.dtype, device=x.device)
    err = _build.library("dream_proposal")(
        x.data_ptr(), x.stride(0), rows.data_ptr(), k,
        u_mask.data_ptr(), u_mask.stride(0), u_e.data_ptr(), u_e.stride(0),
        eps.data_ptr(), eps.stride(0), scal.data_ptr(), n, d, n_pairs,
        (d_true - 1) * 0.5, b, b_star, x_star.data_ptr(), log_jac.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dream_propose")
    dream_propose.launches += 1
    return x_star, log_jac


dream_propose.launches = 0


def _check_cuda(x, rows, u_mask, u_e, eps, scal):
    if x.device.type != "cuda":
        raise ValueError(f"dream_propose: no kernel for device {x.device}")
    for name, a in (("x", x), ("rows", rows), ("u_mask", u_mask),
                    ("u_e", u_e), ("eps", eps), ("scal", scal)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got "
                            f"{a.dtype}")
    for name, a in (("x", x), ("u_mask", u_mask), ("u_e", u_e),
                    ("eps", eps)):
        if a.stride(1) != 1:
            raise ValueError(f"{name} must have unit stride along d")
    if not (rows.is_contiguous() and scal.is_contiguous()):
        raise ValueError("rows and scal must be contiguous")
