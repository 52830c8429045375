"""Sampling without replacement from per-chain random words.

Counterpart of ``bipymc_tpu/ensemble/indices.py::distinct_from_bits``,
batched over chains. The t-th draw is uniform over ``avail − t`` values
and is shifted past the values already taken, in increasing order (the
exact sequential shift construction). All arithmetic is int32, step for
step as in the JAX package, so the result is bit-identical to it.

This is the plain PyTorch version of kernel B3
(``bipymc_tpu_torch/ops/distinct_idx.py``).
"""

import torch

_SENTINEL = 2 ** 31 - 1


def distinct_from_bits(bits: torch.Tensor, k: int, n: int,
                       exclude: torch.Tensor | None = None) -> torch.Tensor:
    """``k`` distinct ints per chain, uniform on [0, n), optionally ≠ exclude.

    bits: [n_chains, ≥k] 32-bit words (int32 bit patterns, see
    ``core/rng.py``); the first ``k`` columns are used. n: host int.
    exclude: optional [n_chains] int32, one excluded index per chain.
    The caller guarantees ``n ≥ k`` (``k + 1`` with ``exclude``).
    Returns int32 [n_chains, k].
    """
    n_chains = bits.shape[0]
    m = k + (1 if exclude is not None else 0)
    taken = [torch.full((n_chains,), _SENTINEL, dtype=torch.int32,
                        device=bits.device) for _ in range(m)]
    n_excl = 0
    if exclude is not None:
        taken[0] = exclude.to(torch.int32)
        n_excl = 1
    avail = int(n) - n_excl

    b31 = bits[:, :k].to(torch.int32) & 0x7FFFFFFF
    out = []
    for t in range(k):
        r = b31[:, t] % (avail - t)
        # shift past taken values, in increasing (sorted) order
        for j in range(m):
            r = r + (r >= taken[j]).to(torch.int32)
        out.append(r)
        # branchless insert of r into the sorted `taken` (sentinels last)
        pos = sum((tj < r).to(torch.int32) for tj in taken)
        taken = [torch.where(pos > j, taken[j],
                             torch.where(pos == j, r, taken[max(j - 1, 0)]))
                 for j in range(m)]
    return torch.stack(out, dim=1)
