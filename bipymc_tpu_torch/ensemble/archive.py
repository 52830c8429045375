"""Archive Z for DREAM-zs: a fixed-capacity ring buffer on the device.

Counterpart of ``bipymc_tpu/ensemble/archive.py`` for the replicated
ring (the sharded variants belong to the multi-GPU work, ROADMAP Queue A
item 15). ``fill`` and ``head`` are host ints: the append schedule is
deterministic, so the host always knows them and no generation needs to
read a device scalar.

Unlike the JAX package, :func:`archive_append` writes the new rows into
``buf`` **in place** (one or two slice copies) rather than copying the
whole buffer: an ``Archive`` returned earlier shares its ``buf`` with
the one after the append.
"""

from typing import NamedTuple

import torch


class Archive(NamedTuple):
    buf: torch.Tensor   # [capacity, d]
    fill: int           # number of valid rows
    head: int           # next write slot (ring)


def archive_init(init_rows: torch.Tensor, capacity: int) -> Archive:
    """Start the archive holding ``init_rows`` [k, d] (k ≤ capacity)."""
    init_rows = torch.atleast_2d(init_rows)
    k, d = init_rows.shape
    if k > capacity:
        raise ValueError(f"init rows {k} exceed capacity {capacity}")
    buf = torch.zeros((capacity, d), dtype=init_rows.dtype,
                      device=init_rows.device)
    buf[:k] = init_rows
    return Archive(buf=buf, fill=k, head=k % capacity)


def archive_append(ar: Archive, rows: torch.Tensor) -> Archive:
    """Append [k, d] rows at the ring head (oldest rows overwritten)."""
    rows = torch.atleast_2d(rows)
    k = rows.shape[0]
    capacity = ar.buf.shape[0]
    if k > capacity:
        raise ValueError(
            f"appending {k} rows to a capacity-{capacity} archive: "
            f"capacity must be ≥ the population size")
    first = min(k, capacity - ar.head)
    ar.buf[ar.head:ar.head + first] = rows[:first]
    if first < k:
        ar.buf[:k - first] = rows[first:]
    return Archive(buf=ar.buf, fill=min(ar.fill + k, capacity),
                   head=(ar.head + k) % capacity)
