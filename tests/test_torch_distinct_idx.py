"""Port ↔ JAX: kernel B3 (distinct row indices), bit for bit.

The port's plain version (``ensemble/indices.py::distinct_from_bits``)
and its dispatcher on CPU tensors are held against
``distinct_idx_pallas(..., interpret=True)`` on the same words. The
CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipymc_tpu.ops.distinct_idx import distinct_idx_pallas
from bipymc_tpu_torch.ensemble.indices import distinct_from_bits
from bipymc_tpu_torch.ops.distinct_idx import distinct_idx

torch.set_num_threads(2)


def _case(n_chains, k, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (n_chains, k), dtype=np.uint64)
    words = words.astype(np.uint32)
    exclude = rng.permutation(n_chains).astype(np.int32)
    return words, exclude


@pytest.mark.parametrize("with_exclude", [False, True])
@pytest.mark.parametrize("fill_of", ["k", "k+1", "17", "8192"])
@pytest.mark.parametrize("k", [3, 6])
def test_plain_and_dispatcher_match_pallas(k, fill_of, with_exclude):
    n_chains = 37                       # not a multiple of 32
    n = {"k": k, "k+1": k + 1, "17": 17, "8192": 8192}[fill_of]
    if with_exclude:
        # exclude ∈ [0, n) needs n − 1 ≥ k: the smallest fill is k + 1
        n = max(n, k + 1)
    words, exclude = _case(n_chains, k, seed=k * 100 + n)
    exclude %= n
    ex_j = jnp.asarray(exclude) if with_exclude else None
    ref = np.asarray(distinct_idx_pallas(
        jnp.asarray(words), k, n, exclude=ex_j, interpret=True))

    w_t = torch.from_numpy(words.view(np.int32))
    ex_t = torch.from_numpy(exclude) if with_exclude else None
    plain = distinct_from_bits(w_t, k, n, ex_t).numpy()
    disp = distinct_idx(w_t, k, n, ex_t).numpy()
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(disp, ref)
    assert plain.min() >= 0 and plain.max() < n
    assert all(len(set(r)) == k for r in plain)
    if with_exclude:
        assert not np.any(plain == exclude[:, None])


def test_dispatcher_reads_a_strided_word_block():
    """A column slice of the generation's word block, as the step passes
    it, gives the same draw as a contiguous copy."""
    block, _ = _case(33, 20, seed=5)
    w_t = torch.from_numpy(block.view(np.int32))
    sl = w_t[:, 5:11]
    assert not sl.is_contiguous()
    np.testing.assert_array_equal(distinct_idx(sl, 6, 300).numpy(),
                                  distinct_idx(sl.contiguous(), 6, 300)
                                  .numpy())


def test_dispatcher_validates():
    w = torch.zeros((4, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        distinct_idx(w, 6, 5)              # fewer values than draws
    with pytest.raises(ValueError):
        distinct_idx(w, 7, 100)            # more draws than words
    with pytest.raises(ValueError):
        distinct_idx(torch.zeros((4, 9), dtype=torch.int32), 9, 100)
