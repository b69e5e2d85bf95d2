"""Parity of the port's reduction table with the JAX package's.

The same numpy leaves go through ``merge_leaf`` of both packages. Integer
merges are exact; float merges take the same operations in the same order on
float32 and must agree to the last bit too, except MEAN, whose division may
round differently: ``rtol=1e-6``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.core import reductions as jr
from torchmetrics_tpu_torch.core import reductions as tr

REDUCES = ["sum", "mean", "max", "min"]


def _leaves(dtype, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, size=(3, 4)).astype(dtype), rng.integers(-50, 50, size=(3, 4)).astype(dtype)
    return rng.normal(size=(3, 4)).astype(dtype), rng.normal(size=(3, 4)).astype(dtype)


@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("reduce", REDUCES)
def test_merge_leaf_parity(reduce, dtype, with_counts):
    a, b = _leaves(dtype, seed=len(reduce))
    n_a, n_b = (np.int32(3), np.int32(5)) if with_counts else (None, None)
    want = jr.merge_leaf(
        jr.canonical_reduce(reduce), jnp.asarray(a), jnp.asarray(b),
        n_a=None if n_a is None else jnp.asarray(n_a), n_b=None if n_b is None else jnp.asarray(n_b),
    )
    got = tr.merge_leaf(
        tr.canonical_reduce(reduce), torch.from_numpy(a), torch.from_numpy(b),
        n_a=None if n_a is None else torch.tensor(n_a), n_b=None if n_b is None else torch.tensor(n_b),
    )
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    if reduce == "mean":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reduce", ["cat", None])
def test_merge_leaf_cat_parity(reduce):
    a = (np.arange(3, dtype=np.float32), np.arange(2, dtype=np.float32) + 10)
    b = (np.full(4, 7.0, dtype=np.float32),)
    want = jr.merge_leaf(jr.canonical_reduce(reduce), tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    got = tr.merge_leaf(tr.canonical_reduce(reduce), tuple(map(torch.from_numpy, a)), tuple(map(torch.from_numpy, b)))
    assert isinstance(got, tuple) and len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_leaf_callable_parity():
    a, b = _leaves(np.float32, seed=7)
    want = jr.merge_leaf(lambda x: x.max(0) - x.min(0), jnp.asarray(a), jnp.asarray(b))
    got = tr.merge_leaf(lambda x: x.amax(0) - x.amin(0), torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


DTYPES = [
    (np.float32, torch.float32),
    (np.int32, torch.int32),
    (np.int16, torch.int16),
    (np.uint8, torch.uint8),
    (np.bool_, torch.bool),
]


@pytest.mark.parametrize("np_dtype,torch_dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min", "cat", "none"])
def test_reduce_identity_parity(reduce, np_dtype, torch_dtype):
    want = jr.reduce_identity(jr.canonical_reduce(reduce), np_dtype)
    got = tr.reduce_identity(tr.canonical_reduce(reduce), torch_dtype)
    if want is None:
        assert got is None
        return
    assert got.dtype == torch_dtype and got.shape == ()
    assert got.numpy().dtype == np.asarray(want).dtype
    assert got.item() == np.asarray(want).item()


def test_reduce_identity_callable_is_none():
    assert tr.reduce_identity(lambda x: x.sum(0), torch.float32) is None


def test_canonical_reduce():
    assert tr.canonical_reduce(None) is tr.Reduce.NONE
    assert tr.canonical_reduce("sum") is tr.Reduce.SUM
    assert tr.canonical_reduce(tr.Reduce.MAX) is tr.Reduce.MAX
    fn = lambda x: x  # noqa: E731
    assert tr.canonical_reduce(fn) is fn
    with pytest.raises(ValueError, match="dist_reduce_fx"):
        tr.canonical_reduce("median")
    with pytest.raises(ValueError):
        jr.canonical_reduce("median")
