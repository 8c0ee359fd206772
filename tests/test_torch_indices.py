"""The port's index arithmetic (``core/indices.py``) against the JAX
package's, exactly: the same views give the same dims, strides, offsets
and flat-index lists, and the reference's own cases hold on the port."""

import numpy as np
import pytest

from eigenex_tpu.core import indices as ref
from eigenex_tpu_torch.core import indices as port
from eigenex_tpu_torch.utils.exceptions import EigenexError


def views(mod):
    """A fixed bundle of views covering every transformation."""
    P = mod.ProductIndices
    return [
        P([2, 3, 4]),
        P([2, 3, 4]).shuffle([2, 0, 1]),
        P([3, 3]).delta(0, 1),
        P([4, 5, 4, 2]).delta(2, 0).shuffle([2, 0, 1]),
        P([10]).sliced(0, mod.Slice(start=2, length=3, stride=2)),
        P([6, 7]).sliced(1, mod.Slice(1, 3, 2)).shuffle([1, 0]),
        P([3, 4, 3]).from_(["i", "j", "i"]).to(["i", "j"]),
        P([2, 5]).from_(["a", "b"]).to(["b", "a"]),
        P([3, 2, 3, 2], labels=["p", "q", "r", "s"]).from_(["i", "j", "i", "j"]).to(["j", "i"]),
        P([4, 3], strides=[1, 4], offset=5),
    ]


def test_views_match_reference_exactly():
    for got, want in zip(views(port), views(ref)):
        assert (got.dims, got.strides, got.offset, got.labels, got.rank, got.size,
                got.is_dense()) == (want.dims, want.strides, want.offset, want.labels,
                                    want.rank, want.size, want.is_dense())
        np.testing.assert_array_equal(got.absolute_index_list(), want.absolute_index_list())
        assert repr(got) == repr(want)
        for multi in np.ndindex(*got.dims):
            assert got.absolute_index(multi) == want.absolute_index(multi)


def test_bijection_matches_reference():
    got, want = port.ProductIndices([3, 5, 7]), ref.ProductIndices([3, 5, 7])
    for flat in range(got.size):
        assert got.indices(flat) == want.indices(flat)
        assert got.absolute_index(got.indices(flat)) == flat
    for multi in [(0, 0, 0), (2, 4, 6), (1, 3, 2)]:
        assert got.absolute_index(multi) == np.ravel_multi_index(multi, (3, 5, 7))


def test_add_indices_match_reference():
    rng = np.random.default_rng(0)
    dims = rng.integers(1, 6, size=9).tolist()
    got, want = port.AddIndices(dims), ref.AddIndices(dims)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert (got.dim, got.num_blocks, got.block_dims) == (want.dim, want.num_blocks, want.block_dims)
    flat = np.arange(got.dim)
    np.testing.assert_array_equal(got.first_array(flat), want.first_array(flat))
    for f in flat:
        assert (got.first(f), got.second(f)) == (want.first(f), want.second(f))
    for b in range(-3, 2 * got.num_blocks):
        assert got.absolute_index(b, 0) == want.absolute_index(b, 0)
    assert got == port.AddIndices(dims) and hash(got) == hash(port.AddIndices(dims))


def test_shuffle_helpers_match_reference():
    for perm in [(2, 0, 1), (0,), (3, 1, 0, 2)]:
        assert port.make_reverse_shuffle(perm) == ref.make_reverse_shuffle(perm)
    for i, n in [(7, 3), (-1, 4), (5, 0)]:
        assert port.periodic_mod(i, n) == ref.periodic_mod(i, n)
    s = port.Slice(3, 4, 2)
    np.testing.assert_array_equal(s.indices(), ref.Slice(3, 4, 2).indices())
    assert s.absolute(3) == 9


def test_reference_cases_on_the_port():
    pi = port.ProductIndices([2, 3, 4]).shuffle([2, 0, 1])
    at = np.transpose(np.arange(24).reshape(2, 3, 4), (2, 0, 1))
    for multi in [(0, 0, 0), (3, 1, 2), (1, 0, 1)]:
        assert pi.absolute_index(multi) == at[multi]
    a = np.arange(36).reshape(3, 4, 3)
    pi = port.ProductIndices([3, 4, 3]).from_(["i", "j", "i"]).to(["i", "j"])
    assert all(pi.absolute_index((i, j)) == a[i, j, i] for i in range(3) for j in range(4))
    np.testing.assert_array_equal(port.AddIndices([3, 5, 2]).offsets, [0, 3, 8, 10])


@pytest.mark.parametrize("bad", [
    lambda m: m.ProductIndices([2, 3]).delta(0, 1),
    lambda m: m.ProductIndices([2, 3]).delta(1, 1),
    lambda m: m.ProductIndices([2, 3]).shuffle([0, 0]),
    lambda m: m.ProductIndices([2, 3]).shuffle([1, 0]).indices(0),
    lambda m: m.ProductIndices([2, 3]).from_(["i", "j"]).to(["k"]),
    lambda m: m.ProductIndices([2, 3]).from_(["i", "i"]).to(["i"]),
    lambda m: m.ProductIndices([2, 3]).from_(["i", "j"]).to(["i", "i"]),
    lambda m: m.ProductIndices([10]).sliced(0, m.Slice(8, 3, 1)),
    lambda m: m.ProductIndices([-1]),
    lambda m: m.AddIndices([2, 0]),
])
def test_errors_match_reference(bad):
    with pytest.raises(EigenexError) as got:
        bad(port)
    with pytest.raises(Exception) as want:
        bad(ref)
    assert str(got.value) == str(want.value)
