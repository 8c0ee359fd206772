"""``accelerate()`` parity: the port's symmetric real route against the JAX
package's numpy/scipy route (its native C++ packers switched off, so both
run the same RCM and the same packer) on the same numpy-seeded triplets.

The pack is integer and copy work: permutation, band reach, slot count,
storage dtype and the dense operator are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import eigenex_tpu.native as j_native
from eigenex_tpu.sparse.accelerate import accelerate as j_accelerate
from eigenex_tpu_torch.sparse.accelerate import (
    AcceleratedOperator,
    _bf16_lossless,
    _padding_safe_v0,
    accelerate,
    band_permutation,
)
from eigenex_tpu_torch.sparse.coo import coo_from_dense
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


@pytest.fixture
def numpy_route(monkeypatch):
    """The reference without its native packers: scipy RCM + numpy packer."""
    monkeypatch.setattr(j_native, "native_available", lambda: False)


def band_triplets(n, seed, dyadic=True):
    """Random symmetric band pattern with a heavy diagonal, shuffled by a
    random relabelling so that RCM has work to do."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 2)
    c = r + rng.integers(1, 9, size=len(r))
    keep = c < n
    r, c = r[keep], c[keep]
    key, first = np.unique(r * n + c, return_index=True)
    r, c = r[first], c[first]
    v = rng.standard_normal(len(r))
    if dyadic:
        v = np.round(v * 8) / 8
        v[v == 0] = 0.125
    relabel = rng.permutation(n)
    rows = relabel[np.concatenate([r, c, np.arange(n)])]
    cols = relabel[np.concatenate([c, r, np.arange(n)])]
    vals = np.concatenate([v, v, np.full(n, 4.0)])
    return rows, cols, vals, (n, n)


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic_bf16", "gaussian_f32"])
def test_pack_matches_reference_numpy_route(numpy_route, dyadic):
    trip = band_triplets(300, 0, dyadic)
    ref = j_accelerate(trip, block=8)
    got = accelerate(trip, block=8, device="cpu")
    assert isinstance(got, AcceleratedOperator)
    assert np.array_equal(got.perm, ref.perm)
    assert got.matrix.band_reach == ref.matrix.band_reach
    assert got.stats["ku"] == ref.stats["ku"] == got.matrix.upper_cols.shape[1]
    assert got.stats["dtype"] == ref.stats["dtype"] == ("bfloat16" if dyadic else "float32")
    for key in ("nnz", "slots", "fill", "bytes", "bandwidth_before", "bandwidth_after",
                "band_reach", "symmetric", "complexified"):
        assert got.stats[key] == ref.stats[key], key
    assert got.shape == ref.shape == (512, 512)  # padded to 32 block rows of 8
    assert got.n_work == 300 and got.orig_shape == (300, 300) and got.symmetric
    dense_ref = np.asarray(ref.matrix.to_dense().astype(jnp.float32))
    assert np.array_equal(got.matrix.to_dense().float().numpy(), dense_ref)
    assert np.array_equal(got.matrix.upper_cols.numpy(), np.asarray(ref.matrix.upper_cols))
    # the packed operator is P A P^T, zero-padded
    A = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3]).toarray()
    want = np.zeros((512, 512), np.float32)
    want[:300, :300] = A[np.ix_(got.perm, got.perm)]
    assert np.array_equal(dense_ref, want)
    assert got.stats["bandwidth_after"] < got.stats["bandwidth_before"]


def test_f64_pack_matches_reference(numpy_route):
    trip = band_triplets(200, 1)
    ref = j_accelerate(trip, block=8, dtype=jnp.float64)
    got = accelerate(trip, block=8, dtype=torch.float64, device="cpu")
    assert got.matrix.dtype == torch.float64 and got.stats["dtype"] == ref.stats["dtype"]
    assert np.array_equal(got.matrix.to_dense().numpy(), np.asarray(ref.matrix.to_dense()))
    x = np.random.default_rng(2).standard_normal(200)
    e_ref, e_got = ref.embed(x), got.embed(x)
    assert e_got.dtype == torch.float64 and np.array_equal(e_got.numpy(), np.asarray(e_ref))


def test_operands_and_options(numpy_route):
    trip = band_triplets(120, 3)
    A = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3])
    base = accelerate(trip, block=8, device="cpu")
    for operand in (A, A.tocsr(), coo_from_dense(A.toarray(), device="cpu")):
        other = accelerate(operand, block=8, device="cpu")
        assert torch.equal(other.matrix.to_dense(), base.matrix.to_dense())
    # duplicate triplets are merged before the symmetry check
    r, c, v, shape = trip
    split = (np.concatenate([r, r]), np.concatenate([c, c]), np.concatenate([v / 2, v / 2]), shape)
    assert torch.equal(accelerate(split, block=8, device="cpu").matrix.to_dense(),
                       base.matrix.to_dense())
    flat = accelerate(trip, block=8, reorder=False, device="cpu")
    assert np.array_equal(flat.perm, np.arange(120))
    assert accelerate(trip, block=8, dtype="float32", device="cpu").matrix.dtype == torch.float32
    assert accelerate(trip, block=8, symmetric=True, device="cpu").stats["symmetric"]


def test_band_permutation_is_scipy_rcm_and_reduces_bandwidth():
    r, c, _, (n, _) = band_triplets(150, 4)
    perm = band_permutation(r, c, n)
    assert sorted(perm.tolist()) == list(range(n))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    assert np.abs(inv[r] - inv[c]).max() < np.abs(r - c).max()


def test_embed_restore_round_trip():
    trip = band_triplets(100, 5)
    acc = accelerate(trip, block=8, device="cpu")
    rng = np.random.default_rng(6)
    x, X = rng.standard_normal(100).astype(np.float32), rng.standard_normal((100, 3))
    e = acc.embed(x)
    assert e.shape == (acc.shape[0],) and e.dtype == torch.float32
    assert torch.all(e[100:] == 0)  # zero on the padding rows
    assert np.array_equal(acc.restore(e), x)
    assert np.array_equal(acc.restore(acc.embed(X)), X.astype(np.float32))
    assert np.array_equal(acc.restore(acc.embed(torch.as_tensor(x))), x)
    # the embedded operator acts like the original on embedded vectors
    A = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3]).toarray()
    y = acc.restore(acc.as_linear_operator().matvec(e))
    np.testing.assert_allclose(y, A @ x, rtol=0, atol=1e-4)
    with pytest.raises(EigenexError):
        acc.embed(np.ones(99))
    with pytest.raises(EigenexError):
        acc.restore(np.ones(100))
    with pytest.raises(EigenexError):
        acc.embed(np.ones(100) * 1j)


def test_padding_safe_start_vector():
    v = _padding_safe_v0(100, 256, torch.float32, seed=3, device="cpu")
    assert v.shape == (256,) and torch.all(v[100:] == 0) and float(v[:100].abs().min()) > 0
    assert torch.equal(v, _padding_safe_v0(100, 256, torch.float32, seed=3, device="cpu"))


def test_bf16_lossless_probe():
    assert _bf16_lossless(np.array([0.5, -0.25, 4.0, 1.625, 0.0]))
    assert not _bf16_lossless(np.array([0.1]))
    assert not _bf16_lossless(np.array([1.0 + 2.0**-9]))


@pytest.mark.parametrize("how", ["auto_detect", "claimed_symmetric"])
def test_non_hermitian_input_raises(how):
    r, c, v, shape = band_triplets(80, 7)
    v = v.copy()
    v[0] += 1.0  # one entry no longer equals its mirror
    with pytest.raises(EigenexError):
        if how == "auto_detect":  # detected exactly -> the general pack, not ported
            accelerate((r, c, v, shape), block=8, device="cpu")
        else:  # the sampled probe behind symmetric=True catches it
            accelerate((r, c, v, shape), block=8, symmetric=True, device="cpu")
    upper = r < c
    with pytest.raises(EigenexError, match="not Hermitian"):
        accelerate((r[upper], c[upper], v[upper], shape), block=8, symmetric=True, device="cpu")


@pytest.mark.parametrize(
    "build",
    [
        lambda: accelerate((np.array([0]), np.array([1]), np.array([1.0]), (2, 3)), device="cpu"),
        lambda: accelerate((np.array([0, 1]), np.array([1, 0]), np.array([1j, -1j]), (2, 2)),
                           device="cpu"),
        lambda: accelerate((np.array([0]), np.array([1]), np.array([1.0]), (2, 2)), device="cpu"),
        lambda: accelerate(band_triplets(40, 8), block=8, device="cpu").save("x.npz"),
        lambda: AcceleratedOperator.load("x.npz"),
    ],
    ids=["rectangular", "complex", "general", "save", "load"],
)
def test_unported_routes_say_so(build):
    with pytest.raises(EigenexError, match="not ported yet"):
        build()


def test_bad_operand_raises():
    with pytest.raises(EigenexError):
        accelerate(np.eye(3), device="cpu")
