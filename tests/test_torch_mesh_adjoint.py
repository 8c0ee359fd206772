"""The mesh operators' adjoint in the port against the JAX package, on the CPU.

The reference derives ``rmatvec`` of ``mesh_operator`` (every matvec mode)
and of ``mesh_operator_2d`` with ``jax.vjp`` through ``shard_map``; the port
gives each an explicit reverse product over the same collectives, transposed,
and the adjoints of the same shard containers.  Both packages get the same
numpy-seeded operators (n <= 96, (4, 4) blocks; (4, 16) blocks for the
padded reverse pieces), the JAX side on 4 or 8 of its virtual CPU devices,
the port on ``make_mesh(devices=["cpu"] * n)``.  In f64 and complex128 every
reverse product equals the reference's and the dense A^H x to 1e-12.  Then
the case that raised before: ``eigs(sigma=, mesh=)`` on an 80 x 80 Gaussian,
whose inner GMRES falls back to CGLS, held to the reference's eigenvalues to
1e-9.  (Across processes: ``tests/test_torch_multiprocess.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import eigenex_tpu as ex
import eigenex_tpu.parallel.distributed as jd
import eigenex_tpu_torch as ext
import eigenex_tpu_torch.parallel.distributed as td
from eigenex_tpu.sparse.bsr import BSRMatrix as JBSR
from eigenex_tpu.sparse.coo import COOMatrix as JCOO
from eigenex_tpu_torch.convert import coo_from_numpy
from eigenex_tpu_torch.parallel import Mesh, make_mesh
from eigenex_tpu_torch.sparse.bsr import BSRMatrix

torch.set_num_threads(1)

SHARDS = 4
TOL = 1e-12


def general_banded(n, block, reach, seed, complex_=False, hermitian=False):
    """(data, cols, A): an ELL pack (blocks ``block``) of a numpy-seeded
    matrix whose entries reach ``reach`` row blocks either side of the
    diagonal."""
    bm, bn = block
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if complex_:
        A = A + 1j * rng.standard_normal((n, n))
    rows, cols_ = np.indices((n, n))
    A[np.abs(rows - cols_) > reach * bm + bm - 1] = 0
    if hermitian:
        A = (A + A.conj().T) / 2
    nbr, nbc = n // bm, n // bn
    blocks = {(r, c): A[r * bm:(r + 1) * bm, c * bn:(c + 1) * bn]
              for r in range(nbr) for c in range(nbc)
              if np.any(A[r * bm:(r + 1) * bm, c * bn:(c + 1) * bn])}
    kmax = max(sum(1 for (r, _) in blocks if r == row) for row in range(nbr))
    data = np.zeros((nbr, kmax, bm, bn), A.dtype)
    cols = np.zeros((nbr, kmax), np.int32)
    for row in range(nbr):
        for slot, c in enumerate(sorted(c for (r, c) in blocks if r == row)):
            data[row, slot], cols[row, slot] = blocks[(row, c)], c
    return data, cols, A


def pair(data, cols, shape):
    return (JBSR(jnp.asarray(data), jnp.asarray(cols), shape),
            BSRMatrix(torch.as_tensor(data), torch.as_tensor(cols), shape))


def close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices("cpu")[:SHARDS]), ("rows",))


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(devices=["cpu"] * SHARDS)


@pytest.mark.parametrize("complex_", [False, True], ids=["f64", "c128"])
@pytest.mark.parametrize("mode", ["allgather", "colsplit", "halo", "sym_halo"])
def test_every_mode_reverse_product_matches_the_reference_vjp(jmesh, tmesh, mode, complex_):
    """``rmatvec`` of each mode's mesh operator against the reference's
    vjp-derived one and the dense A^H y; ``.H.matvec`` is the same product.
    sym_halo takes a BSRMatrix packed to half storage (Hermitian by
    construction, so the reverse product is the forward one)."""
    data, cols, A = general_banded(96, (4, 4), 2, 1, complex_, hermitian=mode == "sym_halo")
    jb, tb = pair(data, cols, A.shape)
    rng = np.random.default_rng(2)
    y = rng.standard_normal(96) + (1j * rng.standard_normal(96) if complex_ else 0)
    jop = jd.mesh_operator(jb, jmesh, matvec_mode=mode)
    top = td.mesh_operator(tb, tmesh, matvec_mode=mode)
    got = top.rmatvec(torch.as_tensor(y))
    close(got, jop.rmatvec(jnp.asarray(y)))
    close(got, A.conj().T @ y)
    assert top.has_adjoint and torch.equal(top.H.matvec(torch.as_tensor(y)), got)
    if mode == "sym_halo":
        assert torch.equal(got, top.matvec(torch.as_tensor(y)))


@pytest.mark.parametrize("complex_", [False, True], ids=["f64", "c128"])
@pytest.mark.parametrize("block", [(4, 4), (4, 16)], ids=["4x4", "4x16"])
def test_grid_reverse_product_matches_the_reference_vjp(complex_, block):
    """``mesh_operator_2d`` on a 2 x 4 mesh (not square: the transposed
    layout is not the forward one): its reverse product against the
    reference's vjp and the dense A^H y."""
    data, cols, A = general_banded(96 if block == (4, 4) else 128, block, 3, 5, complex_)
    jb, tb = pair(data, cols, A.shape)
    jm = JMesh(np.array(jax.devices("cpu")[:8]).reshape(2, 4), ("rows", "cols"))
    tm = Mesh(np.array(["cpu"] * 8).reshape(2, 4), ("rows", "cols"))
    rng = np.random.default_rng(6)
    n = A.shape[0]
    y = rng.standard_normal(n) + (1j * rng.standard_normal(n) if complex_ else 0)
    top = td.mesh_operator_2d(tb, tm)
    got = top.rmatvec(torch.as_tensor(y))
    close(got, jd.mesh_operator_2d(jb, jm).rmatvec(jnp.asarray(y)))
    close(got, A.conj().T @ y)
    close(top.H.matvec(torch.as_tensor(y)), A.conj().T @ y)


@pytest.mark.parametrize("mode", ["allgather", "colsplit"])
def test_reverse_pieces_of_rectangular_blocks_padded_to_whole_blocks(jmesh, tmesh, mode):
    """(4, 16) blocks, as a 32x128 general pack: at 96 rows a shard holds 24
    rows, which 16-wide blocks do not tile, so the allgather piece's adjoint
    is packed over padded rows and the reverse product pads and cuts; the
    colsplit panel tiles as it is.  Both against the reference and A^H y,
    their pieces in the forward's block shape."""
    n = 96 if mode == "allgather" else 128
    data, cols, A = general_banded(n, (4, 16), 2, 7, complex_=True)
    jb, tb = pair(data, cols, A.shape)
    y = np.random.default_rng(8).standard_normal(n) + 0.5j
    top = td.mesh_operator(tb, tmesh, matvec_mode=mode)
    got = top.rmatvec(torch.as_tensor(y))
    close(got, jd.mesh_operator(jb, jmesh, matvec_mode=mode).rmatvec(jnp.asarray(y)))
    close(got, A.conj().T @ y)
    for parts in top._params.parts.pieces:
        adj = parts.reverse("main")
        assert adj.block_shape == (4, 16)
        padded = adj.shape != (parts.main.shape[1], parts.main.shape[0])
        assert padded == (mode == "allgather")


def test_reverse_pieces_are_built_at_the_first_reverse_product_and_kept(tmesh):
    """A solve that never takes the adjoint holds no reverse piece; the
    first ``rmatvec`` builds one a shard container and role, and a second
    reuses them (bit-equal results)."""
    data, cols, A = general_banded(96, (4, 4), 2, 9)
    top = td.mesh_operator(BSRMatrix(torch.as_tensor(data), torch.as_tensor(cols), A.shape),
                           tmesh, matvec_mode="halo")
    x = torch.as_tensor(np.random.default_rng(10).standard_normal(96))
    top.matvec(x)
    pieces = top._params.parts.pieces
    assert all(p.reverse_roles() == {} for p in pieces)
    first = top.rmatvec(x)
    built = [p.reverse_roles() for p in pieces]
    assert all(set(b) == {"main", "left", "right"} for b in built)
    assert torch.equal(top.rmatvec(x), first)
    assert all(p.reverse_roles()[r] is b[r] for p, b in zip(pieces, built) for r in b)


def test_eigs_sigma_on_a_mesh_falls_back_to_cgls_and_matches_the_reference(jmesh, tmesh):
    """The case that raised ``OperatorError`` before: ``eigs(sigma=0.1,
    mesh=4 shards)`` on an 80 x 80 standard-normal matrix (numpy seed 0),
    where restarted GMRES stagnates and every inner solve falls back to
    CGLS on the mesh operator's reverse product; the eigenvalues nearest
    sigma against the reference's to 1e-9."""
    A = np.random.default_rng(0).standard_normal((80, 80))
    r, c = np.nonzero(A)
    kw = dict(k=2, sigma=0.1, tol=1e-10, max_subspace=40)
    jcoo = JCOO(jnp.asarray(r.astype(np.int32)), jnp.asarray(c.astype(np.int32)),
                jnp.asarray(A[r, c]), A.shape)
    want = np.asarray(ex.eigs(jcoo, mesh=jmesh, **kw).eigenvalues)
    res = ext.eigs(coo_from_numpy(r, c, A[r, c], A.shape, device="cpu"), mesh=tmesh,
                   device="cpu", **kw)
    got = np.asarray(res.eigenvalues)
    assert res.inner_stats["fallbacks"] >= 1 and res.inner_stats["adjoint_forwards"] == 0
    key = lambda z: np.sort_complex(z.real + 1j * np.abs(z.imag))
    np.testing.assert_allclose(key(got), key(want), rtol=0, atol=1e-9)
    np.testing.assert_allclose(key(got), key(np.array([0.51828986105910 + 0.41664525657464j,
                                                       0.51828986105910 - 0.41664525657464j])),
                               rtol=0, atol=1e-9)
