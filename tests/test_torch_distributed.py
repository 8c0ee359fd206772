"""The distributed layer of the port against the JAX package's, on the CPU.

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``), the
port on ``make_mesh(devices=["cpu"] * 8)``; both get the same numpy-seeded
operators.  Splits are held bit-equal to the reference's and rejections
word for word; every matvec mode's products and the distributed Lanczos
recurrence to 1e-12 in f64; the distributed drivers' eigenvalues to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import eigenex_tpu.parallel.distributed as jd
import eigenex_tpu_torch.parallel.distributed as td
from eigenex_tpu.solvers.lanczos import init_lanczos_state as j_init_state
from eigenex_tpu.solvers.lanczos import LanczosOptions as JLanczosOptions
from eigenex_tpu.solvers.restart import ThickRestartOptions as JTROptions
from eigenex_tpu.solvers.krylov_schur import KrylovSchurOptions as JKSOptions
from eigenex_tpu.sparse.bsr import BSRMatrix as JBSR
from eigenex_tpu.sparse.sym_bsr import SymBSRMatrix as JSym
from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr as j_sym_from_bsr
from eigenex_tpu_torch.parallel import Mesh, initialize_multihost, make_mesh
from eigenex_tpu_torch.solvers.krylov_schur import KrylovSchurOptions
from eigenex_tpu_torch.solvers.lanczos import LanczosOptions, init_lanczos_state, lanczos_steps
from eigenex_tpu_torch.solvers.restart import ThickRestartOptions
from eigenex_tpu_torch.sparse.bsr import BSRMatrix
from eigenex_tpu_torch.sparse.sym_bsr import SymBSRMatrix, sym_bsr_from_bsr
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)

MODES = ["allgather", "colsplit", "halo", "sym_halo"]


def banded_pack(nbr=24, b=4, reach=1, seed=0, symmetric=True, holes=True):
    """(data, cols) of a block-banded ELL pack with numpy-seeded f64 blocks,
    symmetric when asked, with a few all-zero stored blocks."""
    rng = np.random.default_rng(seed)
    kmax = 2 * reach + 1
    A = np.zeros((nbr * b, nbr * b))
    for r in range(nbr):
        for c in range(max(0, r - reach), min(nbr, r + reach + 1)):
            A[r * b:(r + 1) * b, c * b:(c + 1) * b] = np.round(rng.standard_normal((b, b)) * 8) / 8
    if symmetric:
        A = (A + A.T) / 2
    data = np.zeros((nbr, kmax, b, b))
    cols = np.zeros((nbr, kmax), np.int32)
    for r in range(nbr):
        for slot, c in enumerate(range(max(0, r - reach), min(nbr, r + reach + 1))):
            blk = A[r * b:(r + 1) * b, c * b:(c + 1) * b]
            if holes and (r * 7 + c) % 11 == 0 and c != r:
                blk = np.zeros_like(blk)  # a stored all-zero block: the splits skip it
                A[r * b:(r + 1) * b, c * b:(c + 1) * b] = 0
                A[c * b:(c + 1) * b, r * b:(r + 1) * b] = 0 if symmetric else A[c * b:(c + 1) * b, r * b:(r + 1) * b]
            data[r, slot] = blk
            cols[r, slot] = c
    if symmetric:  # re-read the blocks after zeroing mirrors
        for r in range(nbr):
            for slot, c in enumerate(range(max(0, r - reach), min(nbr, r + reach + 1))):
                data[r, slot] = A[r * b:(r + 1) * b, c * b:(c + 1) * b]
    return data, cols, A


def pair(data, cols, shape):
    """(reference BSR, port BSR) of the same arrays."""
    return (JBSR(jnp.asarray(data), jnp.asarray(cols), shape),
            BSRMatrix(torch.as_tensor(data), torch.as_tensor(cols), shape))


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices("cpu")[:8]), ("rows",))


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh4():
    return JMesh(np.array(jax.devices("cpu")[:4]), ("rows",))


@pytest.fixture(scope="module")
def tmesh4():
    """The solver tests run on 4 shards: a collective costs a barrier of
    every shard's thread, and the recurrences make thousands."""
    return make_mesh(devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def ops():
    data, cols, A = banded_pack()
    jb, tb = pair(data, cols, A.shape)
    return jb, tb, A


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# splits: bit-equal, rejections word for word
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_halo_split_bit_equal(shards):
    data, cols, A = banded_pack(reach=1, symmetric=False)
    jb, tb = pair(data, cols, A.shape)
    for jp, tp in zip(jd.split_bsr_halo(jb, shards), td.split_bsr_halo(tb, shards)):
        np.testing.assert_array_equal(as_np(tp[0]), np.asarray(jp[0]))
        np.testing.assert_array_equal(as_np(tp[1]), np.asarray(jp[1]))
        assert tp[1].dtype == torch.int32


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sym_halo_split_and_reach_bit_equal(shards):
    data, cols, A = banded_pack(reach=2)
    jb, tb = pair(data, cols, A.shape)
    js, ts = j_sym_from_bsr(jb), sym_bsr_from_bsr(tb)
    jdiag, jin, jright = jd.split_sym_bsr_halo(js, shards)
    tdiag, tin, tright = td.split_sym_bsr_halo(ts, shards)
    np.testing.assert_array_equal(as_np(tdiag), np.asarray(jdiag))
    for jp, tp in ((jin, tin), (jright, tright)):
        np.testing.assert_array_equal(as_np(tp[0]), np.asarray(jp[0]))
        np.testing.assert_array_equal(as_np(tp[1]), np.asarray(jp[1]))
    rows_per = js.n_block_rows // shards
    assert td.sym_inpanel_reach(tin[0], tin[1], rows_per) == jd.sym_inpanel_reach(
        jin[0], jin[1], rows_per)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_colpanel_split_bit_equal(shards):
    data, cols, A = banded_pack(reach=3, symmetric=False)
    jb, tb = pair(data, cols, A.shape)
    jp, tp = jd.split_bsr_colpanels(jb, shards), td.split_bsr_colpanels(tb, shards)
    np.testing.assert_array_equal(as_np(tp[0]), np.asarray(jp[0]))
    np.testing.assert_array_equal(as_np(tp[1]), np.asarray(jp[1]))


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8), (3, 2)])
def test_grid_split_bit_equal(grid):
    data, cols, A = banded_pack(reach=3, symmetric=False)
    jb, tb = pair(data, cols, A.shape)
    jp, tp = jd.split_bsr_grid(jb, *grid), td.split_bsr_grid(tb, *grid)
    np.testing.assert_array_equal(as_np(tp[0]), np.asarray(jp[0]))
    np.testing.assert_array_equal(as_np(tp[1]), np.asarray(jp[1]))


def test_pads_bit_equal():
    data, cols, A = banded_pack(nbr=21, reach=1)
    jb, tb = pair(data, cols, A.shape)
    for jp, tp in ((jd.pad_bsr_for_mesh(jb, 8), td.pad_bsr_for_mesh(tb, 8)),
                   (jd.pad_bsr_rect(jb, 4), td.pad_bsr_rect(tb, 4))):
        assert tp.shape == jp.shape
        np.testing.assert_array_equal(as_np(tp.data), np.asarray(jp.data))
        np.testing.assert_array_equal(as_np(tp.block_cols), np.asarray(jp.block_cols))
    js, ts = jd.pad_bsr_for_mesh(j_sym_from_bsr(jb), 8), td.pad_bsr_for_mesh(sym_bsr_from_bsr(tb), 8)
    assert ts.shape == js.shape and ts.band_reach == js.band_reach
    np.testing.assert_array_equal(as_np(ts.upper_data), np.asarray(js.upper_data))
    rect_j = JBSR(jb.data[:10], jb.block_cols[:10], (40, 84))
    rect_t = BSRMatrix(tb.data[:10], tb.block_cols[:10], (40, 84))
    assert td.pad_bsr_rect(rect_t, 4).shape == jd.pad_bsr_rect(rect_j, 4).shape


def messages(fn_j, fn_t):
    with pytest.raises(Exception) as ej:
        fn_j()
    with pytest.raises(EigenexError) as et:
        fn_t()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("case", ["halo_reach", "halo_pad", "sym_reach", "sym_pad",
                                  "colpanel_pad", "grid_pad", "packed_reach", "packed_mode"])
def test_rejections_match_the_reference(case):
    data, cols, A = banded_pack(nbr=16, reach=3)
    jb, tb = pair(data, cols, A.shape)
    odd_j, odd_t = pair(data[:13], cols[:13] % 13, (52, 52))
    if case == "halo_reach":
        messages(lambda: jd.split_bsr_halo(jb, 8), lambda: td.split_bsr_halo(tb, 8))
    elif case == "halo_pad":
        messages(lambda: jd.split_bsr_halo(odd_j, 8), lambda: td.split_bsr_halo(odd_t, 8))
    elif case == "sym_reach":
        messages(lambda: jd.split_sym_bsr_halo(j_sym_from_bsr(jb), 8),
                 lambda: td.split_sym_bsr_halo(sym_bsr_from_bsr(tb), 8))
    elif case == "sym_pad":
        messages(lambda: jd.split_sym_bsr_halo(j_sym_from_bsr(odd_j), 8),
                 lambda: td.split_sym_bsr_halo(sym_bsr_from_bsr(odd_t), 8))
    elif case == "colpanel_pad":
        messages(lambda: jd.split_bsr_colpanels(odd_j, 8), lambda: td.split_bsr_colpanels(odd_t, 8))
    elif case == "grid_pad":
        messages(lambda: jd.split_bsr_grid(odd_j, 2, 4), lambda: td.split_bsr_grid(odd_t, 2, 4))
    else:
        js = JSym(*(jnp.asarray(np.asarray(getattr(j_sym_from_bsr(jb), f)))
                    for f in ("diag_data", "upper_data", "upper_cols")), A.shape, 5)
        ts = SymBSRMatrix(*(torch.as_tensor(np.array(getattr(js, f)))
                            for f in ("diag_data", "upper_data", "upper_cols")), A.shape, 5)
        jm = JMesh(np.array(jax.devices("cpu")[:8]), ("rows",))
        tm = make_mesh(devices=["cpu"] * 8)
        if case == "packed_reach":
            messages(lambda: jd.prepare_packed_mesh(js, jm, "allgather"),
                     lambda: td.prepare_packed_mesh(ts, tm, "allgather"))
        else:
            messages(lambda: jd.prepare_packed_mesh(js, jm, "halo"),
                     lambda: td.prepare_packed_mesh(ts, tm, "halo"))


def test_prepare_packed_mesh_flattens_and_picks_sym_halo():
    data, cols, A = banded_pack(nbr=24, reach=1)
    ts = sym_bsr_from_bsr(pair(data, cols, A.shape)[1])
    ts = SymBSRMatrix(ts.diag_data, ts.upper_data, ts.upper_cols, ts.shape, 1)
    m2 = Mesh(np.array(["cpu"] * 8).reshape(2, 4), ("rows", "cols"))
    mesh, mode = td.prepare_packed_mesh(ts, m2, "allgather")
    assert mode == "sym_halo" and mesh.axis_names == ("rows",) and mesh.shape["rows"] == 8
    general = pair(data, cols, A.shape)[1]
    assert td.prepare_packed_mesh(general, m2, "colsplit")[1] == "colsplit"


# ---------------------------------------------------------------------------
# every mode's products against the JAX mesh operator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_mesh_operator_matches_reference(ops, jmesh, tmesh, mode):
    jb, tb, A = ops
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    X = np.random.default_rng(4).standard_normal((A.shape[0], 5))
    jop = jd.mesh_operator(jb, jmesh, matvec_mode=mode)
    top = td.mesh_operator(tb, tmesh, matvec_mode=mode)
    np.testing.assert_allclose(as_np(top.matvec(torch.as_tensor(x))),
                               np.asarray(jop.matvec(jnp.asarray(x))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(as_np(top.matmat(torch.as_tensor(X))),
                               np.asarray(jop.matmat(jnp.asarray(X))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(as_np(top.matvec(torch.as_tensor(x))), A @ x, atol=1e-12)


def test_sym_halo_on_a_sym_container_reruns_bit_equal(ops, tmesh):
    _, tb, A = ops
    op = td.mesh_operator(sym_bsr_from_bsr(tb), tmesh, matvec_mode="sym_halo")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(A.shape[0]))
    y1, y2 = op.matvec(x), op.matvec(x)
    assert torch.equal(y1, y2)
    np.testing.assert_allclose(as_np(y1), A @ as_np(x), atol=1e-12)
    np.testing.assert_allclose(as_np(op.rmatvec(x)), as_np(y1), atol=0)


@pytest.mark.parametrize("shape2d", [(2, 4), (4, 2)])
def test_mesh_operator_2d_matches_reference(ops, shape2d):
    jb, tb, A = ops
    jm = JMesh(np.array(jax.devices("cpu")[:8]).reshape(shape2d), ("rows", "cols"))
    tm = Mesh(np.array(["cpu"] * 8).reshape(shape2d), ("rows", "cols"))
    jop, top = jd.mesh_operator_2d(jb, jm), td.mesh_operator_2d(tb, tm)
    x = np.random.default_rng(6).standard_normal(A.shape[0])
    X = np.random.default_rng(7).standard_normal((A.shape[0], 3))
    np.testing.assert_allclose(as_np(top.matvec(torch.as_tensor(x))),
                               np.asarray(jop.matvec(jnp.asarray(x))), atol=1e-12)
    np.testing.assert_allclose(as_np(top.matmat(torch.as_tensor(X))),
                               np.asarray(jop.matmat(jnp.asarray(X))), atol=1e-12)
    # chained products need no re-layout
    y = top.matvec(top.matvec(torch.as_tensor(x)))
    np.testing.assert_allclose(as_np(y), A @ (A @ x), atol=1e-10)
    with pytest.raises(EigenexError, match="2-axis"):
        td.mesh_operator_2d(tb, make_mesh(devices=["cpu"] * 8))


def test_mode_validation(ops, tmesh):
    _, tb, _ = ops
    with pytest.raises(EigenexError, match="unknown matvec_mode"):
        td.mesh_operator(tb, tmesh, matvec_mode="ring")
    with pytest.raises(EigenexError, match="sym_halo"):
        td.mesh_operator(sym_bsr_from_bsr(tb), tmesh, matvec_mode="halo")
    odd = BSRMatrix(tb.data[:21], tb.block_cols[:21] % 21, (84, 84))
    with pytest.raises(EigenexError, match="pad_bsr_for_mesh"):
        td.mesh_operator(odd, tmesh)


def test_shard_bodies_match_reference(ops, jmesh, tmesh):
    """halo_matvec and sym_halo_matvec called inside shard bodies, on the
    split arrays, against the JAX functions inside jax.shard_map."""
    from jax import shard_map as jshard_map
    from jax.sharding import PartitionSpec as JP

    from eigenex_tpu_torch.parallel.shard_map import P, shard_map

    jb, tb, A = ops
    x = np.random.default_rng(8).standard_normal(A.shape[0])
    jparts = jd.split_bsr_halo(jb, 8)
    tparts = td.split_bsr_halo(tb, 8)
    jf = jshard_map(lambda dd, dc, ld, lc, rd, rc, x: jd.halo_matvec(
        dd, dc, ld, lc, rd, rc, x, axis_name="rows", bn=4), mesh=jmesh,
        in_specs=(JP("rows"),) * 7, out_specs=JP("rows"))
    tf = shard_map(lambda c, dd, dc, ld, lc, rd, rc, x: td.halo_matvec(
        dd, dc, ld, lc, rd, rc, x, comm=c.along("rows")), tmesh,
        in_specs=(P("rows"),) * 7, out_specs=P("rows"))
    flat = [a for p in jparts for a in p]
    np.testing.assert_allclose(as_np(tf(*[t for p in tparts for t in p], torch.as_tensor(x))),
                               np.asarray(jf(*flat, jnp.asarray(x))), atol=1e-12)
    js, ts = j_sym_from_bsr(jb), sym_bsr_from_bsr(tb)
    jdg, (jid, jic), (jrd, jrc) = jd.split_sym_bsr_halo(js, 8)
    tdg, (tid, tic), (trd, trc) = td.split_sym_bsr_halo(ts, 8)
    jf = jshard_map(lambda *a: jd.sym_halo_matvec(*a, axis_name="rows", bn=4), mesh=jmesh,
                    in_specs=(JP("rows"),) * 6, out_specs=JP("rows"))
    tf = shard_map(lambda c, *a: td.sym_halo_matvec(*a, comm=c.along("rows")), tmesh,
                   in_specs=(P("rows"),) * 6, out_specs=P("rows"))
    X = np.random.default_rng(9).standard_normal((A.shape[0], 3))
    np.testing.assert_allclose(
        as_np(tf(tdg, tid, tic, trd, trc, torch.as_tensor(x))),
        np.asarray(jf(jdg, jid, jic, jrd, jrc, jnp.asarray(x))), atol=1e-12)
    tfm = shard_map(lambda c, *a: td.sym_halo_matmat(*a, comm=c.along("rows")), tmesh,
                    in_specs=(P("rows"),) * 6, out_specs=P("rows"))
    np.testing.assert_allclose(as_np(tfm(tdg, tid, tic, trd, trc, torch.as_tensor(X))),
                               A @ X, atol=1e-12)


# ---------------------------------------------------------------------------
# the distributed recurrences
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_distributed_lanczos_steps_match(ops, jmesh, tmesh, mode):
    jb, tb, A = ops
    v0 = np.random.default_rng(10).standard_normal(A.shape[0])
    js = j_init_state(jb.as_linear_operator(use_pallas=False), 30, v0=jnp.asarray(v0))
    js = jd.distributed_lanczos_steps(jb, js, 30, jmesh, matvec_mode=mode)
    top = tb.as_linear_operator()
    ts = td.distributed_lanczos_steps(tb, init_lanczos_state(top, 30, v0=torch.as_tensor(v0)),
                                      30, tmesh, matvec_mode=mode)
    single = lanczos_steps(top, init_lanczos_state(top, 30, v0=torch.as_tensor(v0)), 30)
    assert int(ts.k) == int(js.k) == 30
    for a, b in ((ts.alpha, js.alpha), (ts.beta, js.beta)):
        np.testing.assert_allclose(as_np(a), np.asarray(b), rtol=0, atol=1e-12)
    np.testing.assert_allclose(as_np(ts.alpha), as_np(single.alpha), rtol=0, atol=1e-12)
    np.testing.assert_allclose(as_np(ts.beta), as_np(single.beta), rtol=0, atol=1e-12)
    # the basis stays in per-shard column panels
    assert len(ts.V.pieces) == 8 and ts.V.pieces[0].shape == (31, A.shape[0] // 8)
    np.testing.assert_allclose(as_np(ts.V.gather()), as_np(single.V), atol=1e-11)


def test_distributed_lanczos_in_chunks_with_deflation(ops, tmesh):
    _, tb, A = ops
    top = tb.as_linear_operator()
    v0 = torch.as_tensor(np.random.default_rng(11).standard_normal(A.shape[0]))
    D = torch.as_tensor(np.linalg.qr(np.random.default_rng(12).standard_normal((A.shape[0], 2)))[0].T)
    single = lanczos_steps(top, init_lanczos_state(top, 20, v0=v0, deflate=D), 20, deflate=D)
    state = init_lanczos_state(top, 20, v0=v0, deflate=D)
    for _ in range(3):
        state = td.distributed_lanczos_steps(tb, state, 7, tmesh, matvec_mode="halo", deflate=D)
    assert int(state.k) == 20
    np.testing.assert_allclose(as_np(state.alpha), as_np(single.alpha), atol=1e-12)
    np.testing.assert_allclose(as_np(state.beta), as_np(single.beta), atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_one_placement_serves_many_calls_and_nothing_stays_on_the_container(ops, tmesh, mode):
    """A place_on_mesh placement passed as halo_parts gives the chunks what
    placing per call gives; the caller's container holds no placement."""
    _, tb, A = ops
    top = tb.as_linear_operator()
    v0 = torch.as_tensor(np.random.default_rng(16).standard_normal(A.shape[0]))
    keys = set(vars(tb))
    placed = td.place_on_mesh(tb, tmesh, matvec_mode=mode)
    states = []
    for parts in (placed, None):
        state = init_lanczos_state(top, 20, v0=v0)
        for _ in range(2):
            state = td.distributed_lanczos_steps(tb, state, 10, tmesh, matvec_mode=mode,
                                                 halo_parts=parts)
        states.append(state)
    assert torch.equal(states[0].alpha, states[1].alpha)
    assert torch.equal(states[0].beta, states[1].beta)
    td.mesh_operator(tb, tmesh, matvec_mode=mode).matvec(v0)
    assert set(vars(tb)) == keys
    with pytest.raises(EigenexError, match="not divisible by 5 shards"):
        td.place_on_mesh(tb, make_mesh(devices=["cpu"] * 5), matvec_mode=mode)


def test_distributed_shift_invert_steps_match(ops, jmesh4, tmesh4):
    jb, tb, A = ops
    v0 = np.random.default_rng(13).standard_normal(A.shape[0])
    sigma = float(np.linalg.eigvalsh(A)[0]) - 0.5
    kw = dict(matvec_mode="halo", shift_invert_sigma=sigma, cg_tol=1e-12, cg_max_iters=400)
    js = jd.distributed_lanczos_steps(
        jb, j_init_state(jb.as_linear_operator(use_pallas=False), 12, v0=jnp.asarray(v0)),
        12, jmesh4, **kw)
    ts = td.distributed_lanczos_steps(
        tb, init_lanczos_state(tb.as_linear_operator(), 12, v0=torch.as_tensor(v0)),
        12, tmesh4, **kw)
    np.testing.assert_allclose(as_np(ts.alpha), np.asarray(js.alpha), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(as_np(ts.beta), np.asarray(js.beta), rtol=1e-9, atol=1e-11)


def test_distributed_arnoldi_steps_match(ops, jmesh4, tmesh4):
    from eigenex_tpu.solvers.arnoldi import init_arnoldi_state as j_init_arnoldi
    from eigenex_tpu_torch.solvers.arnoldi import init_arnoldi_state

    data, cols, A = banded_pack(reach=1, symmetric=False, seed=14)
    jb, tb = pair(data, cols, A.shape)
    v0 = np.random.default_rng(15).standard_normal(A.shape[0])
    for mode in ("allgather", "colsplit", "halo"):
        js = jd.distributed_arnoldi_steps(
            jb, j_init_arnoldi(jb.as_linear_operator(use_pallas=False), 16, v0=jnp.asarray(v0)),
            16, jmesh4, matvec_mode=mode)
        ts = td.distributed_arnoldi_steps(
            tb, init_arnoldi_state(tb.as_linear_operator(), 16, v0=torch.as_tensor(v0)),
            16, tmesh4, matvec_mode=mode)
        np.testing.assert_allclose(as_np(ts.H), np.asarray(js.H), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(ts.residue), float(js.residue), rtol=1e-12)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------
def lap_pair(n=100, b=4):
    r = np.arange(n)
    rows = np.concatenate([r, r[:-1], r[1:]])
    cols = np.concatenate([r, r[1:], r[:-1]])
    vals = np.concatenate([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    from eigenex_tpu.sparse.bsr import bsr_from_coo_arrays as jbuild
    from eigenex_tpu_torch.sparse.bsr import bsr_from_coo_arrays as tbuild

    return (jbuild(rows, cols, vals, (n, n), (b, b)),
            tbuild(rows, cols, vals, (n, n), (b, b), device="cpu"),
            2 - 2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))


@pytest.mark.parametrize("mode", ["allgather", "halo", "sym_halo"])
def test_distributed_lanczos_solver_matches(jmesh4, tmesh4, mode):
    jb, tb, exact = lap_pair(64)  # 16 block rows over 8 shards, no padding
    kw = dict(max_eigenvalues=3, tolerance=1e-12, max_subspace=64)
    jr = jd.DistributedLanczosEigenSolver(jb, jmesh4, JLanczosOptions(**kw), matvec_mode=mode).compute()
    tr = td.DistributedLanczosEigenSolver(tb, tmesh4, LanczosOptions(**kw), matvec_mode=mode).compute()
    np.testing.assert_allclose(tr.eigenvalues, np.asarray(jr.eigenvalues), atol=1e-10)
    np.testing.assert_allclose(tr.eigenvalues, exact[:3], atol=1e-10)
    assert tr.eigenvectors.shape == (64, 3)


@pytest.mark.parametrize("mode", ["allgather", "colsplit", "halo", "sym_halo"])
def test_distributed_thick_restart_with_padding(jmesh4, tmesh4, mode):
    jb, tb, exact = lap_pair(100)  # 25 block rows: the mesh pads 7
    kw = dict(max_eigenvalues=2, tolerance=1e-10, max_subspace=24, max_restarts=200)
    jr = jd.DistributedThickRestartLanczosEigenSolver(jb, jmesh4, JTROptions(**kw), matvec_mode=mode).compute()
    tr = td.DistributedThickRestartLanczosEigenSolver(tb, tmesh4, ThickRestartOptions(**kw), matvec_mode=mode).compute()
    np.testing.assert_allclose(tr.eigenvalues, np.asarray(jr.eigenvalues), atol=1e-10)
    np.testing.assert_allclose(tr.eigenvalues, exact[:2], atol=1e-10)
    assert tr.eigenvectors.shape == (100, 2)
    A = np.diag(2 * np.ones(100)) - np.diag(np.ones(99), 1) - np.diag(np.ones(99), -1)
    V = as_np(tr.eigenvectors)
    assert np.abs(A @ V - V * tr.eigenvalues).max() < 1e-7


def test_distributed_shift_invert_solver(jmesh4, tmesh4):
    jb, tb, exact = lap_pair(32)
    kw = dict(max_eigenvalues=2, eigenvalue_indices=(-2, -1), tolerance=1e-12, max_subspace=12)
    jr = jd.DistributedShiftInvertLanczosEigenSolver(
        jb, jmesh4, JLanczosOptions(**kw), matvec_mode="halo", sigma=-1e-3, cg_tol=1e-12).compute()
    tr = td.DistributedShiftInvertLanczosEigenSolver(
        tb, tmesh4, LanczosOptions(**kw), matvec_mode="halo", sigma=-1e-3, cg_tol=1e-12).compute()
    np.testing.assert_allclose(np.sort(tr.eigenvalues), np.sort(np.asarray(jr.eigenvalues)), rtol=1e-9)
    np.testing.assert_allclose(np.sort(tr.eigenvalues), exact[:2], rtol=1e-9)


def test_distributed_krylov_schur(jmesh4, tmesh4):
    data, cols, A = banded_pack(nbr=16, reach=1, symmetric=False, seed=16, holes=False)
    jb, tb = pair(data, cols, A.shape)
    kw = dict(max_eigenvalues=3, tolerance=1e-12, max_subspace=30, max_restarts=200)
    jr = jd.DistributedKrylovSchurArnoldiSolver(jb, jmesh4, JKSOptions(**kw), matvec_mode="colsplit").compute()
    tr = td.DistributedKrylovSchurArnoldiSolver(tb, tmesh4, KrylovSchurOptions(**kw), matvec_mode="colsplit").compute()
    ev = np.linalg.eigvals(A)
    top = ev[np.argsort(-np.abs(ev))][:3]
    got = np.asarray(tr.eigenvalues)
    assert np.abs(np.sort_complex(np.abs(got) + 0j) - np.sort_complex(np.abs(np.asarray(jr.eigenvalues)) + 0j)).max() < 1e-10
    assert np.abs(np.sort(np.abs(got)) - np.sort(np.abs(top))).max() < 1e-10


@pytest.mark.parametrize("mode", ["allgather", "sym_halo"])
def test_distributed_lobpcg(jmesh4, tmesh4, mode):
    from eigenex_tpu.solvers.lobpcg import LOBPCGOptions as JOpt
    from eigenex_tpu_torch.solvers.lobpcg import LOBPCGOptions

    jb, tb, exact = lap_pair(100)
    kw = dict(max_iterations=400, tolerance=1e-9)
    jr = jd.DistributedLOBPCGSolver(jb, jmesh4, JOpt(**kw), block_size=3, matvec_mode=mode).compute()
    tr = td.DistributedLOBPCGSolver(tb, tmesh4, LOBPCGOptions(**kw), block_size=3, matvec_mode=mode).compute()
    np.testing.assert_allclose(np.sort(tr.eigenvalues), np.sort(np.asarray(jr.eigenvalues)), atol=1e-8)
    np.testing.assert_allclose(np.sort(tr.eigenvalues), exact[:3], atol=1e-8)
    assert tr.eigenvectors.shape == (100, 3)


# ---------------------------------------------------------------------------
# initialize_multihost: the reference's argument contract
# ---------------------------------------------------------------------------
def test_initialize_multihost_partial_args_rejected():
    with pytest.raises(ValueError, match="together"):
        initialize_multihost(coordinator_address="10.0.0.1:1234")
    with pytest.raises(ValueError, match="together"):
        initialize_multihost(num_processes=4, process_id=0)


def test_initialize_multihost_process_id_range_checked():
    with pytest.raises(ValueError, match="outside"):
        initialize_multihost("10.0.0.1:1234", num_processes=4, process_id=4)
    with pytest.raises(ValueError, match="positive"):
        initialize_multihost("10.0.0.1:1234", num_processes=0, process_id=0)


def test_initialize_multihost_forwards_exact_kwargs(monkeypatch):
    """The process group is gloo whatever the machine (the mesh picks NCCL
    for its exchanges only where no card is shared), with the collective
    timeout; ``make_global_mesh=True`` goes on to build the mesh of the
    given devices (a one-process mesh here: no group is really up)."""
    import datetime

    import torch.distributed as dist
    from eigenex_tpu_torch.parallel import mesh as mesh_mod

    seen = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.append(kw))
    monkeypatch.setitem(mesh_mod._GROUP, "initialized", False)
    assert initialize_multihost("10.0.0.1:1234", num_processes=4, process_id=2) is None
    assert seen[-1] == {"backend": "gloo", "timeout": datetime.timedelta(seconds=600),
                        "init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2}
    mesh = initialize_multihost("10.0.0.1:1234", num_processes=4, process_id=2,
                                make_global_mesh=True, devices=["cpu"] * 3, timeout=5)
    assert seen[-1]["timeout"] == datetime.timedelta(seconds=5)
    assert isinstance(mesh, Mesh) and mesh.size == 3 and not mesh.multiprocess


def test_initialize_multihost_auto_detect_and_repeat(monkeypatch):
    import datetime

    import torch.distributed as dist
    from eigenex_tpu_torch.parallel import mesh as mesh_mod

    seen = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.append(kw))
    monkeypatch.setitem(mesh_mod._GROUP, "initialized", False)
    initialize_multihost()
    assert seen == [{"backend": "gloo", "timeout": datetime.timedelta(seconds=600)}]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already initialized"):
        initialize_multihost()


def test_make_mesh_never_takes_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh()
    assert [str(d) for d in mesh.flat_devices] == ["cuda:0", "cuda:1"]
    assert make_mesh(4, devices=["cuda:0"] * 4).shape == {"rows": 4}
    with pytest.raises(ValueError, match="need 5 devices"):
        make_mesh(5, devices=["cpu"] * 4)
