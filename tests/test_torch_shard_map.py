"""``shard_map`` and the mesh collectives of the port against ``jax.shard_map``
with ``lax.psum`` / ``all_gather`` / ``psum_scatter`` / ``ppermute``, over 1-D
and 2-D meshes of CPU devices (the JAX side on its 8 virtual CPU devices),
on numpy-seeded inputs; plus what the port adds: a failing or hung shard
raises in the caller within the timeout, reruns are bit-equal, and the
kernel launch counters count from every shard thread.
"""

import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax import shard_map as jshard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.parallel import Mesh, make_mesh
from eigenex_tpu_torch.parallel.shard_map import P, Sharded, shard_map, split_tensor
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)

SHAPES = {"1d": ((8,), ("rows",)), "2d": ((2, 4), ("rows", "cols"))}


def meshes(kind):
    shape, names = SHAPES[kind]
    jm = JMesh(np.array(jax.devices("cpu")[:8]).reshape(shape), names)
    tm = Mesh(np.array(["cpu"] * 8).reshape(shape), names)
    return jm, tm


def run_both(kind, jbody, tbody, in_spec, out_spec, x):
    jm, tm = meshes(kind)
    jf = jshard_map(jbody, mesh=jm, in_specs=(JP(*in_spec),), out_specs=JP(*out_spec),
                    check_vma=False)
    tf = shard_map(tbody, tm, in_specs=(P(*in_spec),), out_specs=P(*out_spec), check=True)
    return np.asarray(jf(jnp.asarray(x))), tf(torch.as_tensor(x)).numpy()


ROWS_COLS = ("rows", "cols")
CASES = [
    # (mesh, input spec, collective axes, output spec of psum / all_gather)
    ("1d", ("rows",), "rows", ()),
    ("2d", (ROWS_COLS,), "cols", ("rows",)),
    ("2d", (ROWS_COLS,), "rows", ("cols",)),
    ("2d", (ROWS_COLS,), ROWS_COLS, ()),
    ("2d", (("cols", "rows"),), "rows", ("cols",)),
]


@pytest.mark.parametrize("kind,spec,axes,rep", CASES)
def test_psum_and_all_gather(kind, spec, axes, rep):
    x = np.random.default_rng(0).standard_normal(48)
    j, t = run_both(kind, lambda v: lax.psum(v, axes), lambda c, v: c.psum(v, axes), spec,
                    rep, x)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-14)
    j, t = run_both(kind, lambda v: lax.all_gather(v, axes, tiled=True),
                    lambda c, v: c.all_gather(v, axes, tiled=True), spec, rep, x)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kind,spec,axes,rep", CASES)
def test_psum_scatter(kind, spec, axes, rep):
    x = np.random.default_rng(1).standard_normal(64)
    out = tuple(spec)  # each shard keeps a slice of the reduced piece
    j, t = run_both(kind, lambda v: lax.psum_scatter(v, axes, scatter_dimension=0, tiled=True),
                    lambda c, v: c.psum_scatter(v, axes, scatter_dimension=0, tiled=True),
                    spec, out, x)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-14)


@pytest.mark.parametrize("kind,axis,perm", [
    ("1d", "rows", [(i, (i + 1) % 8) for i in range(8)]),
    ("1d", "rows", [(i, (i - 1) % 8) for i in range(8)]),
    ("1d", "rows", [(0, 3), (3, 5)]),  # shards nobody sends to get zeros
    ("2d", "cols", [(i, (i + 1) % 4) for i in range(4)]),
    ("2d", "rows", [(0, 1), (1, 0)]),
])
def test_ppermute(kind, axis, perm):
    x = np.random.default_rng(2).standard_normal(32)
    spec = ("rows",) if kind == "1d" else (ROWS_COLS,)
    j, t = run_both(kind, lambda v: lax.ppermute(v, axis, perm),
                    lambda c, v: c.ppermute(v, axis, perm), spec, spec, x)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_shards_on_distinct_devices_get_the_same_results(kind):
    """A mesh whose shards name different devices: the last shard to arrive
    computes every result on its device and moves each to its shard's
    device ("cpu" and "cpu:0" are two device names of one memory), and the
    collectives give what they give on a mesh of one device name."""
    shape, names = SHAPES[kind]
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(64))
    axis = names[-1]
    ring = [(i, (i + 1) % shape[-1]) for i in range(shape[-1])]

    def body(c, v):
        return (c.psum(v, axis), c.all_gather(v, axis), c.psum_scatter(v, axis),
                c.ppermute(v, axis, ring))

    spec = P(names if kind == "2d" else names[0])
    outs = []
    for devices in (["cpu"] * 8, ["cpu", "cpu:0"] * 4):
        mesh = Mesh(np.array(devices, dtype=object).reshape(shape), names)
        outs.append(shard_map(body, mesh, in_specs=(spec,), out_specs=(spec,) * 4, check=True)(x))
    for shared, own in zip(*outs):
        assert torch.equal(shared, own)


def test_axis_index_and_2d_blocks():
    jm, tm = meshes("2d")
    x = np.arange(16.0).reshape(8, 2)
    jf = jshard_map(lambda v: v * (1 + lax.axis_index("rows")) + lax.axis_index("cols"),
                    mesh=jm, in_specs=(JP(("cols", "rows"), None),),
                    out_specs=JP(("cols", "rows"), None))
    tf = shard_map(lambda c, v: v * (1 + c.axis_index("rows")) + c.axis_index("cols"), tm,
                   in_specs=(P(("cols", "rows"), None),), out_specs=P(("cols", "rows"), None))
    np.testing.assert_array_equal(tf(torch.as_tensor(x)).numpy(), np.asarray(jf(jnp.asarray(x))))


def test_reductions_are_bit_reproducible_and_in_shard_order():
    mesh = make_mesh(devices=["cpu"] * 8)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(8 * 1000).astype(np.float32))
    f = shard_map(lambda c, v: c.psum(v, "rows"), mesh, in_specs=(P("rows"),), out_specs=P(),
                  check=True)
    a, b = f(x), f(x)
    assert torch.equal(a, b)
    pieces = x.reshape(8, 1000)
    acc = pieces[0].clone()
    for s in range(1, 8):
        acc += pieces[s]
    assert torch.equal(a, acc)


def test_replicated_outputs_are_checked():
    mesh = make_mesh(devices=["cpu"] * 4)
    f = shard_map(lambda c, v: v + c.axis_index("rows"), mesh, in_specs=(P(),), out_specs=P(),
                  check=True)
    with pytest.raises(EigenexError, match="differs on shard 1"):
        f(torch.zeros(3))


def test_sharded_arguments_pass_through_and_stay_split():
    mesh = make_mesh(devices=["cpu"] * 4)
    V = torch.arange(24.0).reshape(3, 8)
    S = split_tensor(V, P(None, "rows"), mesh, place=True)
    assert all(p.is_contiguous() and p.shape == (3, 2) for p in S.pieces)

    def body(c, v):
        v[0] += 100.0  # in place on this shard's panel
        return v

    out = shard_map(body, mesh, in_specs=(P(None, "rows"),), out_specs=P(None, "rows"),
                    gather=False)(S)
    assert isinstance(out, Sharded) and out.pieces[2] is S.pieces[2]
    assert torch.equal(out.gather()[0], V[0] + 100.0) and torch.equal(V[0], torch.arange(8.0))
    row = out[1]
    assert row.shape == (8,) and torch.equal(row.gather(), V[1])
    cols = out.combine(lambda p: p.T, dim=0)
    assert torch.equal(cols, out.gather().T)


def test_idle_shard_workers_hold_nothing_of_their_last_task():
    """Once ``shard_map`` returns, no shard thread keeps its operands (or its
    collectives' terms) alive: the caller's last reference frees them."""
    mesh = make_mesh(devices=["cpu"] * 4)
    x = torch.arange(16, dtype=torch.float64)
    freed = weakref.ref(x)
    out = shard_map(lambda c, v: c.psum(v, "rows") * 2, mesh, (P("rows"),), P("rows"))(x)
    del x
    assert freed() is None
    assert out.shape == (16,)


def test_an_error_in_one_shard_raises_in_the_caller():
    mesh = make_mesh(devices=["cpu"] * 8)

    def body(c, v):
        if c.axis_index("rows") == 5:
            raise ValueError("shard 5 failed")
        return c.psum(v, "rows")

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="shard 5 failed"):
        shard_map(body, mesh, in_specs=(P("rows"),), out_specs=P(), timeout=30)(torch.ones(8))
    assert time.monotonic() - t0 < 10
    # the pool is usable afterwards
    out = shard_map(lambda c, v: c.psum(v, "rows"), mesh, in_specs=(P("rows"),),
                    out_specs=P())(torch.ones(8))
    assert float(out) == 8.0


def test_a_hung_shard_times_out_instead_of_hanging():
    mesh = make_mesh(devices=["cpu"] * 4)
    release = threading.Event()

    def body(c, v):
        if c.axis_index("rows") == 2:
            release.wait(20)  # never reaches the collective in time
        return c.psum(v, "rows")

    t0 = time.monotonic()
    with pytest.raises(EigenexError, match="waited more than"):
        shard_map(body, mesh, in_specs=(P("rows"),), out_specs=P(), timeout=0.5)(torch.ones(4))
    assert time.monotonic() - t0 < 10
    release.set()


def test_shard_map_inside_a_body_is_refused():
    mesh = make_mesh(devices=["cpu"] * 2)
    inner = shard_map(lambda c, v: v, mesh, in_specs=(P(),), out_specs=P())
    with pytest.raises(EigenexError, match="inside a shard body"):
        shard_map(lambda c, v: inner(v), mesh, in_specs=(P(),), out_specs=P())(torch.ones(2))


def test_launch_counters_count_from_every_thread():
    """The kernel launch counters are bumped from the shard threads of a
    mesh: 8 threads x 2000 bumps each must all land."""
    mesh = make_mesh(devices=["cpu"] * 8)
    cuda_spmv.reset_launch_counts()

    def body(c, v):
        for _ in range(2000):
            cuda_spmv._count_launch("bsr_spmv")
            cuda_spmv._count_launch("sym_bsr_spmv")
        return v

    shard_map(body, mesh, in_specs=(P("rows"),), out_specs=P("rows"))(torch.ones(8))
    counts = cuda_spmv.launch_counts()
    assert counts["bsr_spmv"] == counts["sym_bsr_spmv"] == 16000
    cuda_spmv.reset_launch_counts()
    assert not any(cuda_spmv.launch_counts().values())


def test_plain_route_calls_counted_from_8_shard_threads(monkeypatch):
    """The counters under a mesh product: the plain versions, made to count
    as the kernels' wrappers do, called from 8 shard threads at once through
    the halo mode (three products a shard a matvec) -- every call lands."""
    from eigenex_tpu_torch.parallel import mesh_operator
    from eigenex_tpu_torch.sparse.bsr import bsr_from_dense

    plain = cuda_spmv.bsr_spmv_plain

    def counting(*args):
        cuda_spmv._count_launch("bsr_spmv")
        return plain(*args)

    monkeypatch.setattr(cuda_spmv, "bsr_spmv_plain", counting)
    A = np.diag(np.arange(1.0, 65.0)) + np.diag(np.ones(63), 1) + np.diag(np.ones(63), -1)
    op = mesh_operator(bsr_from_dense(A, (4, 4), device="cpu"),
                       make_mesh(devices=["cpu"] * 8), matvec_mode="halo")
    x = torch.ones(64, dtype=torch.float64)
    cuda_spmv.reset_launch_counts()
    for _ in range(50):
        y = op.matvec(x)
    assert cuda_spmv.launch_counts()["bsr_spmv"] == 50 * 8 * 3
    np.testing.assert_allclose(y.numpy(), A @ np.ones(64), atol=1e-12)
    cuda_spmv.reset_launch_counts()


def test_plain_routes_count_nothing_from_shard_threads():
    """On the CPU the mesh products take the plain versions, which launch
    (and count) nothing, whichever thread calls them."""
    from eigenex_tpu_torch.parallel import mesh_operator
    from eigenex_tpu_torch.sparse.bsr import bsr_from_dense

    A = np.diag(np.arange(1.0, 33.0)) + np.diag(np.ones(31), 1) + np.diag(np.ones(31), -1)
    op = mesh_operator(bsr_from_dense(A.astype(np.float32), (4, 4), device="cpu"),
                       make_mesh(devices=["cpu"] * 8), matvec_mode="halo")
    cuda_spmv.reset_launch_counts()
    y = op.matvec(torch.ones(32))
    np.testing.assert_allclose(y.numpy(), A @ np.ones(32), rtol=1e-6)
    assert not any(cuda_spmv.launch_counts().values())


def test_spec_and_mesh_validation():
    mesh = make_mesh(devices=["cpu"] * 4)
    with pytest.raises(EigenexError, match="unknown mesh axis"):
        shard_map(lambda c, v: v, mesh, in_specs=(P("cols"),), out_specs=P("rows"))(torch.ones(4))
    with pytest.raises(EigenexError, match="does not split"):
        shard_map(lambda c, v: v, mesh, in_specs=(P("rows"),), out_specs=P("rows"))(torch.ones(6))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("rows",))
    assert Mesh(["cpu"] * 4, ("rows",)) == make_mesh(devices=["cpu"] * 4)
