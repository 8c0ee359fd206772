"""Checkpoints of solver state across the two packages, f64 on the CPU:
``save_state`` of either package loads in the other field for field (the
step count as the reference's int32 on disk, the port's int64 in memory),
a solve resumed by the port from the reference's mid-run checkpoint ends at
the reference's uninterrupted eigenvalues (1e-10), and the reverse.  Also:
the reference's tolerance of a checkpoint without the ``failed`` flag, and
the distributed layout of ``load_state(mesh=)`` / ``shard_state`` (the
basis in per-shard column panels, as the reference shards it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.utils.checkpoint as jck
from eigenex_tpu.core.operators import aslinearoperator as j_aslinearoperator
from eigenex_tpu.solvers.arnoldi import arnoldi_steps as j_arnoldi_steps
from eigenex_tpu.solvers.arnoldi import init_arnoldi_state as j_init_arnoldi
from eigenex_tpu.solvers.lanczos import LanczosEigenSolver as JLanczos
from eigenex_tpu.solvers.lanczos import LanczosOptions as JOptions
from eigenex_tpu.solvers.lanczos import init_lanczos_state as j_init_lanczos
from eigenex_tpu.solvers.lanczos import lanczos_steps as j_lanczos_steps
import eigenex_tpu_torch as ext
import eigenex_tpu_torch.utils.checkpoint as tck
from eigenex_tpu_torch.convert import state_from_numpy
from eigenex_tpu_torch.solvers.arnoldi import ArnoldiState, arnoldi_steps, init_arnoldi_state
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)

N = 60


def hermitian(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, N))
    return (a + a.T) / 2


def same_state(port_state, ref_state):
    """Every field equal, dtypes as written to disk (``k`` as int32)."""
    for name, value in tck.state_to_dict(port_state).items():
        want = np.asarray(getattr(ref_state, name))
        assert value.dtype == want.dtype, name
        assert np.array_equal(value, want), name


def test_state_to_dict_writes_the_reference_dtypes():
    op = ext.aslinearoperator(torch.as_tensor(hermitian()))
    s = ext.lanczos_steps(op, ext.init_lanczos_state(op, 10, seed=0), 5)
    assert s.k.dtype == torch.int64
    d = tck.state_to_dict(s)
    assert d["k"].dtype == np.int32 and int(d["k"]) == 5
    assert d["breakdown"].dtype == np.bool_ and d["V"].shape == (11, N)
    with pytest.raises(EigenexError, match="not a solver state"):
        tck.state_to_dict(np.zeros(3))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    A = hermitian(1)
    opts = dict(max_eigenvalues=2, tolerance=1e-14, max_subspace=N, seed=3)
    straight = JLanczos(jnp.asarray(A), JOptions(**opts)).compute()
    jop = j_aslinearoperator(jnp.asarray(A))
    half = j_lanczos_steps(jop, j_init_lanczos(jop, N, seed=3), 10)
    p = str(tmp_path / "mid.npz")
    jck.save_state(p, half)

    state = tck.load_state(p, device="cpu")
    assert isinstance(state, ext.LanczosState) and state.k.dtype == torch.int64
    assert int(state.k) == 10 and state.V.device.type == "cpu"
    same_state(state, half)
    solver = ext.LanczosEigenSolver(torch.as_tensor(A), ext.LanczosOptions(**opts))
    solver.state = state
    resumed = solver.continue_to_compute()
    assert resumed.converged
    np.testing.assert_allclose(resumed.eigenvalues, straight.eigenvalues, rtol=0, atol=1e-10)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    A = hermitian(2)
    opts = dict(max_eigenvalues=2, tolerance=1e-14, max_subspace=N, seed=3)
    straight = ext.LanczosEigenSolver(torch.as_tensor(A), ext.LanczosOptions(**opts)).compute()
    op = ext.aslinearoperator(torch.as_tensor(A))
    half = ext.lanczos_steps(op, ext.init_lanczos_state(op, N, seed=3), 12)
    p = str(tmp_path / "mid.npz")
    ext.save_state(p, half)

    state = jck.load_state(p)
    assert state.k.dtype == jnp.int32 and int(state.k) == 12
    same_state(half, state)
    solver = JLanczos(jnp.asarray(A), JOptions(**opts))
    solver.state = state
    resumed = solver.continue_to_compute()
    np.testing.assert_allclose(resumed.eigenvalues, straight.eigenvalues, rtol=0, atol=1e-10)
    # and the port reads its own file back field for field
    again = ext.load_state(p, device="cpu")
    for name in ("V", "alpha", "beta", "k", "breakdown", "failed"):
        assert torch.equal(getattr(again, name), getattr(half, name)), name


def test_arnoldi_state_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((16, 16))
    jop = j_aslinearoperator(jnp.asarray(A))
    js = j_arnoldi_steps(jop, j_init_arnoldi(jop, 8, seed=0), 4)
    p = str(tmp_path / "a.npz")
    jck.save_state(p, js)
    ts = ext.load_state(p, device="cpu")
    assert isinstance(ts, ArnoldiState) and int(ts.k) == 4
    for name in ("V", "H", "residue", "breakdown", "failed"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    op = ext.aslinearoperator(torch.as_tensor(A))
    ps = arnoldi_steps(op, init_arnoldi_state(op, 8, seed=0), 4)
    q = str(tmp_path / "b.npz")
    tck.save_state(q, ps)
    back = jck.load_state(q)
    assert type(back).__name__ == "ArnoldiState" and int(back.k) == 4
    np.testing.assert_array_equal(np.asarray(back.H), ps.H.numpy())


def test_missing_failed_flag_and_bad_files(tmp_path):
    op = ext.aslinearoperator(torch.as_tensor(hermitian(5)))
    s = ext.lanczos_steps(op, ext.init_lanczos_state(op, 10, seed=0), 3)
    d = tck.state_to_dict(s)
    del d["failed"]
    old = tck.state_from_dict(ext.LanczosState, d, device="cpu")
    assert old.failed.dtype == torch.bool and not bool(old.failed)
    via_convert = state_from_numpy("LanczosState", d, device="cpu")
    assert torch.equal(via_convert.V, old.V) and via_convert.k.dtype == torch.int64
    del d["alpha"]
    with pytest.raises(EigenexError, match="missing fields"):
        tck.state_from_dict(ext.LanczosState, d, device="cpu")
    p = str(tmp_path / "odd.npz")
    np.savez(p, __class__=np.array("QRState"), V=np.zeros(3))
    with pytest.raises(EigenexError, match="unknown state class"):
        tck.load_state(p, device="cpu")


def test_distributed_layout_is_not_ported(tmp_path):
    """The distributed layout is ported: ``load_state(mesh=)`` and
    ``shard_state`` split the basis by columns into one panel a shard, the
    shapes and values of the reference's ``P(None, rows)`` shards, the rest
    whole; the reference's rejection of a width the mesh does not divide."""
    import jax
    from jax.sharding import Mesh as JMesh

    op = ext.aslinearoperator(torch.as_tensor(hermitian()))
    s = ext.lanczos_steps(op, ext.init_lanczos_state(op, 6, seed=0), 2)
    odd = next(d for d in (3, 5, 7, 11, 13) if N % d)
    p = str(tmp_path / "s.npz")
    tck.save_state(p, s)
    jm = JMesh(np.array(jax.devices("cpu")[:4]), ("rows",))
    ref = jck.load_state(p, mesh=jm)
    got = tck.load_state(p, mesh=ext.make_mesh(devices=["cpu"] * 4))
    assert [tuple(x.shape) for x in got.V.pieces] == [
        tuple(sh.data.shape) for sh in ref.V.addressable_shards]
    for piece, sh in zip(got.V.pieces, ref.V.addressable_shards):
        np.testing.assert_array_equal(piece.numpy(), np.asarray(sh.data))
    placed = ext.shard_state(s, ext.make_mesh(devices=["cpu"] * 4))
    assert torch.equal(placed.V.gather(), s.V) and torch.equal(placed.alpha, s.alpha)
    with pytest.raises(Exception) as jerr:
        jck.shard_state(jck.load_state(p), JMesh(np.array(jax.devices("cpu")[:odd]), ("rows",)))
    with pytest.raises(EigenexError) as terr:
        ext.shard_state(s, ext.make_mesh(devices=["cpu"] * odd))
    assert str(terr.value) == str(jerr.value)
