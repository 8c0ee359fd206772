"""The port's mesh across processes on the CPU (gloo), against the JAX package.

The reference's two multi-process scenarios (``tests/test_multiprocess.py``)
at its sizes, each run by worker processes of the port
(:mod:`eigenex_tpu_torch.parallel.multiproc`) joined through a free
localhost port, with a timeout on every spawn:

- 2 processes x 2 CPU shards: allgather Lanczos steps on the n = 64
  Laplacian;
- 4 processes x 1 shard: the sym_halo thick-restart Lanczos driver on the
  n = 256 banded operator (bw 24), so every halo hop crosses a process;

and beyond them every matvec mode's exchange and every ``mesh=`` front end
with the process boundary inside the mesh.

Replicated results are held bit-equal across processes and to the port's
one-process mesh of the same shard count (the last local shard of each
process combines all terms in global shard order), and to the JAX
package's one-process 4-device run at the reference's cross-topology
tolerance (``rtol=1e-14``; the eigenvalues to ``1e-9 max|ev|`` of the dense
oracle and to 1e-10 of the JAX driver).  Also the contract: a global mesh
from ``initialize_multihost``, the backend rule, and a failing or stalled
process making every process raise.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from eigenex_tpu_torch.parallel import make_mesh
from eigenex_tpu_torch.parallel import mesh as tmesh
from eigenex_tpu_torch.parallel.multiproc import (WorkerFailure, banded_sym_triplets, spawn,
                                                   scenario_steps, scenario_trlm)

from _torch_multiproc_worker import scenario_routes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_multiproc_worker.py"  # routes, fail
LAPLACIAN = dict(kind="laplacian", n=64, block=4)
BANDED = dict(kind="banded_sym", n=256, bw=24, block=4)
SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def steps_2x2():
    return spawn("steps", 2, ["cpu", "cpu"], dict(operator=LAPLACIAN), timeout=SPAWN_TIMEOUT,
                 threads=1)


@pytest.fixture(scope="module")
def trlm_4x1():
    return spawn("trlm", 4, ["cpu"], dict(operator=BANDED), timeout=SPAWN_TIMEOUT, threads=1)


def test_initialize_multihost_returns_a_global_mesh(steps_2x2):
    """``initialize_multihost(make_global_mesh=True)`` across two processes:
    a 4-shard mesh, two shards each, on gloo."""
    for rank, res in enumerate(steps_2x2):
        assert res["process_index"] == rank and res["process_count"] == 2
        assert res["n_global_shards"] == 4 and res["n_local_shards"] == 2
        assert res["backend"] == "gloo"


def test_multiprocess_lanczos_bitwise_matches_single_process(steps_2x2):
    a0, b0 = steps_2x2[0]["alpha"], steps_2x2[0]["beta"]
    assert steps_2x2[0]["k"] == 12
    for res in steps_2x2[1:]:
        assert res["alpha"] == a0 and res["beta"] == b0  # bit for bit across processes
    one = scenario_steps(make_mesh(devices=["cpu"] * 4), LAPLACIAN)
    assert one["alpha"] == a0 and one["beta"] == b0  # and with one process of 4 shards

    from eigenex_tpu.parallel.distributed import distributed_lanczos_steps, pad_bsr_for_mesh
    from eigenex_tpu.solvers.lanczos import init_lanczos_state
    from eigenex_tpu.sparse.bsr import bsr_from_coo_arrays

    n = 64
    r = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    c = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    v = np.concatenate([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    bsr = pad_bsr_for_mesh(bsr_from_coo_arrays(r, c, v, (n, n), (4, 4)), 4)
    op = bsr.as_linear_operator(use_pallas=False)
    v0 = np.random.default_rng(2).standard_normal(bsr.shape[1])
    s_ref = distributed_lanczos_steps(bsr, init_lanczos_state(op, 20, v0=v0), 12,
                                      JMesh(np.array(jax.devices("cpu")[:4]), ("rows",)))
    np.testing.assert_allclose(np.array(a0)[:12], np.asarray(s_ref.alpha)[:12], rtol=1e-14)
    np.testing.assert_allclose(np.array(b0)[:13], np.asarray(s_ref.beta)[:13], rtol=1e-14)


def test_multiprocess_sym_halo_trlm_nproc4(trlm_4x1):
    lam0 = trlm_4x1[0]["eigenvalues"]
    for res in trlm_4x1:
        assert res["converged"] and res["n_local_shards"] == 1 and res["n_global_shards"] == 4
        assert res["eigenvalues"] == lam0  # bit for bit across processes
    one = scenario_trlm(make_mesh(devices=["cpu"] * 4), BANDED)
    assert one["eigenvalues"] == lam0 and one["k"] == trlm_4x1[0]["k"]

    import scipy.sparse as sp

    r, c, v = banded_sym_triplets(256, 24)
    ev = np.sort(np.linalg.eigvalsh(sp.coo_matrix((v, (r, c)), shape=(256, 256)).toarray()))
    np.testing.assert_allclose(lam0, ev[:4], rtol=0, atol=1e-9 * np.abs(ev).max())

    from eigenex_tpu.parallel.distributed import (DistributedThickRestartLanczosEigenSolver,
                                                  pad_bsr_for_mesh)
    from eigenex_tpu.solvers.restart import ThickRestartOptions
    from eigenex_tpu.sparse.bsr import bsr_from_coo_arrays
    from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr

    sym = sym_bsr_from_bsr(pad_bsr_for_mesh(bsr_from_coo_arrays(r, c, v, (256, 256), (4, 4)), 4))
    jres = DistributedThickRestartLanczosEigenSolver(
        sym, JMesh(np.array(jax.devices("cpu")[:4]), ("rows",)),
        ThickRestartOptions(max_eigenvalues=4, eigenvalue_indices=(0, 1, 2, 3), tolerance=1e-10,
                            max_subspace=24, max_restarts=60, seed=0),
        axis_name="rows", matvec_mode="sym_halo").compute()
    np.testing.assert_allclose(lam0, np.asarray(jres.eigenvalues), rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["colsplit", "halo", "sym_halo"])
def test_every_matvec_mode_across_processes(mode):
    """The column-split reduce-scatter, the halo ring and the sym_halo ring
    (forward x halo, reverse partial-y halo) with hops across the process
    boundary: bit-equal across processes and to one process of 4 shards."""
    got = spawn("steps", 2, ["cpu", "cpu"], dict(operator=BANDED, matvec_mode=mode),
                timeout=SPAWN_TIMEOUT, threads=1)
    one = scenario_steps(make_mesh(devices=["cpu"] * 4), BANDED, matvec_mode=mode)
    for res in got:
        assert res["alpha"] == one["alpha"] and res["beta"] == one["beta"] and res["k"] == 12


def test_every_mesh_route_across_processes():
    """``eigsh`` (halo; an accelerated pack), ``eigs`` (allgather and the 2-D
    panel grid), ``svds``, ``eigsh_window``, ``eigsh_range``, the KPM moments,
    ``shard_state`` and ``load_state(mesh=)`` on a global mesh of 2 processes
    x 2 shards: bit-equal across processes and to one process of 4 shards
    (``tests/test_torch_mesh_routes.py`` holds that mesh to the JAX
    package's), and the eigenvalues to the dense oracle."""
    got = spawn("routes", 2, ["cpu", "cpu"], {}, timeout=SPAWN_TIMEOUT, threads=1, worker=WORKER)
    one = scenario_routes(make_mesh(devices=["cpu"] * 4))
    for key, value in one.items():
        for res in got:
            assert res[key] == value, key
    exact = np.array(one["exact"])
    for key, count in (("eigsh_halo", 3), ("eigsh_accelerated", 2), ("eigsh_window", 4),
                       ("eigsh_range", 5)):
        np.testing.assert_allclose(one[key], exact[:count], rtol=0, atol=1e-9)
    assert one["shard_state_alpha"] == one["load_state_alpha"]


@pytest.mark.parametrize("devices,processes,cards,want", [
    (["cuda:0", "cuda:0"], [0, 1], ["GPU-a", "GPU-a"], "gloo"),  # one card, two processes
    (["cuda:0"] * 4, [0, 0, 1, 1], ["GPU-a"] * 4, "gloo"),
    (["cuda:0", "cuda:0"], [0, 1], ["GPU-a", "GPU-b"], "nccl"),  # a card each (two hosts)
    (["cuda:0", "cuda:1"], [0, 1], ["GPU-a", "GPU-b"], "nccl"),
    (["cuda:0", "cuda:0", "cuda:1"], [0, 0, 1], ["GPU-a", "GPU-a", "GPU-b"], "nccl"),
    (["cpu", "cpu"], [0, 1], [None, None], "gloo"),
    (["cpu", "cuda:0"], [0, 1], [None, "GPU-a"], "gloo"),
])
def test_backend_rule(devices, processes, cards, want):
    """NCCL only where every card serves one process; gloo on the CPU and
    for shards of one card shared by processes (NCCL refuses two ranks on
    one GPU)."""
    assert tmesh.backend_for(devices, processes, cards) == want


def test_failing_process_makes_every_process_raise():
    with pytest.raises(WorkerFailure, match="deliberate failure on process 1") as err:
        spawn("fail", 2, ["cpu", "cpu"], dict(fail_rank=1), timeout=SPAWN_TIMEOUT, threads=1,
              collective_timeout=30.0, worker=WORKER)
    assert all(code != 0 for code in err.value.returncodes)
    assert err.value.seconds < 60.0


def test_stalled_process_times_out_everywhere():
    """A process that stops taking part (here: sleeps past the collective
    timeout) makes the others raise at the timeout, and itself raises at its
    next collective: nothing hangs."""
    with pytest.raises(WorkerFailure, match="Timed out|timed out|Connection") as err:
        spawn("fail", 2, ["cpu", "cpu"], dict(fail_rank=1, stall=3.0), timeout=SPAWN_TIMEOUT,
              threads=1, collective_timeout=1.5, worker=WORKER)
    assert all(code != 0 for code in err.value.returncodes)
    assert err.value.seconds < 60.0


def test_no_unported_route_is_left():
    """Every entry point of the JAX package has its counterpart: no call of
    ``not_ported(`` is left in the port."""
    calls = [f"{p.relative_to(ROOT)}:{i}"
             for p in sorted((ROOT / "eigenex_tpu_torch").rglob("*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if "not_ported(" in line and "def not_ported(" not in line]
    assert calls == []
