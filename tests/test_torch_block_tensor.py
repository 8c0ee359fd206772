"""The port's ``BlockTensor`` and block einsum (``block/block_tensor.py``)
against the JAX package's, on block tensors built from the same
numpy-seeded blocks: every operation gives the same stored key set
(exactly) and the same dense tensor (f64, 1e-12 relative); the
enumeration counter ``_LAST_CANDIDATE_COUNT`` is equal; the same misuse
raises.  A stored block is never written into, and a caller's array
handed to ``set_block``/``add_block`` is copied in."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.block.block_tensor as jbt
import eigenex_tpu_torch.block.block_tensor as tbt
from eigenex_tpu.core.indices import AddIndices as JAddIndices
from eigenex_tpu.ops.einsum import einsum as j_einsum
from eigenex_tpu_torch import AddIndices, BlockTensor, block_tensor_norm, block_tensor_squared_norm, einsum
from eigenex_tpu_torch.utils.exceptions import BlockTensorError

torch.set_num_threads(1)


def pair(seed, structures, density=0.6, dtype=np.float64):
    """(port, reference) block tensors holding the same random blocks."""
    rng = np.random.default_rng(seed)
    port = BlockTensor([AddIndices(s) for s in structures], dtype=dtype, device="cpu")
    ref = jbt.BlockTensor([JAddIndices(s) for s in structures], dtype=dtype)
    for key in np.ndindex(*(len(s) for s in structures)):
        if rng.random() < density:
            shape = tuple(s[b] for s, b in zip(structures, key))
            blk = rng.standard_normal(shape)
            if np.dtype(dtype).kind == "c":
                blk = blk + 1j * rng.standard_normal(shape)
            port.set_block(key, blk.astype(dtype))
            ref.set_block(key, jnp.asarray(blk.astype(dtype)))
    return port, ref


def same(got, want, rel=1e-12):
    if isinstance(got, BlockTensor):
        assert set(got.block_keys()) == set(want.block_keys())
        assert got.dims == want.dims and got.block_dims == want.block_dims
        assert got.dtype == torch.as_tensor(np.zeros(0, want.dtype)).dtype
        got, want = got.to_dense(), want.to_dense()
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rel * max(np.linalg.norm(want), 1e-300)


S3 = [[2, 3], [2, 2], [3]]

UNARY = {
    "roundtrip": lambda t, m: m.from_dense(np.asarray(t.to_dense()), t.structures),
    "shuffle": lambda t, m: t.shuffle([2, 0, 1]),
    "block_shuffle": lambda t, m: t.block_shuffle(0, [1, 0]),
    "reblock": lambda t, m: t.reblock([[1, 4], [1, 1, 2], [2, 1]]),
    "axis_fixed": lambda t, m: t.axis_fixed(0, 3),
    "truncate": lambda t, m: t.truncate(1.5),
    "scalar": lambda t, m: (2.0 * t) / 4 - t,
    "neg": lambda t, m: -t,
    "contract_self": lambda t, m: t.contract(t, [(0, 0), (2, 2)]),
    "einsum_diag": lambda t, m: m.einsum(t, t).from_(["i", "j", "k"], ["i", "j", "m"]).to(["i", "k", "m"]),
    "einsum_trace": lambda t, m: m.einsum(t).from_(["a", "b", "c"]).to(["c", "a"]),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_ops_match_reference(name):
    port, ref = pair(0, S3)
    port_mod = type("M", (), {"from_dense": staticmethod(
        lambda d, s: BlockTensor.from_dense(d, s, device="cpu")), "einsum": staticmethod(einsum)})
    ref_mod = type("M", (), {"from_dense": staticmethod(jbt.BlockTensor.from_dense),
                             "einsum": staticmethod(j_einsum)})
    same(UNARY[name](port, port_mod), UNARY[name](ref, ref_mod))


def test_binary_ops_match_reference():
    a, ja = pair(1, [[2, 3], [2, 2]])
    b, jb = pair(2, [[2, 3], [2, 2]])
    same(a + b, ja + jb)
    same(a - b, ja - jb)
    same(a * b, ja * jb)
    c, jc = pair(3, [[2, 2], [3, 1]])
    same(a.contract(c, [(1, 0)]), ja.contract(jc, [(1, 0)]))
    d, jd = pair(4, [[2, 3], [2, 2], [3]])
    e, je = pair(5, [[2, 2], [3], [4, 1]])
    same(d.contract(e, [(1, 0), (2, 1)]), jd.contract(je, [(1, 0), (2, 1)]))
    same(einsum(a, c).from_(["i", "j"], ["j", "k"]).to(["i", "k"]),
         j_einsum(ja, jc).from_(["i", "j"], ["j", "k"]).to(["i", "k"]))
    f, jf = pair(6, [[2, 2], [3, 2]], density=1.0)
    g, jg = pair(7, [[2, 2], [2, 1]], density=1.0)
    same(einsum(f, g).from_(["i", "j"], ["i", "k"]).to(["i", "j", "k"]),
         j_einsum(jf, jg).from_(["i", "j"], ["i", "k"]).to(["i", "j", "k"]))


def test_traces_norms_and_values_match_reference():
    a, ja = pair(8, [[2, 3], [2, 3], [4]], density=1.0)
    same(a.trace(0, 1), ja.trace(0, 1))
    b, jb = pair(9, [[2, 3], [2, 3]], density=0.7)
    same(b.full_trace(), jb.full_trace())
    for f in (block_tensor_norm, block_tensor_squared_norm):
        assert abs(float(f(b)) - float(f(jb))) <= 1e-12 * float(f(jb))
    same(b.stored_values(), jb.stored_values())
    c, jc = pair(10, [[2, 2]], density=1.0, dtype=np.complex128)
    same(c.conjugate(), jc.conjugate())
    assert c.cast(np.complex64).dtype == torch.complex64
    assert abs(float(c.norm()) - float(jc.norm())) <= 1e-12 * float(jc.norm())
    assert c.norm().dtype == torch.float64


def test_elements_and_mutators_match_reference():
    port = BlockTensor([[2, 2], [3, 1]], dtype=np.float64, device="cpu")
    ref = jbt.BlockTensor([JAddIndices([2, 2]), JAddIndices([3, 1])], dtype=np.float64)
    for t in (port, ref):
        t.set_element((3, 2), 7.0)
        t.add_element((3, 2), 1.0)
        t.add_element((0, 3), -2.0)
        t.add_block((1, 0), np.full((2, 3), 0.5))
        t.add_block((1, 0), np.ones((2, 3)))
        t.mul_block((1, 0), 3.0)
        t.set_block((0, 0), np.arange(6.0).reshape(2, 3))
        t.erase_block((0, 0))
        t.set_block((2, 4), np.arange(6.0).reshape(2, 3))  # periodic block keys
    same(port, ref)
    assert float(port.get_element((3, 2))) == float(ref.get_element((3, 2))) == 28.5
    assert float(port.get_element((1, 3))) == 0.0
    assert port.equals_blocks(port.with_blocks(port.blocks)) and port.num_stored_blocks == 3


def test_selection_rule_keys():
    s = AddIndices([2, 3])
    rng = np.random.default_rng(0)
    a = BlockTensor([s, s], dtype=np.float64, device="cpu")
    b = BlockTensor([s, s], dtype=np.float64, device="cpu")
    for k in range(2):
        a.set_block((k, k), rng.standard_normal((s.block_dims[k],) * 2))
        b.set_block((k, k), rng.standard_normal((s.block_dims[k],) * 2))
    r = a.contract(b, [(1, 0)])
    assert set(r.block_keys()) == {(0, 0), (1, 1)}
    same(r.to_dense(), a.to_dense().numpy() @ b.to_dense().numpy())


def test_enumeration_count_matches_reference():
    """S diagonal sectors per operand sharing one label: exactly S combos
    are enumerated, in both packages."""
    S = 300
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((2, S))
    port = [BlockTensor([[1] * S, [1] * S], dtype=np.float64, device="cpu") for _ in range(2)]
    ref = [jbt.BlockTensor([JAddIndices([1] * S)] * 2, dtype=np.float64) for _ in range(2)]
    for i in range(2):
        for s in range(S):
            port[i].set_block((s, s), vals[i, s].reshape(1, 1))
            ref[i].set_block((s, s), jnp.asarray(vals[i, s].reshape(1, 1)))
    out = tbt.block_einsum(port, [("i", "j"), ("j", "k")], ("i", "k"))
    jout = jbt.block_einsum(ref, [("i", "j"), ("j", "k")], ("i", "k"))
    assert tbt._LAST_CANDIDATE_COUNT == jbt._LAST_CANDIDATE_COUNT == S
    same(out, jout)
    # a label repeated within one tensor selects its diagonal sectors first
    a, ja = pair(11, [[2, 2], [2, 2]], density=1.0)
    same(tbt.block_einsum([a], [("i", "i")], ("i",)), jbt.block_einsum([ja], [("i", "i")], ("i",)))
    assert tbt._LAST_CANDIDATE_COUNT == jbt._LAST_CANDIDATE_COUNT == 2


def test_blocks_are_copied_in_and_never_written_into():
    arr = torch.ones((2, 2), dtype=torch.float64)
    host = np.ones((2, 2))
    t = BlockTensor([[2], [2]], dtype=np.float64, device="cpu")
    t.set_block((0, 0), arr)
    arr += 1  # the owner's later write does not reach the stored block
    assert float(t.blocks[(0, 0)].sum()) == 4.0
    t2 = BlockTensor([[2], [2]], dtype=np.float64, device="cpu")
    t2.add_block((0, 0), host)
    host += 1
    assert float(t2.blocks[(0, 0)].sum()) == 4.0
    stored = t.blocks[(0, 0)]
    snapshot = stored.clone()
    t.set_element((0, 1), 5.0)
    t.add_element((1, 1), 2.0)
    t.add_block((0, 0), torch.ones((2, 2), dtype=torch.float64))
    t.mul_block((0, 0), 3.0)
    t.reblock([[1, 1], [1, 1]])
    (t + t).shuffle([1, 0]).contract(t, [(0, 0)])
    assert torch.equal(stored, snapshot)  # every update built a new tensor


@pytest.mark.parametrize("bad", [
    lambda m, t: t.set_block((0,), np.zeros(3)),
    lambda m, t: t.set_block((0, 0, 0), np.zeros(3)),
    lambda m, t: t.shuffle([0, 0]),
    lambda m, t: t.block_shuffle(0, [0, 0]),
    lambda m, t: t.reblock([[1, 1], [5]]),
    lambda m, t: t.contract(t.block_shuffle(0, [1, 0]), [(0, 0)]),
    lambda m, t: t.full_trace() if t.ndim != 2 else t.trace(0, 1),
    lambda m, t: m.einsum(t, t).from_(["i", "j"]),
    lambda m, t: m.einsum(t).from_(["i", "j"]).to(["z"]),
    lambda m, t: m.einsum(t, t.block_shuffle(0, [1, 0])).from_(["i", "j"], ["i", "k"]).to(["i"]),
])
def test_errors_match_reference(bad):
    port, ref = pair(12, [[2, 3], [3, 2]], density=1.0)
    with pytest.raises(BlockTensorError) as got:
        bad(type("M", (), {"einsum": staticmethod(einsum)}), port)
    with pytest.raises(Exception) as want:
        bad(type("M", (), {"einsum": staticmethod(j_einsum)}), ref)
    assert str(got.value) == str(want.value)


def test_device_and_repr():
    t = BlockTensor([[2, 1]], dtype=torch.float32, device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.float32
    t.set_block((1,), np.ones(1))
    assert t.blocks[(1,)].device.type == "cpu" and t.blocks[(1,)].dtype == torch.float32
    assert "stored=1" in repr(t)
    with pytest.raises(BlockTensorError):
        einsum(t, torch.ones(3))


def test_contractions_run_at_highest_precision(monkeypatch):
    """``contract`` and the block einsum pin "highest" f32 matmul precision
    for their products, whatever the caller set, and give it back."""
    seen = []
    real = torch.einsum

    def recording(*args):
        seen.append(torch.get_float32_matmul_precision())
        return real(*args)

    monkeypatch.setattr(torch, "einsum", recording)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        a, _ = pair(13, [[2, 3], [2, 3]], density=1.0, dtype=np.float32)
        a.contract(a, [(1, 0)])
        einsum(a, a).from_(["i", "j"], ["j", "k"]).to(["i", "k"])
        assert seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
