"""The port's labeled einsum DSL (``ops/einsum.py``) against the JAX
package's on the same numpy-seeded f64 operands: results to 1e-12
relative, the same subscripts and the same errors (class and message).
Every product runs at "highest" f32 matmul precision under a caller's
"medium", and the caller's setting comes back."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.ops.einsum  # noqa: F401  (the package re-exports a function of that name)
from eigenex_tpu.utils.exceptions import EinsumError as RefEinsumError
import eigenex_tpu_torch.ops.einsum  # noqa: F401  (so does the port's)
from eigenex_tpu_torch.utils.exceptions import EinsumError

ref = sys.modules["eigenex_tpu.ops.einsum"]
port = sys.modules["eigenex_tpu_torch.ops.einsum"]
torch.set_num_threads(1)


def close(x, want, rel=1e-12):
    x, want = x.numpy(), np.asarray(want)
    assert x.shape == want.shape
    assert np.linalg.norm(x - want) <= rel * max(np.linalg.norm(want), 1e-300)


def operands(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


CASES = [
    # (shapes, in_labels, out_labels)
    (((3, 4), (4, 5)), (("i", "j"), ("j", "k")), ("i", "k")),
    (((5, 5),), (("i", "i"),), ("i",)),
    (((6, 6),), (("i", "i"),), ()),
    (((3, 4), (3, 5)), (("i", "j"), ("i", "k")), ("i", "j", "k")),
    (((2, 3), (3, 2)), (("left", "mid"), ("mid", "right")), ("left", "right")),
    (((2, 3), (3, 4), (4, 2)), (("i", "j"), ("j", "k"), ("k", "l")), ("i", "l")),
    (((4, 3, 4, 2),), (("a", "b", "a", "c"),), ("c", "a")),
    (((2, 3, 4), (4, 3, 5)), (("x", "y", "z"), ("z", "y", "w")), ("w", "x")),
]


@pytest.mark.parametrize("shapes,ins,out", CASES)
def test_einsum_labels_matches_reference(shapes, ins, out):
    xs = operands(*shapes)
    got = port.einsum_labels([torch.as_tensor(x) for x in xs], ins, out)
    want = ref.einsum_labels([jnp.asarray(x) for x in xs], ins, out)
    close(got, want)
    assert port.build_subscripts(ins, out) == ref.build_subscripts(ins, out)


@pytest.mark.parametrize("shapes,ins,out", CASES)
def test_fluent_einsum_matches_reference(shapes, ins, out):
    xs = operands(*shapes, seed=1)
    got = port.einsum(*[torch.as_tensor(x) for x in xs]).from_(*ins).to(out)
    want = ref.einsum(*[jnp.asarray(x) for x in xs]).from_(*ins).to(out)
    close(got, want)
    assert port.einsum(*[torch.as_tensor(x) for x in xs]).From(*ins).to(out).shape == got.shape


def test_contract_matches_reference():
    a, b = operands((3, 4), (4, 5), seed=2)
    got = port.contract(torch.as_tensor(a), torch.as_tensor(b)).from_(["i", "j"], ["j", "k"]).to(["i", "k"])
    want = ref.contract(jnp.asarray(a), jnp.asarray(b)).from_(["i", "j"], ["j", "k"]).to(["i", "k"])
    close(got, want)
    close(got, a @ b)


def test_host_operands_go_to_the_named_device_and_join_tensors():
    a, b = operands((3, 4), (4, 5), seed=3)
    got = port.einsum(a, b, device="cpu").from_(["i", "j"], ["j", "k"]).to(["i", "k"])
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    close(got, a @ b)
    mixed = port.einsum_labels([torch.as_tensor(a), b], [("i", "j"), ("j", "k")], ("i", "k"))
    close(mixed, a @ b)


BAD = [
    ([(2, 2)], [("i", "i")], ("j",)),          # output label absent
    ([(2, 3)], [("i", "i")], ("i",)),          # unequal diagonal dims
    ([(2, 3)], [("i",)], ("i",)),              # rank/label mismatch
    ([(2, 3)], [("i", "j")], ("i", "i")),      # repeated output label
]


@pytest.mark.parametrize("shapes,ins,out", BAD)
def test_errors_match_reference(shapes, ins, out):
    xs = operands(*shapes)
    with pytest.raises(EinsumError) as got:
        port.einsum_labels([torch.as_tensor(x) for x in xs], ins, out)
    with pytest.raises(RefEinsumError) as want:
        ref.einsum_labels([jnp.asarray(x) for x in xs], ins, out)
    assert str(got.value) == str(want.value)


def test_label_count_and_arity_errors():
    with pytest.raises(EinsumError, match="too many"):
        port.build_subscripts([[str(i) for i in range(53)]], [])
    with pytest.raises(EinsumError, match="label lists"):
        port.einsum(torch.zeros(2)).from_(["i"], ["j"])


def test_products_run_at_highest_precision(monkeypatch):
    seen = []
    real = torch.einsum

    def recording(*args):
        seen.append(torch.get_float32_matmul_precision())
        return real(*args)

    monkeypatch.setattr(torch, "einsum", recording)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        a, b = (torch.as_tensor(x, dtype=torch.float32) for x in operands((8, 8), (8, 8)))
        port.einsum(a, b).from_("ij", "jk").to("ik")
        port.contract(a, b).from_("ij", "jk").to("ik")
        assert seen == ["highest", "highest"]
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
