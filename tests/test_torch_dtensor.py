"""The port's labeled tensor (``core/dtensor.py``) against the JAX
package's ``DTensor`` on the same numpy-seeded f64 data: every operation
gives the same labels and, to 1e-12 relative, the same values; the same
inputs raise.  ``contract`` runs at "highest" f32 matmul precision."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.core.dtensor import dtensor as j_dtensor
from eigenex_tpu_torch import DTensor, dtensor
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def close(t, want, rel=1e-12):
    got = t.to_array().numpy()
    want = np.asarray(want.to_array()) if hasattr(want, "to_array") else np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rel * max(np.linalg.norm(want), 1e-300)


@pytest.fixture
def pair():
    """(port, reference) rank-3 tensors on the same data."""
    x = np.random.default_rng(5).standard_normal((3, 4, 5))
    return dtensor(torch.as_tensor(x), ("i", "j", "k")), j_dtensor(jnp.asarray(x), ("i", "j", "k"))


OPS = {
    "rename": lambda t, d: t.rename(i="a"),
    "transpose": lambda t, d: t.transpose_to(("k", "i", "j")),
    "add_aligned": lambda t, d: t + t.transpose_to(("k", "j", "i")),
    "sub_aligned": lambda t, d: t - t.transpose_to(("j", "k", "i")) * 0.5,
    "hadamard": lambda t, d: (2.0 * t) * t.transpose_to(("k", "j", "i")),
    "neg_conj": lambda t, d: (-t).conj(),
    "project": lambda t, d: t.to(("j",)),
    "project_reorder": lambda t, d: t.to(("k", "i")),
    "contract_self": lambda t, d: t.contract(t.rename(i="i2", k="k2")),
    "contract_batch": lambda t, d: t.contract(t.rename(j="j2"), out_labels=("i", "j", "j2")),
    "kron": lambda t, d: t.to(("i",)).kron(t.to(("k",)).rename(k="m")),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_ops_match_reference(pair, name):
    got, want = OPS[name](pair[0], None), OPS[name](pair[1], None)
    assert isinstance(got, DTensor) and got.labels == want.labels
    close(got, want)


def test_trace_label_matches_reference():
    X = np.random.default_rng(6).standard_normal((4, 4, 3))
    got, want = dtensor(torch.as_tensor(X), "ijk"), j_dtensor(jnp.asarray(X), "ijk")
    for out_label in (None, "d"):
        a, b = got.trace_label("i", "j", out_label), want.trace_label("i", "j", out_label)
        assert a.labels == b.labels
        close(a, b)


def test_introspection_and_device(pair):
    t, _ = pair
    assert (t.ndim, t.shape, t.dim("j"), t.axis("k")) == (3, (3, 4, 5), 4, 2)
    assert t.device.type == "cpu" and t.dtype == torch.float64
    h = dtensor(np.ones((2, 3)), ("a", "b"), device="cpu")
    assert h.device.type == "cpu"
    np.testing.assert_array_equal(t.to_array(("j", "i", "k")).numpy(),
                                  t.data.numpy().transpose(1, 0, 2))


@pytest.mark.parametrize("bad", [
    lambda d, x: d(x((2, 2)), ("i",)),
    lambda d, x: d(x((2, 2)), ("i", "i")),
    lambda d, x: d(x((2, 2)), ("i", "j")).axis("z"),
    lambda d, x: d(x((2, 2)), ("i", "j")).rename(z="q"),
    lambda d, x: d(x((2, 2)), ("i", "j")).transpose_to(("i",)),
    lambda d, x: d(x((2, 2)), ("i", "j")) + d(x((2, 2)), ("i", "z")),
    lambda d, x: d(x((2, 3)), ("i", "j")).trace_label("i", "j"),
    lambda d, x: d(x((2, 3)), ("i", "j")).kron(d(x((2,)), ("i",))),
])
def test_errors_match_reference(bad):
    with pytest.raises(EigenexError) as got:
        bad(lambda a, labels: dtensor(a, labels, device="cpu"), lambda s: np.zeros(s))
    with pytest.raises(Exception) as want:
        bad(j_dtensor, lambda s: jnp.zeros(s))
    assert str(got.value) == str(want.value)


def test_contract_runs_at_highest_precision(monkeypatch):
    seen = []
    real = torch.einsum

    def recording(*args):
        seen.append(torch.get_float32_matmul_precision())
        return real(*args)

    monkeypatch.setattr(torch, "einsum", recording)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        a = dtensor(torch.ones((4, 4)), ("i", "j"))
        a.contract(a.rename(i="k"))
        assert seen == ["highest"] and torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
