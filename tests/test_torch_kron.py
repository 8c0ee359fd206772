"""The port's lazy Kronecker product (``ops/kron.py``) against the JAX
package's on the same numpy-seeded factors: dims, every coefficient (by
multi-index and by flat index) and the dense tensor equal to 1e-15."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.ops.kron import tensor_kronecker_product as j_kron
from eigenex_tpu_torch import TensorKroneckerProduct, tensor_kronecker_product


@pytest.mark.parametrize("shapes", [((2, 3), (4,)), ((3,), (2, 2, 2)), ((2, 1, 3), (1, 2))])
def test_kron_matches_reference(shapes):
    rng = np.random.default_rng(9)
    a, b = (rng.standard_normal(s) for s in shapes)
    got = tensor_kronecker_product(torch.as_tensor(a), torch.as_tensor(b))
    want = j_kron(jnp.asarray(a), jnp.asarray(b))
    assert isinstance(got, TensorKroneckerProduct)
    assert got.dims == want.dims and got.ndim == want.ndim
    np.testing.assert_allclose(got.to_dense().numpy(), np.asarray(want.to_dense()), rtol=1e-15)
    for flat in range(int(np.prod(got.dims))):
        assert float(got.coeff_flat(flat)) == float(want.coeff_flat(flat))
    multi = tuple(d - 1 for d in got.dims)
    assert float(got.coeff(multi)) == float(want.coeff(multi))


def test_mixed_dtypes_promote_and_host_factors_go_to_device():
    a = np.arange(6.0).reshape(2, 3).astype(np.float32)
    b = torch.arange(4.0, dtype=torch.float64)
    kp = tensor_kronecker_product(a, b)
    assert kp.left.device == b.device and kp.dtype == torch.float64
    np.testing.assert_array_equal(kp.to_dense().numpy(), np.einsum("ij,k->ijk", a, b.numpy()))
    host = tensor_kronecker_product(a, a, device="cpu")
    assert host.to_dense().device.type == "cpu" and host.dtype == torch.float32
