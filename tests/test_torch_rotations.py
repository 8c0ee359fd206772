"""The port's triplet operators, Givens rotations and shuffles
(``ops/rotations.py``) against the JAX package's on the same
numpy-seeded f64 inputs: results to 1e-12 relative, triplets exactly;
the input matrix is left as it was."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.ops import rotations as ref
from eigenex_tpu_torch.ops import rotations as port
from eigenex_tpu_torch.utils.exceptions import EigenexError


def close(got, want, rel=1e-12):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want)


@pytest.fixture
def M():
    return np.random.default_rng(11).standard_normal((5, 7))


@pytest.mark.parametrize("side", ["left", "right"])
def test_operate_triplets_matches_reference(M, side):
    rng = np.random.default_rng(12)
    n = 5 if side == "left" else 7
    T = rng.standard_normal((n, n))
    T[rng.random((n, n)) > 0.4] = 0
    r, c = np.nonzero(T)
    fp, fr = getattr(port, f"operate_triplets_{side}"), getattr(ref, f"operate_triplets_{side}")
    Mt = torch.as_tensor(M)
    got = fp(r, c, T[r, c], Mt)
    close(got, fr(r, c, T[r, c], jnp.asarray(M)))
    close(got, T @ M if side == "left" else M @ T)
    np.testing.assert_array_equal(Mt.numpy(), M)
    # a wider output than the matrix
    close(fp(r, c, T[r, c], Mt, n + 2), fr(r, c, T[r, c], jnp.asarray(M), n + 2))


def test_givens_triplets_match_reference():
    for n, i, j, th in [(5, 1, 3, 0.7), (4, 3, 0, -2.1)]:
        got = port.givens_rotation_triplets(n, i, j, th, device="cpu")
        want = ref.givens_rotation_triplets(n, i, j, th)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert g.device.type == "cpu"
    with pytest.raises(EigenexError):
        port.givens_rotation_triplets(3, 1, 1, 0.3, device="cpu")


@pytest.mark.parametrize("th", [0.7, 1.1, -0.3])
def test_rotations_match_reference(M, th):
    Mt = torch.as_tensor(M)
    close(port.rotate_from_left(Mt, 1, 3, th), ref.rotate_from_left(jnp.asarray(M), 1, 3, th))
    close(port.rotate_from_right(Mt, 2, 5, th), ref.rotate_from_right(jnp.asarray(M), 2, 5, th))
    np.testing.assert_array_equal(Mt.numpy(), M)
    np.testing.assert_allclose(float(torch.linalg.norm(port.rotate_from_left(Mt, 0, 4, th))),
                               np.linalg.norm(M), rtol=1e-12)


def test_shuffles_match_reference(M):
    Mt = torch.as_tensor(M)
    perm, perm7 = [4, 0, 3, 1, 2], [6, 5, 4, 3, 2, 1, 0]
    np.testing.assert_array_equal(port.rowwise_shuffle(Mt, perm).numpy(),
                                  np.asarray(ref.rowwise_shuffle(jnp.asarray(M), perm)))
    np.testing.assert_array_equal(port.colwise_shuffle(Mt, perm7).numpy(),
                                  np.asarray(ref.colwise_shuffle(jnp.asarray(M), perm7)))
    np.testing.assert_array_equal(port.cwise_shuffle(torch.arange(5.0), perm).numpy(),
                                  np.asarray(ref.cwise_shuffle(jnp.arange(5.0), perm)))
