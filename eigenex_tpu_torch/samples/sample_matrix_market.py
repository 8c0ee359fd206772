"""Matrix Market round trip: write a symmetric operator in half storage,
load it back expanded (and as the raw stored triangle), solve on it.

Counterpart of ``samples/sample_matrix_market.py``.  The file goes to a
temporary directory that is removed afterwards."""

from __future__ import annotations

import os
import tempfile

import numpy as np

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    dev = resolve_device(device)
    # build a symmetric banded operator and write it in half storage
    n = 500
    rng = np.random.default_rng(0)
    diag = np.arange(n, dtype=np.float64) * 0.1 + 1.0
    off = rng.standard_normal(n - 1) * 0.3
    D = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    A = ext.coo_from_dense(D, device=dev)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "operator.mtx")
        ext.save_matrix_market(path, A, symmetry="symmetric", comment="banded demo operator")
        print(f"wrote {path}: {A.nnz} nnz as symmetric (lower-triangle) storage")

        # load back: symmetry expanded to full COO
        B = ext.load_matrix_market(path, device=dev)
        print(f"loaded: shape {B.shape}, nnz {B.nnz} (expanded)")
        assert np.allclose(np.asarray(B.to_dense()), D)

        # raw stored triangle (native parser) -- the feed for half-traffic SymBSR
        tri = ext.load_matrix_market(path, expand_symmetry=False, device=dev)
        print(f"raw triangle: nnz {tri.nnz} (= diagonal + one triangle)")

    # the loaded operator drives the solvers directly
    res = ext.eigsh(B, k=3, which="SA", tol=1e-12)
    ref = np.linalg.eigvalsh(D)[:3]
    print("lowest 3 eigenvalues:", np.asarray(res.eigenvalues))
    print("vs dense eigh:       ", ref)
    assert np.allclose(res.eigenvalues, ref, atol=1e-9)
    print("OK")
    return dict(nnz=int(A.nnz), loaded_nnz=int(B.nnz), triangle_nnz=int(tri.nnz),
                eigenvalues=np.asarray(res.eigenvalues), oracle=ref)


if __name__ == "__main__":
    from ._cli import run

    run(main)
