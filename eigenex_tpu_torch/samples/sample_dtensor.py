"""Labeled dense tensors: contraction by shared labels, batch labels,
labeled Kronecker product, trace/diagonal, label-aligned arithmetic.

Counterpart of ``samples/sample_dtensor.py``."""

from __future__ import annotations

import numpy as np
import torch

from eigenex_tpu_torch import dtensor
from eigenex_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev)

    A = dtensor(t((3, 4)), ("i", "j"))
    B = dtensor(t((4, 5)), ("j", "k"))

    print(A, "x", B)
    C = A.contract(B)  # sums shared label j -> ("i", "k")
    print("contract:", C)
    assert torch.allclose(C.to_array(), A.data @ B.data)

    # batch label: kept by naming it in the output
    X = dtensor(t((6, 3, 4)), ("b", "i", "j"))
    Y = dtensor(t((6, 4, 2)), ("b", "j", "k"))
    Z = X.contract(Y, out_labels=("b", "i", "k"))
    print("batched contract:", Z)

    # labeled Kronecker product
    K = A.kron(dtensor(t(2), ("m",)))
    print("kron:", K)

    # labeled diagonal / trace
    T = dtensor(t((4, 4, 3)), ("p", "q", "r"))
    tr = T.trace_label("p", "q")
    dg = T.trace_label("p", "q", out_label="d")
    print("trace p=q:", tr)
    print("diag kept:", dg)

    # element-wise ops auto-align by label, whatever the axis order
    P = A.transpose_to(("j", "i"))
    S = A + P  # aligns P back to ("i", "j")
    assert torch.allclose(S.to_array(), 2 * A.data)

    print("sample_dtensor OK")

    def host(d):
        return (tuple(d.labels), d.to_array().cpu().numpy())

    return dict(contract=host(C), batched=host(Z), kron=host(K), trace=host(tr),
                diag=host(dg), sum=host(S))


if __name__ == "__main__":
    from ._cli import run

    run(main)
