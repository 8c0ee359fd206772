"""Multi-index bijection + string-labeled diagonal demo.

Counterpart of ``samples/sample_product_indices.py`` (reference
sample_product_indices.cpp:15-37).  Index arithmetic only: ``device`` is
accepted for the samples' common signature and not used."""

from __future__ import annotations

import numpy as np

from eigenex_tpu_torch import ProductIndices


def main(device=None) -> dict:
    pi = ProductIndices([2, 3, 2])
    print("dims:", pi.dims, "size:", pi.size)
    print("flat -> multi -> flat round trip:")
    trips = []
    for flat in range(pi.size):
        multi = pi.indices(flat)
        back = pi.absolute_index(multi)
        trips.append((flat, tuple(int(m) for m in multi), int(back)))
        print(f"  {flat:2d} -> {multi} -> {back}")

    print()
    print('relabel ["i","j","i"] -> ["i","j"] (diagonal merge by stride addition):')
    pj = ProductIndices([2, 3, 2]).from_(["i", "j", "i"]).to(["i", "j"])
    print("  result:", pj)
    merged = {}
    for i in range(2):
        for j in range(3):
            merged[(i, j)] = int(pj.absolute_index((i, j)))
            assert merged[(i, j)] == np.ravel_multi_index((i, j, i), (2, 3, 2))
    print("  verified: pj[(i,j)] addresses a[i,j,i] for all i,j")
    return dict(dims=tuple(int(d) for d in pi.dims), size=int(pi.size), round_trips=trips,
                merged_dims=tuple(int(d) for d in pj.dims), merged=merged)


if __name__ == "__main__":
    from ._cli import run

    run(main)
