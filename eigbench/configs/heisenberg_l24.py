"""BASELINE config 3 at its published size: the spin-1/2 Heisenberg chain,
J = Jz = 1, open ends, L = 24, in the S_z = 0 sector (dim 2,704,156, 35.2 M
nonzeros).  Built by the measured package's native sector enumerator and
packed by its ``accelerate`` into the symmetric 128x128 pack, stored in
bfloat16: every value is a dyadic fraction that bfloat16 holds exactly.
Not cut: ``reduced`` is empty."""

SOURCE = ("https://github.com/versmc/cmpt-eigenex (BASELINE.json configs[2], Heisenberg "
          "BlockTensor ground state; L = 24, S_z = 0 as BASELINE.md publishes it)")
REDUCED: list = []
#: set here, not by the source: the couplings and ends of the published run
#: (benchmarks/bench_heisenberg.py), and the storage accelerate() picks
ASSUMED = {"J": 1.0, "Jz": 1.0, "pbc": False, "storage": "bfloat16 (lossless)"}
PARAMS = {"L": 24, "n_up": 12, "J": 1.0, "Jz": 1.0, "pbc": False}
STORAGE = "bfloat16"
SYMMETRIC = True
REFERENCE = "heisenberg_chain"


def operand(params):
    from eigenex_tpu_torch.block.hamiltonians import heisenberg_sector_coo

    return heisenberg_sector_coo(params["L"], params["n_up"], params["J"], params["Jz"],
                                 params["pbc"], device="cpu")


def triplets(coo):
    return coo.row.numpy(), coo.col.numpy(), coo.shape


def pack(coo, device):
    from eigenex_tpu_torch import accelerate

    return accelerate(coo, symmetric=True, device=device)
