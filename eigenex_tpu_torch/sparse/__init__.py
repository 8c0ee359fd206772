"""The public names of the sparse modules, re-exported as ``eigenex_tpu/sparse/__init__.py``
re-exports its own."""

from .accelerate import AcceleratedOperator, accelerate, band_permutation
from .bsr import BSRMatrix, bsr_from_coo_arrays, bsr_from_dense
from .coo import COOBuilder, COOMatrix, coo_from_dense, coo_identity
from .csr import CSRMatrix, csr_from_coo, csr_from_dense
from .io import load_matrix_market, save_matrix_market
from .sym_bsr import SymBSRMatrix, sym_bsr_from_bsr
from .sym_csr import SymCSRMatrix, sym_csr_from_triplets

__all__ = [
    "AcceleratedOperator",
    "accelerate",
    "band_permutation",
    "load_matrix_market",
    "save_matrix_market",
    "BSRMatrix",
    "bsr_from_coo_arrays",
    "bsr_from_dense",
    "COOBuilder",
    "COOMatrix",
    "coo_from_dense",
    "coo_identity",
    "CSRMatrix",
    "csr_from_coo",
    "csr_from_dense",
    "SymBSRMatrix",
    "sym_bsr_from_bsr",
    "SymCSRMatrix",
    "sym_csr_from_triplets",
]
