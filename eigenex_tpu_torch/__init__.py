"""eigenex_tpu_torch -- the PyTorch/CUDA port of eigenex_tpu.

Krylov, Krylov-Schur and block eigensolvers, CG/MINRES/CGLS/GMRES and
exact tridiagonal shift-invert operators, truncated SVD on the Gram
operator, Krylov and Taylor f(A)v / exp(xA)v, and host f64 refinement
over block-sparse operators on torch tensors, with hand-written CUDA kernels for the
block-sparse matvec and multi-vector product on an NVIDIA Hopper card;
and the tensor layer: multi-index arithmetic, the string-labeled einsum,
labeled tensors (``DTensor``), block-sparse symmetry-sector tensors
(``BlockTensor``) with their operator bridge and spin-chain builders,
CSR storage and Matrix Market IO; the native C++ host builders
(sector enumeration, RCM, block packing, the Matrix Market parser); and
solver-state checkpoints, profiling hooks and the timing protocol; and the
distributed layer (device meshes, ``shard_map``, the row-partitioned SpMV
modes and the distributed drivers, ``mesh=`` on every front end).
The JAX package ``eigenex_tpu`` is the reference; a module here sits at
the same subpath as its counterpart there.

Importing this package imports ``torch`` and nothing else heavy: it
builds no kernel, imports no ``triton`` and touches no CUDA device.  The
kernels are compiled with ``nvcc`` at their first launch, the native host
builders with ``g++`` at their first use.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .block.block_tensor import BlockTensor, block_tensor_norm, block_tensor_squared_norm
from .block.hamiltonians import (
    heisenberg_block_hamiltonian,
    heisenberg_ground_state,
    heisenberg_sector_coo,
)
from .core.dtensor import DTensor, dtensor
from .core.indices import AddIndices, ProductIndices, Slice
from .core.operators import LinearOperator, aslinearoperator, identity_operator
from .ops.einsum import contract, einsum
from .ops.kron import TensorKroneckerProduct, tensor_kronecker_product
from .ops.orthogonalize import cgs2, gram_schmidt, orthogonal_complement, project_out
from .ops.sparse_svd import gram_operator, truncated_svd_via_lanczos
from .ops.tensor_svd import TensorSVDResult, tensor_svd, truncated_tensor_svd
from .ops.tensor_util import (
    contract_vector_as_diagonal,
    transform_tensor_with_matrix,
    zerowisely_resized,
)
from .solvers.api import eigs, eigsh, svds
from .solvers.arnoldi import ArnoldiEigenSolver, ArnoldiOptions, ArnoldiResult
from .solvers.block_lanczos import BlockLanczosEigenSolver, BlockLanczosOptions
from .solvers.chebyshev import (
    ChebyshevFilterOptions,
    ChebyshevFilterSolver,
    chebyshev_bandpass_apply,
    chebyshev_filter_apply,
    eigsh_window,
)
from .solvers.cg import cg_solve, cgls_solve, minres_solve, shift_invert_operator
from .solvers.direct import tridiagonal_operator, tridiagonal_shift_invert_operator
from .solvers.functions import (
    LanczosExponentialSolver,
    LanczosFunctionSolver,
    dense_expmv,
    expm_multiply,
    lanczos_expmv,
    lanczos_function_apply,
    taylor_expmv,
    taylor_expmv_auto,
)
from .solvers.gmres import gmres_solve, gmres_solve_jit, shift_invert_operator_general
from .solvers.kpm import chebyshev_moments, eigenvalue_count, eigsh_range, spectral_density
from .solvers.krylov_schur import KrylovSchurArnoldiSolver, KrylovSchurOptions
from .solvers.lanczos import (
    UNLIMITED,
    LanczosEigenSolver,
    LanczosOptions,
    LanczosResult,
    LanczosState,
    init_lanczos_state,
    lanczos_steps,
)
from .solvers.lobpcg import LOBPCGOptions, LOBPCGSolver, lobpcg
from .solvers.precond import jacobi_preconditioner
from .solvers.refine import (
    general_inverse_iteration_refine,
    general_rayleigh_refine,
    inverse_iteration_refine,
    rayleigh_refine,
)
from .solvers.restart import ThickRestartLanczosEigenSolver, ThickRestartOptions
from .sparse.accelerate import AcceleratedOperator, accelerate
from .sparse.bsr import BSRMatrix, bsr_from_coo_arrays, bsr_from_dense
from .sparse.coo import COOBuilder, COOMatrix, coo_from_dense, coo_identity
from .sparse.csr import CSRMatrix, csr_from_coo, csr_from_dense
from .sparse.io import load_matrix_market, save_matrix_market
from .sparse.realify import (
    complex_from_real,
    dedup_doubled_eigenvalues,
    eigs_realified,
    real_from_complex,
    realify_coo,
)
from .sparse.sym_bsr import SymBSRMatrix, sym_bsr_from_bsr
from .sparse.sym_csr import SymCSRMatrix
from .utils.exceptions import (
    ArnoldiError,
    BlockTensorError,
    EigenexError,
    EinsumError,
    LanczosError,
    OperatorError,
)
from .parallel import (
    DistributedLanczosEigenSolver,
    DistributedThickRestartLanczosEigenSolver,
    distributed_lanczos_steps,
    initialize_multihost,
    make_mesh,
    pad_bsr_for_mesh,
)
from .utils.checkpoint import load_state, save_state, shard_state
from .utils.prng import (
    random_hermitian,
    random_matrix,
    random_normal,
    random_orthogonal,
    random_tensor,
    random_uniform,
    random_vector,
)
from .utils.tolerance import default_tolerance
from .utils.trace import ConvergenceTrace

__all__ = [
    "DistributedLanczosEigenSolver",
    "DistributedThickRestartLanczosEigenSolver",
    "distributed_lanczos_steps",
    "initialize_multihost",
    "make_mesh",
    "pad_bsr_for_mesh",
    "AcceleratedOperator",
    "AddIndices",
    "ArnoldiEigenSolver",
    "ArnoldiError",
    "ArnoldiOptions",
    "ArnoldiResult",
    "BSRMatrix",
    "BlockLanczosEigenSolver",
    "BlockLanczosOptions",
    "BlockTensor",
    "BlockTensorError",
    "COOBuilder",
    "COOMatrix",
    "CSRMatrix",
    "ChebyshevFilterOptions",
    "ChebyshevFilterSolver",
    "ConvergenceTrace",
    "DTensor",
    "EigenexError",
    "EinsumError",
    "KrylovSchurArnoldiSolver",
    "KrylovSchurOptions",
    "LOBPCGOptions",
    "LOBPCGSolver",
    "LanczosEigenSolver",
    "LanczosError",
    "LanczosExponentialSolver",
    "LanczosFunctionSolver",
    "LanczosOptions",
    "LanczosResult",
    "LanczosState",
    "LinearOperator",
    "OperatorError",
    "ProductIndices",
    "Slice",
    "SymBSRMatrix",
    "SymCSRMatrix",
    "TensorKroneckerProduct",
    "TensorSVDResult",
    "ThickRestartLanczosEigenSolver",
    "ThickRestartOptions",
    "UNLIMITED",
    "accelerate",
    "aslinearoperator",
    "block_tensor_norm",
    "block_tensor_squared_norm",
    "bsr_from_coo_arrays",
    "bsr_from_dense",
    "cg_solve",
    "cgls_solve",
    "cgs2",
    "chebyshev_bandpass_apply",
    "chebyshev_filter_apply",
    "chebyshev_moments",
    "complex_from_real",
    "contract",
    "contract_vector_as_diagonal",
    "coo_from_dense",
    "coo_identity",
    "csr_from_coo",
    "csr_from_dense",
    "dedup_doubled_eigenvalues",
    "default_tolerance",
    "dense_expmv",
    "dtensor",
    "eigenvalue_count",
    "eigs",
    "eigs_realified",
    "eigsh",
    "eigsh_range",
    "eigsh_window",
    "einsum",
    "expm_multiply",
    "general_inverse_iteration_refine",
    "general_rayleigh_refine",
    "gmres_solve",
    "gmres_solve_jit",
    "gram_operator",
    "gram_schmidt",
    "heisenberg_block_hamiltonian",
    "heisenberg_ground_state",
    "heisenberg_sector_coo",
    "identity_operator",
    "init_lanczos_state",
    "inverse_iteration_refine",
    "jacobi_preconditioner",
    "lanczos_expmv",
    "lanczos_function_apply",
    "lanczos_steps",
    "load_matrix_market",
    "load_state",
    "lobpcg",
    "minres_solve",
    "orthogonal_complement",
    "project_out",
    "random_hermitian",
    "random_matrix",
    "random_normal",
    "random_orthogonal",
    "random_tensor",
    "random_uniform",
    "random_vector",
    "rayleigh_refine",
    "real_from_complex",
    "realify_coo",
    "save_matrix_market",
    "save_state",
    "shard_state",
    "shift_invert_operator",
    "shift_invert_operator_general",
    "spectral_density",
    "svds",
    "sym_bsr_from_bsr",
    "taylor_expmv",
    "taylor_expmv_auto",
    "tensor_kronecker_product",
    "tensor_svd",
    "transform_tensor_with_matrix",
    "tridiagonal_operator",
    "tridiagonal_shift_invert_operator",
    "truncated_svd_via_lanczos",
    "truncated_tensor_svd",
    "zerowisely_resized",
]
