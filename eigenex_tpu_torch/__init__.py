"""eigenex_tpu_torch -- the PyTorch/CUDA port of eigenex_tpu.

Krylov and block eigensolvers over block-sparse operators on torch
tensors, with hand-written CUDA kernels for the block-sparse matvec and
multi-vector product on an NVIDIA Hopper card.  The JAX package ``eigenex_tpu`` is the reference; a module
here sits at the same subpath as its counterpart there.

Importing this package imports ``torch`` and nothing else heavy: it
builds no kernel, imports no ``triton`` and touches no CUDA device.  The
kernels are compiled with ``nvcc`` at their first launch.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .core.operators import LinearOperator, aslinearoperator, identity_operator
from .solvers.api import eigsh
from .solvers.block_lanczos import BlockLanczosEigenSolver, BlockLanczosOptions
from .solvers.chebyshev import (
    ChebyshevFilterOptions,
    ChebyshevFilterSolver,
    chebyshev_bandpass_apply,
    chebyshev_filter_apply,
    eigsh_window,
)
from .solvers.kpm import chebyshev_moments, eigenvalue_count, eigsh_range, spectral_density
from .solvers.lanczos import LanczosEigenSolver, LanczosOptions, LanczosResult
from .solvers.lobpcg import LOBPCGOptions, LOBPCGSolver, lobpcg
from .solvers.precond import jacobi_preconditioner
from .solvers.restart import ThickRestartLanczosEigenSolver, ThickRestartOptions
from .sparse.accelerate import AcceleratedOperator, accelerate
from .sparse.bsr import BSRMatrix, bsr_from_coo_arrays, bsr_from_dense
from .sparse.coo import COOBuilder, COOMatrix, coo_from_dense
from .sparse.sym_bsr import SymBSRMatrix, sym_bsr_from_bsr
from .utils.exceptions import EigenexError, LanczosError, OperatorError

__all__ = [
    "AcceleratedOperator",
    "BSRMatrix",
    "BlockLanczosEigenSolver",
    "BlockLanczosOptions",
    "COOBuilder",
    "COOMatrix",
    "ChebyshevFilterOptions",
    "ChebyshevFilterSolver",
    "EigenexError",
    "LOBPCGOptions",
    "LOBPCGSolver",
    "LanczosEigenSolver",
    "LanczosError",
    "LanczosOptions",
    "LanczosResult",
    "LinearOperator",
    "OperatorError",
    "SymBSRMatrix",
    "ThickRestartLanczosEigenSolver",
    "ThickRestartOptions",
    "accelerate",
    "aslinearoperator",
    "bsr_from_coo_arrays",
    "bsr_from_dense",
    "chebyshev_bandpass_apply",
    "chebyshev_filter_apply",
    "chebyshev_moments",
    "coo_from_dense",
    "eigenvalue_count",
    "eigsh",
    "eigsh_range",
    "eigsh_window",
    "identity_operator",
    "jacobi_preconditioner",
    "lobpcg",
    "spectral_density",
    "sym_bsr_from_bsr",
]
