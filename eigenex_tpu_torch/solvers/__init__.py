"""The public names of the solvers modules, re-exported as ``eigenex_tpu/solvers/__init__.py``
re-exports its own."""

from .arnoldi import (
    ArnoldiEigenSolver,
    ArnoldiOptions,
    ArnoldiResult,
    ArnoldiState,
    arnoldi_steps,
    init_arnoldi_state,
)
from .functions import (
    LanczosExponentialSolver,
    LanczosFunctionSolver,
    dense_expmv,
    expm_multiply,
    lanczos_expmv,
    lanczos_function_apply,
    taylor_expmv,
    taylor_expmv_auto,
)
from .cg import cg_solve, cgls_solve, minres_solve, shift_invert_operator
from .chebyshev import (
    ChebyshevFilterOptions,
    ChebyshevFilterSolver,
    chebyshev_bandpass_apply,
    chebyshev_filter_apply,
    eigsh_window,
)
from .kpm import (
    chebyshev_moments,
    eigenvalue_count,
    eigsh_range,
    spectral_density,
)
from .lobpcg import LOBPCGOptions, LOBPCGSolver, lobpcg
from .precond import jacobi_preconditioner
from .restart import ThickRestartLanczosEigenSolver, ThickRestartOptions
from .lanczos import (
    UNLIMITED,
    LanczosEigenSolver,
    LanczosOptions,
    LanczosResult,
    LanczosState,
    init_lanczos_state,
    lanczos_steps,
    tridiagonal_eigh,
)
