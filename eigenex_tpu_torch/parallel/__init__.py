"""The distributed layer: device meshes, ``shard_map`` and its collectives,
the row-partitioned SpMV modes, the 2-D panel grid and the distributed
Krylov drivers (counterpart of ``eigenex_tpu/parallel``)."""

from .distributed import (
    DistributedKrylovSchurArnoldiSolver,
    DistributedLanczosEigenSolver,
    DistributedLOBPCGSolver,
    DistributedShiftInvertLanczosEigenSolver,
    DistributedThickRestartLanczosEigenSolver,
    distributed_arnoldi_steps,
    distributed_lanczos_steps,
    halo_matmat,
    halo_matvec,
    mesh_operator,
    mesh_operator_2d,
    pad_bsr_for_mesh,
    pad_bsr_rect,
    place_on_mesh,
    split_bsr_grid,
    split_bsr_halo,
    split_sym_bsr_halo,
    sym_halo_matmat,
    sym_halo_matvec,
)
from .mesh import ROWS, Mesh, initialize_multihost, make_mesh, replicated_sharding, row_sharding
