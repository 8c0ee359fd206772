"""The port stands alone: no source of ``eigenex_tpu_torch`` nor
``chip_smoke.py`` imports ``jax``, ``ml_dtypes`` or the JAX package, and
importing the port needs neither CUDA nor ``triton`` nor ``nvcc``, and
compiles nothing (the native host builders are built at their first use,
into the port's own build directory).
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "eigenex_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "eigenex_tpu", "flax", "optax")
EXPECTED_MODULES = [
    "__init__.py", "convert.py", "core/operators.py", "ops/cuda_spmv.py",
    "ops/orthogonalize.py", "solvers/api.py", "solvers/arnoldi.py", "solvers/lanczos.py",
    "solvers/restart.py", "solvers/block_lanczos.py", "solvers/chebyshev.py", "solvers/kpm.py",
    "solvers/lobpcg.py", "solvers/precond.py", "solvers/krylov_schur.py", "solvers/cg.py",
    "solvers/gmres.py", "solvers/refine.py", "sparse/accelerate.py", "sparse/bsr.py", "sparse/coo.py",
    "sparse/realify.py", "sparse/sym_bsr.py", "utils/exceptions.py", "utils/prng.py",
    "utils/tolerance.py", "utils/trace.py", "utils/precision.py", "solvers/direct.py",
    "solvers/functions.py", "ops/tensor_util.py", "ops/tensor_svd.py", "ops/sparse_svd.py",
    "core/indices.py", "core/dtensor.py", "ops/einsum.py", "ops/kron.py", "ops/rotations.py",
    "sparse/csr.py", "sparse/io.py", "block/block_tensor.py", "block/operator.py",
    "block/hamiltonians.py", "native/__init__.py", "utils/checkpoint.py",
    "utils/profiling.py", "utils/benchtime.py",
    "parallel/__init__.py", "parallel/mesh.py", "parallel/shard_map.py", "parallel/distributed.py",
    "parallel/multiproc.py", "samples/__init__.py", "samples/_cli.py",
    *(f"samples/sample_{name}.py" for name in (
        "accelerate", "arnoldi", "block_tensor", "dtensor", "lanczos1", "lanczos2", "lobpcg",
        "matrix_market", "product_indices", "spectrum_slicing", "tebd_ising", "tfi",
        "tpu_hybrid")),
]


def imported_modules(path):
    """(module name, relative level, line) of every import statement, at
    any depth -- imports inside functions count too."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, 0, node.lineno
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level, node.lineno


def test_the_slice_has_its_modules():
    have = {str(p.relative_to(PACKAGE)) for p in SOURCES if p.is_relative_to(PACKAGE)}
    assert set(EXPECTED_MODULES) <= have
    assert {p.name for p in (PACKAGE / "csrc").iterdir()} >= {
        "bsr_spmv.cu", "sym_bsr_spmv.cu", "spmv_common.cuh",
        "bsr_spmm.cu", "sym_bsr_spmm.cu", "spmm_common.cuh", "tridiag_solve.cu"}
    assert (PACKAGE / "native" / "src" / "builders.cpp").is_file()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    for name, level, line in imported_modules(path):
        if level:  # relative import: stays inside eigenex_tpu_torch
            continue
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name}:{line} imports {name}"
    text = path.read_text()
    for dynamic in ("import_module(", "__import__("):
        assert dynamic not in text, f"{path.name} imports dynamically"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_triton_is_never_imported_at_module_level(path):
    tree = ast.parse(path.read_text())
    for node in tree.body:  # top-level statements only
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        assert all(n.split(".")[0] != "triton" for n in names)


def test_kernel_sources_keep_torch_headers_out():
    """No PyTorch headers, and no floating-point atomics (deterministic sums):
    the only atomic is the integer ticket of the symmetric SpMV kernel's
    units, declared ``int*``."""
    import re

    for src in (PACKAGE / "csrc").iterdir():
        text = src.read_text()
        assert "torch/extension.h" not in text and "ATen" not in text
        assert not re.search(r"\b(red|atom)\.\S*f(16|32|64)", text)  # no float atomics in PTX
        for target in re.findall(r"\batomic\w*\(\s*([A-Za-z_]\w*)", text):
            assert target == "ticket", (src.name, target)
            assert re.search(rf"\bint\*\s*{target}\b", text), (src.name, target)


def test_importing_the_port_is_light():
    """In a fresh interpreter: no jax, no triton, no CUDA context, no build,
    and no nvcc on the PATH is needed."""
    code = (
        "import sys, os\n"
        "os.environ['PATH'] = ''\n"
        "import eigenex_tpu_torch as ext\n"
        "import eigenex_tpu_torch.ops.cuda_spmv as k\n"
        "import eigenex_tpu_torch.convert\n"
        "from eigenex_tpu_torch.solvers import block_lanczos, chebyshev, kpm, lobpcg, precond\n"
        "from eigenex_tpu_torch.solvers import cg, gmres, krylov_schur, refine\n"
        "from eigenex_tpu_torch.sparse import realify\n"
        "from eigenex_tpu_torch.solvers import direct, functions\n"
        "from eigenex_tpu_torch.ops import sparse_svd, tensor_svd, tensor_util\n"
        "from eigenex_tpu_torch.utils import precision\n"
        "from eigenex_tpu_torch.core import indices, dtensor\n"
        "from eigenex_tpu_torch.ops import einsum, kron, rotations\n"
        "from eigenex_tpu_torch.sparse import csr, io\n"
        "from eigenex_tpu_torch.block import block_tensor, operator, hamiltonians\n"
        "from eigenex_tpu_torch import native\n"
        "from eigenex_tpu_torch.utils import benchtime, checkpoint, profiling\n"
        "from eigenex_tpu_torch.parallel import distributed, mesh, multiproc, shard_map\n"
        "from eigenex_tpu_torch import samples\n"
        "assert 'NATIVE' not in vars(native) and not native.native_calls()\n"
        "assert native.BUILD_DIR == native.BUILD_DIR.parent.parent / 'eigenex_tpu_torch' / 'build'\n"
        "import torch\n"
        "bad = [m for m in ('jax', 'jaxlib', 'ml_dtypes', 'triton', 'eigenex_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not k._libs and not any(k.launch_counts().values())\n"
        "assert callable(ext.eigsh) and callable(ext.accelerate)\n"
        "assert callable(ext.lobpcg) and callable(ext.eigsh_window) and callable(ext.eigsh_range)\n"
        "assert callable(ext.eigs) and callable(ext.gmres_solve) and callable(ext.minres_solve)\n"
        "assert 'scipy' not in sys.modules\n"
        "assert set(k.KERNEL_SOURCES) == {'bsr_spmv', 'sym_bsr_spmv', 'bsr_spmm', 'sym_bsr_spmm'}\n"
        "assert set(k.LIBRARY_SOURCES) == {'tridiag_solve'} and not direct._lib\n"
        "assert callable(ext.svds) and callable(ext.expm_multiply)\n"
        "assert callable(ext.tridiagonal_shift_invert_operator)\n"
        "assert callable(ext.truncated_svd_via_lanczos) and callable(ext.tensor_svd)\n"
        "assert callable(ext.einsum) and callable(ext.load_matrix_market)\n"
        "assert callable(ext.heisenberg_block_hamiltonian) and callable(ext.BlockTensor)\n"
        "assert callable(ext.make_mesh) and callable(shard_map.shard_map)\n"
        "assert callable(ext.DistributedThickRestartLanczosEigenSolver)\n"
        "print('light')\n"
    )
    build = PACKAGE / "build"
    before = sorted(build.iterdir()) if build.exists() else None
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "light"
    assert (sorted(build.iterdir()) if build.exists() else None) == before  # built nothing


def test_chip_smoke_refuses_to_run_without_a_card():
    """On a machine without CUDA the script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the script would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
