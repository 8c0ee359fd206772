"""The public names of the ops modules, re-exported as ``eigenex_tpu/ops/__init__.py``
re-exports its own."""

from .einsum import contract, einsum, einsum_labels
from .kron import TensorKroneckerProduct, tensor_kronecker_product
from .orthogonalize import (
    cgs2,
    gram_schmidt,
    orthogonal_complement,
    orthonormal_columns,
    project_coefficients,
    project_out,
)
from .tensor_svd import TensorSVDResult, tensor_svd, truncated_tensor_svd
from .tensor_util import (
    contract_vector_as_diagonal,
    transform_tensor_with_matrix,
    zerowisely_resized,
)
