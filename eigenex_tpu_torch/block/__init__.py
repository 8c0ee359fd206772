from .block_tensor import (
    BlockTensor,
    block_einsum,
    block_tensor_norm,
    block_tensor_squared_norm,
)
