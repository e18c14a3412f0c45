"""Linear / embedding primitives (counterpart of cake_tpu/ops/linear.py:
resolve_weight, linear, embedding). Weights follow the HF convention
[out_features, in_features]; the product goes to cuBLAS as cake_tpu's
einsum went to XLA. A weight may be a native FP8 pair {"fp8", "scale_inv"}
(`--fp8-native`): it is dequantized to the activations' dtype by the
dequant kernel (ops/fp8.py) right before the product, so device memory
holds 1 byte per parameter between steps."""
from __future__ import annotations

import torch

from .fp8 import dequant_fp8_blockwise, is_fp8


def resolve_weight(weight, dtype: torch.dtype) -> torch.Tensor:
    """A plain weight as it is; a native FP8 pair dequantized to dtype."""
    if is_fp8(weight):
        return dequant_fp8_blockwise(weight["fp8"], weight["scale_inv"],
                                     dtype)
    return weight


def linear(x: torch.Tensor, weight, bias: torch.Tensor | None = None
           ) -> torch.Tensor:
    """y = x @ W^T (+ b). x: [..., in], weight: [out, in] (or a native
    FP8 pair)."""
    y = torch.matmul(x, resolve_weight(weight, x.dtype).t())
    if bias is not None:
        y = y + bias
    return y


def embedding(token_ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table: [vocab, hidden]; token_ids: integer [...]."""
    return table[token_ids]
