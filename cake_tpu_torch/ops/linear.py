"""Linear / embedding primitives. Weights follow the HF convention
[out_features, in_features]; the product goes to cuBLAS as
cake_tpu's einsum went to XLA."""
from __future__ import annotations

import torch


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ W^T (+ b). x: [..., in], weight: [out, in]."""
    y = torch.matmul(x, weight.t())
    if bias is not None:
        y = y + bias
    return y


def embedding(token_ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table: [vocab, hidden]; token_ids: integer [...]."""
    return table[token_ids]
