"""Gated MLP activations and the DiT modulation (counterpart of
cake_tpu/ops/activations.py: silu_mul, gelu_mul, adaln_modulate)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up — the SwiGLU elementwise."""
    return F.silu(gate) * up


def gelu_mul(gate: torch.Tensor, up: torch.Tensor,
             approximate: bool = True) -> torch.Tensor:
    """gelu(gate) * up — GEGLU (tanh approximation by default)."""
    return F.gelu(gate, approximate="tanh" if approximate else "none") * up


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Adaptive layer-norm modulation of DiT blocks: x * (1 + scale) +
    shift."""
    return x * (1.0 + scale) + shift
