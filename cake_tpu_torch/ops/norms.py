"""RMS norms with float32 accumulation, cast back to the input dtype
(counterpart of cake_tpu/ops/norms.py: rms_norm, rms_norm_gated)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rms_norm_gated(x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6, activation: str = "silu") -> torch.Tensor:
    """rms_norm(x) * act(gate), the Gated DeltaNet's output norm (the
    reference's rms_norm_gated; its weight is used as stored, never 1 + w)."""
    y = rms_norm(x, weight, eps)
    gf = gate.float()
    if activation == "silu":
        g = gf * torch.sigmoid(gf)
    elif activation == "sigmoid":
        g = torch.sigmoid(gf)
    else:
        raise ValueError(f"unknown gate activation {activation}")
    return (y.float() * g).to(x.dtype)
