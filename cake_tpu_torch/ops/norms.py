"""Norms with float32 accumulation, cast back to the input dtype
(counterpart of cake_tpu/ops/norms.py: rms_norm, rms_norm_gated,
layer_norm, group_norm)."""
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


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over [B, C, *spatial] (channels first)."""
    b, c = x.shape[:2]
    spatial = x.shape[2:]
    xf = x.float().reshape(b, num_groups, c // num_groups, -1)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, *spatial)
    wshape = (1, c) + (1,) * len(spatial)
    y = y * weight.float().reshape(wshape)
    if bias is not None:
        y = y + bias.float().reshape(wshape)
    return y.to(x.dtype)
