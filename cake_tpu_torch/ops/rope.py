"""Rotary position embeddings (counterpart of cake_tpu/ops/rope.py).

The cos/sin tables are computed once per model in float64 numpy, exactly
as the reference does, then stored in float32 on the model's device and
gathered by position inside the forward.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """llama3-style frequency scaling."""
    factor: float = 8.0
    high_freq_factor: float = 4.0
    low_freq_factor: float = 1.0
    original_max_position_embeddings: int = 8192
    rope_type: str | None = None


def inv_frequencies(rotary_dim: int, theta: float,
                    scaling: RopeScaling | None = None) -> np.ndarray:
    """Per-pair inverse frequencies, with optional llama3 smoothing."""
    inv = 1.0 / (theta ** (np.arange(0, rotary_dim, 2, dtype=np.float64)
                           / rotary_dim))
    if scaling is None or not scaling.factor or scaling.factor == 1.0:
        return inv
    if scaling.rope_type == "linear":
        inv = inv / scaling.factor
    elif scaling.rope_type == "default":
        pass
    elif scaling.rope_type in (None, "llama3"):
        orig = scaling.original_max_position_embeddings
        low_wavelen = orig / scaling.low_freq_factor
        high_wavelen = orig / scaling.high_freq_factor
        wavelen = 2.0 * np.pi / inv
        scaled = np.where(wavelen > low_wavelen, inv / scaling.factor, inv)
        smooth = (orig / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor)
        mid = (1.0 - smooth) * inv / scaling.factor + smooth * inv
        is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv = np.where(is_mid, mid, scaled)
    else:
        logging.getLogger(__name__).warning(
            "rope_type %r not implemented; using unscaled RoPE",
            scaling.rope_type)
    return inv


def rope_tables(max_seq_len: int, rotary_dim: int, theta: float,
                scaling: RopeScaling | None = None,
                device: str | torch.device = "cpu",
                dtype: torch.dtype = torch.float32):
    """(cos, sin), each [max_seq_len, rotary_dim // 2]."""
    inv = inv_frequencies(rotary_dim, theta, scaling)
    freqs = np.outer(np.arange(max_seq_len, dtype=np.float64), inv)
    return (torch.as_tensor(np.cos(freqs), dtype=dtype, device=device),
            torch.as_tensor(np.sin(freqs), dtype=dtype, device=device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor,
               rotary_dim: int | None = None) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] or [S] integer. A rotary_dim
    below D rotates the first rotary_dim channels and passes the rest
    through (half-split layout, as the reference's default)."""
    d = x.shape[-1]
    rd = d if rotary_dim is None else rotary_dim
    if positions.dim() == 1:
        positions = positions[None, :]
    c = cos[positions][:, :, None, :]                   # [B, S, 1, rd/2]
    s = sin[positions][:, :, None, :]
    xf = x[..., :rd].float()
    half = rd // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
    if rd == d:
        return out
    return torch.cat([out, x[..., rd:]], dim=-1)
