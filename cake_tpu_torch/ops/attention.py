"""Grouped-query attention with position-based masks (counterpart of
cake_tpu/ops/attention.py), written with matmul and softmax as the
reference writes it with einsum. Activations stay in [B, S, H, D].
"""
from __future__ import annotations

import torch

NEG_INF = -1e30   # finite: an all-masked row stays NaN-free


def make_attention_mask(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                        window: int | None = None,
                        causal: bool = True) -> torch.Tensor:
    """Boolean attend-mask [B, Sq, Skv]. kv_positions holds -1 for empty
    cache entries; a key is visible iff q_pos - window < k_pos."""
    q = q_positions[:, :, None]
    k = kv_positions[:, None, :]
    mask = k >= 0
    if causal:
        mask = mask & (k <= q)
    if window is not None:
        mask = mask & (k > q - window)
    return mask


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """q: [B, Sq, Hq, D], k/v: [B, Skv, Hkv, D], Hq a multiple of Hkv.
    mask: bool [B, Sq, Skv] (True = attend) or None. Scores and softmax
    in float32; returns [B, Sq, Hq, D] in q's dtype."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).float()
    kf = k.permute(0, 2, 1, 3).float()[:, :, None]       # [B, Hkv, 1, T, D]
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale   # [B,Hkv,G,S,T]
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    vv = v.permute(0, 2, 1, 3)[:, :, None]               # [B, Hkv, 1, T, D]
    out = torch.matmul(probs, vv)                        # [B, Hkv, G, S, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def causal_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float | None = None) -> torch.Tensor:
    """Plain causal attention without a cache (B, S, H, D)."""
    b, s = q.shape[0], q.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    pos = pos[None, :].expand(b, s)
    return multi_head_attention(q, k, v, make_attention_mask(pos, pos), scale)
