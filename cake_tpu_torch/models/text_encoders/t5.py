"""T5 encoder: T5-XXL gives FLUX.1 its sequence conditioning (counterpart
of cake_tpu/models/text_encoders/t5.py: T5Config, tiny_t5_config,
init_t5_params, relative_position_buckets, t5_encode, t5_mapping).

HF T5EncoderModel semantics: a shared token embedding, pre-RMSNorm
blocks, a relative-position-bucket attention bias (learned in block 0,
shared by every block), UNscaled scores (T5 folds 1/sqrt(d) into its
init), a gated GELU feed-forward (gelu(wi_0 x) * wi_1 x -> wo) and a final
RMSNorm.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.linear import linear
from ...ops.norms import rms_norm
from ...utils.init import generator, normal


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    num_layers: int = 24
    num_heads: int = 64
    d_kv: int = 64
    d_ff: int = 10240
    relative_buckets: int = 32
    relative_max_distance: int = 128
    layer_norm_eps: float = 1e-6


def tiny_t5_config() -> T5Config:
    return T5Config(vocab_size=96, d_model=32, num_layers=2, num_heads=2,
                    d_kv=8, d_ff=64, relative_buckets=8,
                    relative_max_distance=16)


def init_t5_params(cfg: T5Config, seed: int = 0, dtype=torch.float32,
                   device="cpu") -> dict:
    gen = generator(seed, device)
    h, inner = cfg.d_model, cfg.num_heads * cfg.d_kv

    def w(dout, din):
        return {"weight": normal(gen, (dout, din), dtype, device)}

    def norm():
        return {"weight": torch.ones((h,), dtype=dtype, device=device)}
    p: dict = {
        "shared": {"weight": normal(gen, (cfg.vocab_size, h), dtype,
                                    device)},
        "rel_bias": {"weight": normal(gen, (cfg.relative_buckets,
                                            cfg.num_heads), dtype, device)},
        "blocks": [],
        "final_layer_norm": norm(),
    }
    for _ in range(cfg.num_layers):
        p["blocks"].append({
            "attn_norm": norm(),
            "q": w(inner, h), "k": w(inner, h), "v": w(inner, h),
            "o": w(h, inner),
            "ffn_norm": norm(),
            "wi_0": w(cfg.d_ff, h), "wi_1": w(cfg.d_ff, h),
            "wo": w(h, cfg.d_ff)})
    return p


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5's bidirectional relative-position buckets [q, k] (host-side):
    half the buckets per direction, exact below half of that, then
    logarithmic up to max_distance (the float bucket truncated toward
    zero, as the reference's astype)."""
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    rel = mem - ctx
    half = num_buckets // 2
    out = np.where(rel > 0, half, 0)
    n = np.abs(rel)
    max_exact = half // 2
    is_small = n < max_exact
    log_big = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact) * (half - max_exact)
    ).astype(np.int64)
    log_big = np.minimum(log_big, half - 1)
    return out + np.where(is_small, n, log_big)


def _attn(cfg: T5Config, p, x, bias):
    b, s, _ = x.shape
    hd, dk = cfg.num_heads, cfg.d_kv
    q = linear(x, p["q"]["weight"]).reshape(b, s, hd, dk)
    k = linear(x, p["k"]["weight"]).reshape(b, s, hd, dk)
    v = linear(x, p["v"]["weight"]).reshape(b, s, hd, dk)
    # no 1/sqrt(d): T5 folds it into the weights
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, hd * dk)
    return linear(out, p["o"]["weight"])


def t5_encode(cfg: T5Config, params: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids: [B, S] integer -> hidden states [B, S, d_model]."""
    s = ids.shape[1]
    x = params["shared"]["weight"][ids]
    buckets = torch.from_numpy(relative_position_buckets(
        s, s, cfg.relative_buckets, cfg.relative_max_distance)).to(x.device)
    # [q, k, H] -> [1, H, q, k] in float32, the score accumulator's type
    bias = params["rel_bias"]["weight"][buckets].float()
    bias = bias.permute(2, 0, 1)[None]
    eps = cfg.layer_norm_eps
    for bp in params["blocks"]:
        h = rms_norm(x, bp["attn_norm"]["weight"], eps)
        x = x + _attn(cfg, bp, h, bias)
        h = rms_norm(x, bp["ffn_norm"]["weight"], eps)
        h = F.gelu(linear(h, bp["wi_0"]["weight"]), approximate="tanh") \
            * linear(h, bp["wi_1"]["weight"])
        x = x + linear(h, bp["wo"]["weight"])
    return rms_norm(x, params["final_layer_norm"]["weight"], eps)


def t5_mapping(cfg: T5Config, prefix: str = "") -> dict:
    """parameter path -> HF T5EncoderModel tensor name."""
    m = {
        "shared.weight": f"{prefix}shared.weight",
        "rel_bias.weight": f"{prefix}encoder.block.0.layer.0.SelfAttention."
                           f"relative_attention_bias.weight",
        "final_layer_norm.weight": f"{prefix}encoder.final_layer_norm.weight",
    }
    for i in range(cfg.num_layers):
        src = f"{prefix}encoder.block.{i}.layer."
        dst = f"blocks.{i}."
        m[f"{dst}attn_norm.weight"] = f"{src}0.layer_norm.weight"
        for proj in ("q", "k", "v", "o"):
            m[f"{dst}{proj}.weight"] = f"{src}0.SelfAttention.{proj}.weight"
        m[f"{dst}ffn_norm.weight"] = f"{src}1.layer_norm.weight"
        for fc in ("wi_0", "wi_1", "wo"):
            m[f"{dst}{fc}.weight"] = f"{src}1.DenseReluDense.{fc}.weight"
    return m
