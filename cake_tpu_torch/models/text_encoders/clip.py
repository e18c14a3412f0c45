"""CLIP text encoder: CLIP-L/14 gives FLUX.1 its pooled vector
(counterpart of cake_tpu/models/text_encoders/clip.py: CLIPTextConfig,
tiny_clip_config, init_clip_params, clip_text_forward, clip_mapping).

HF CLIPTextModel semantics: learned token and position embeddings,
pre-LN blocks under a causal mask, quick-GELU MLPs, a final layer norm;
the pooled output is the final hidden state at the FIRST end-of-text
token (HF takes the argmax of the ids, EOT being CLIP's largest id).
Scores are accumulated in float32 and the probabilities cast to the value
dtype, as the reference does.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...ops.linear import linear
from ...ops.norms import layer_norm
from ...utils.init import generator, normal


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    eot_token_id: int = 49407
    # OpenAI CLIP-L uses quick_gelu; OpenCLIP encoders use exact gelu
    hidden_act: str = "quick_gelu"
    # CLIPTextModelWithProjection: the pooled output through a bias-free
    # text_projection to this width
    projection_dim: int | None = None


def tiny_clip_config() -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=96, hidden_size=32, num_layers=2,
                          num_heads=2, intermediate_size=64, max_positions=16,
                          eot_token_id=95)


def init_clip_params(cfg: CLIPTextConfig, seed: int = 0,
                     dtype=torch.float32, device="cpu") -> dict:
    gen = generator(seed, device)
    h = cfg.hidden_size

    def lin(dout, din):
        return {"weight": normal(gen, (dout, din), dtype, device),
                "bias": torch.zeros((dout,), dtype=dtype, device=device)}

    def ln():
        return {"weight": torch.ones((h,), dtype=dtype, device=device),
                "bias": torch.zeros((h,), dtype=dtype, device=device)}
    p: dict = {
        "token_embedding": {"weight": normal(gen, (cfg.vocab_size, h), dtype,
                                             device)},
        "position_embedding": {"weight": normal(gen, (cfg.max_positions, h),
                                                dtype, device)},
        "layers": [],
        "final_layer_norm": ln(),
    }
    if cfg.projection_dim:
        p["text_projection"] = {"weight": normal(
            gen, (cfg.projection_dim, h), dtype, device)}
    for _ in range(cfg.num_layers):
        p["layers"].append({
            "layer_norm1": ln(), "q_proj": lin(h, h), "k_proj": lin(h, h),
            "v_proj": lin(h, h), "out_proj": lin(h, h),
            "layer_norm2": ln(), "fc1": lin(cfg.intermediate_size, h),
            "fc2": lin(h, cfg.intermediate_size)})
    return p


def _ln(x, p, eps):
    return layer_norm(x, p["weight"], p["bias"], eps)


def _attn(cfg: CLIPTextConfig, p, x, mask):
    b, s, h = x.shape
    d = h // cfg.num_heads
    q = linear(x, p["q_proj"]["weight"], p["q_proj"]["bias"])
    k = linear(x, p["k_proj"]["weight"], p["k_proj"]["bias"])
    v = linear(x, p["v_proj"]["weight"], p["v_proj"]["bias"])
    q = q.reshape(b, s, cfg.num_heads, d)
    k = k.reshape(b, s, cfg.num_heads, d)
    v = v.reshape(b, s, cfg.num_heads, d)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        / (d ** 0.5)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, h)
    return linear(out, p["out_proj"]["weight"], p["out_proj"]["bias"])


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def clip_text_forward(cfg: CLIPTextConfig, params: dict, ids: torch.Tensor):
    """ids: [B, S] integer (S <= max_positions). Returns (hidden [B, S, H],
    pooled [B, H or projection_dim], penultimate [B, S, H]): penultimate
    is the residual stream before the last layer, no final norm (HF
    hidden_states[-2])."""
    b, s = ids.shape
    if cfg.hidden_act == "quick_gelu":
        act = quick_gelu
    else:
        def act(x):
            return F.gelu(x)            # exact erf GELU
    x = params["token_embedding"]["weight"][ids]
    x = x + params["position_embedding"]["weight"][:s][None]
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    penult = x
    for lp in params["layers"]:
        penult = x
        h = _ln(x, lp["layer_norm1"], cfg.layer_norm_eps)
        x = x + _attn(cfg, lp, h, mask)
        h = _ln(x, lp["layer_norm2"], cfg.layer_norm_eps)
        h = act(linear(h, lp["fc1"]["weight"], lp["fc1"]["bias"]))
        x = x + linear(h, lp["fc2"]["weight"], lp["fc2"]["bias"])
    x = _ln(x, params["final_layer_norm"], cfg.layer_norm_eps)
    # the first EOT position: the largest of (S - pos) where ids == EOT
    rank = torch.arange(s, 0, -1, dtype=torch.int32, device=ids.device)
    eot = torch.where(ids == cfg.eot_token_id, rank, 0).argmax(dim=1)
    pooled = x[torch.arange(b, device=x.device), eot]
    if "text_projection" in params:
        pooled = linear(pooled, params["text_projection"]["weight"])
    return x, pooled, penult


def clip_mapping(cfg: CLIPTextConfig, prefix: str = "text_model.") -> dict:
    """parameter path -> HF CLIPTextModel tensor name (text_projection
    lives outside the text_model prefix)."""
    m = {
        "token_embedding.weight":
            f"{prefix}embeddings.token_embedding.weight",
        "position_embedding.weight":
            f"{prefix}embeddings.position_embedding.weight",
        "final_layer_norm.weight": f"{prefix}final_layer_norm.weight",
        "final_layer_norm.bias": f"{prefix}final_layer_norm.bias",
    }
    if cfg.projection_dim:
        m["text_projection.weight"] = "text_projection.weight"
    for i in range(cfg.num_layers):
        src = f"{prefix}encoder.layers.{i}."
        dst = f"layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            m[f"{dst}{ln}.weight"] = f"{src}{ln}.weight"
            m[f"{dst}{ln}.bias"] = f"{src}{ln}.bias"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m[f"{dst}{proj}.weight"] = f"{src}self_attn.{proj}.weight"
            m[f"{dst}{proj}.bias"] = f"{src}self_attn.{proj}.bias"
        for fc in ("fc1", "fc2"):
            m[f"{dst}{fc}.weight"] = f"{src}mlp.{fc}.weight"
            m[f"{dst}{fc}.bias"] = f"{src}mlp.{fc}.bias"
    return m
