"""The MMDiT flow-matching transformer of FLUX.1 (counterpart of
cake_tpu/models/image/mmdit.py: MMDiTConfig, timestep_embedding, rope_2d,
apply_rope_interleaved, init_mmdit_params, double_block, single_block,
mmdit_forward, make_img_ids, make_txt_ids).

  * image and text input projections; sinusoidal timestep, pooled-vector
    and (FLUX.1-dev) guidance MLP embedders summed into one vector;
  * double-stream blocks: image and text streams, each with its own
    AdaLN modulation, attending JOINTLY over the concatenated sequence
    (text first);
  * single-stream blocks: one stream, the qkv and MLP-in projections
    fused into one matmul;
  * a final AdaLN and a linear back to patch channels;
  * 2-D rotary embeddings over (t, y, x) ids, interleaved pairs.

Every linear goes through ops/linear.py, so a native FP8 weight
{"fp8", "scale_inv"} is dequantized by the hand-written kernel
(csrc/fp8_dequant.cu) right before its product: per denoising step ten
launches per double-stream block, three per single-stream block and ten
for the embedders and the final layer when they are FP8 too (314 at
FLUX.1-dev's 19 + 38 blocks).

The joint attention is the reference's, not a fused kernel: scores
accumulated in float32 (q and k taken to float32, so each product is
exact), softmax in float32, probabilities cast to the value dtype, then
the product. At 1024 x 1024 a block's scores are [1, 24, 4608, 4608] in
float32 (2.04 GB); they are freed as soon as the probabilities exist.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.activations import adaln_modulate
from ...ops.linear import linear
from ...ops.norms import rms_norm
from ...utils.init import fp8_normal, generator, normal


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 64            # patched latent channels (16 x 2 x 2)
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    mlp_ratio: float = 4.0
    depth_double: int = 19
    depth_single: int = 38
    txt_dim: int = 4096              # context width (T5)
    vec_dim: int = 768               # pooled vector width (CLIP)
    guidance_embed: bool = True      # FLUX.1-dev
    axes_dims: tuple[int, ...] = (16, 56, 56)   # rope dims per (t, y, x)
    theta: float = 10000.0


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       scale: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos first; t in [0, 1] scaled by 1000 (FLUX's
    convention)."""
    t = t * scale
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_2d(ids: torch.Tensor, axes_dims, theta: float):
    """ids: [B, S, n_axes] integer positions -> (cos, sin) [B, S, sum/2],
    each axis's rotary frequencies concatenated (FLUX's EmbedND)."""
    outs_c, outs_s = [], []
    for i, d in enumerate(axes_dims):
        pos = ids[..., i].float()
        freqs = 1.0 / (theta ** (torch.arange(
            0, d, 2, dtype=torch.float32, device=ids.device) / d))
        ang = pos[..., None] * freqs
        outs_c.append(torch.cos(ang))
        outs_s.append(torch.sin(ang))
    return torch.cat(outs_c, -1), torch.cat(outs_s, -1)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos, sin: [B, S, D/2]; pairs (2i, 2i + 1)."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    o1 = x1 * c - x2 * s
    o2 = x1 * s + x2 * c
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def init_mmdit_params(cfg: MMDiTConfig, seed: int = 0, dtype=torch.bfloat16,
                      device="cpu", fp8_native: bool = False) -> dict:
    """Seeded weights (N(0, 0.02^2), zero biases, unit norms). fp8_native:
    every 2-D weight a native FP8 pair with one per-tensor scale
    (utils/init.py: fp8_normal), as a scaled-FP8 checkpoint loads with
    --fp8-native."""
    gen = generator(seed, device)
    h = cfg.hidden_size
    mlp = int(h * cfg.mlp_ratio)
    attn = cfg.num_heads * cfg.head_dim

    def lin(dout, din):
        w = fp8_normal(gen, (dout, din), device) if fp8_native \
            else normal(gen, (dout, din), dtype, device)
        return {"weight": w,
                "bias": torch.zeros((dout,), dtype=dtype, device=device)}

    def mlp_p(din, dout):
        return {"in": lin(dout, din), "out": lin(dout, dout)}

    def norm():
        return {"weight": torch.ones((cfg.head_dim,), dtype=dtype,
                                     device=device)}
    p: dict = {
        "img_in": lin(h, cfg.in_channels), "txt_in": lin(h, cfg.txt_dim),
        "time_mlp": mlp_p(256, h), "vec_mlp": mlp_p(cfg.vec_dim, h),
        "final_mod": lin(2 * h, h), "final_out": lin(cfg.in_channels, h),
    }
    if cfg.guidance_embed:
        p["guidance_mlp"] = mlp_p(256, h)

    def stream():
        return {"mod": lin(6 * h, h), "qkv": lin(3 * attn, h),
                "q_norm": norm(), "k_norm": norm(), "proj": lin(h, attn),
                "mlp_in": lin(mlp, h), "mlp_out": lin(h, mlp)}
    p["double"] = [{"img": stream(), "txt": stream()}
                   for _ in range(cfg.depth_double)]
    p["single"] = [{"mod": lin(3 * h, h), "linear1": lin(3 * attn + mlp, h),
                    "linear2": lin(h, attn + mlp), "q_norm": norm(),
                    "k_norm": norm()} for _ in range(cfg.depth_single)]
    return p


def _lin(p, x):
    return linear(x, p["weight"], p["bias"])


def _mlp_fwd(p, x):
    return _lin(p["out"], F.silu(_lin(p["in"], x)))


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free layer norm (FLUX's elementwise_affine=False)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _joint_attention(cfg, q, k, v, cos, sin):
    q = apply_rope_interleaved(q, cos, sin)
    k = apply_rope_interleaved(k, cos, sin)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    del q, k
    scores.div_(cfg.head_dim ** 0.5)
    probs = torch.softmax(scores, dim=-1)
    del scores
    probs = probs.to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _qkv(cfg, p, x):
    b, s, _ = x.shape
    qkv = _lin(p["qkv"], x).reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = rms_norm(q, p["q_norm"]["weight"], 1e-6)
    k = rms_norm(k, p["k_norm"]["weight"], 1e-6)
    return q, k, v


def double_block(cfg, p, img, txt, vec, cos, sin):
    """Separately modulated streams, joint attention (text first)."""
    b = img.shape[0]
    svec = F.silu(vec)
    img_mod = _lin(p["img"]["mod"], svec).reshape(b, 1, 6, -1)
    txt_mod = _lin(p["txt"]["mod"], svec).reshape(b, 1, 6, -1)
    img_h = adaln_modulate(_ln(img), img_mod[:, :, 0], img_mod[:, :, 1])
    txt_h = adaln_modulate(_ln(txt), txt_mod[:, :, 0], txt_mod[:, :, 1])
    qi, ki, vi = _qkv(cfg, p["img"], img_h)
    qt, kt, vt = _qkv(cfg, p["txt"], txt_h)
    st = txt.shape[1]
    attn = _joint_attention(cfg, torch.cat([qt, qi], 1),
                            torch.cat([kt, ki], 1), torch.cat([vt, vi], 1),
                            cos, sin)
    attn = attn.reshape(b, attn.shape[1], -1)
    attn_t, attn_i = attn[:, :st], attn[:, st:]
    img = img + img_mod[:, :, 2] * _lin(p["img"]["proj"], attn_i)
    txt = txt + txt_mod[:, :, 2] * _lin(p["txt"]["proj"], attn_t)
    img_h = adaln_modulate(_ln(img), img_mod[:, :, 3], img_mod[:, :, 4])
    img = img + img_mod[:, :, 5] * _lin(
        p["img"]["mlp_out"], _gelu(_lin(p["img"]["mlp_in"], img_h)))
    txt_h = adaln_modulate(_ln(txt), txt_mod[:, :, 3], txt_mod[:, :, 4])
    txt = txt + txt_mod[:, :, 5] * _lin(
        p["txt"]["mlp_out"], _gelu(_lin(p["txt"]["mlp_in"], txt_h)))
    return img, txt


def single_block(cfg, p, x, vec, cos, sin):
    b, s, _ = x.shape
    qkv_dim = 3 * cfg.num_heads * cfg.head_dim
    mod = _lin(p["mod"], F.silu(vec)).reshape(b, 1, 3, -1)
    xh = adaln_modulate(_ln(x), mod[:, :, 0], mod[:, :, 1])
    both = _lin(p["linear1"], xh)
    qkv, mlp_h = both[..., :qkv_dim], both[..., qkv_dim:]
    qkv = qkv.reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = rms_norm(q, p["q_norm"]["weight"], 1e-6)
    k = rms_norm(k, p["k_norm"]["weight"], 1e-6)
    attn = _joint_attention(cfg, q, k, v, cos, sin).reshape(b, s, -1)
    merged = torch.cat([attn, _gelu(mlp_h)], dim=-1)
    return x + mod[:, :, 2] * _lin(p["linear2"], merged)


def mmdit_forward(cfg: MMDiTConfig, params: dict, img, img_ids, txt, txt_ids,
                  t, vec, guidance=None):
    """img: [B, S_img, in_ch] patched latents; txt: [B, S_txt, txt_dim];
    t: [B] in [0, 1]; vec: [B, vec_dim]; ids: [B, S, n_axes]. Returns the
    velocity [B, S_img, in_ch]."""
    emb = _mlp_fwd(params["time_mlp"],
                   timestep_embedding(t, 256).to(img.dtype))
    emb = emb + _mlp_fwd(params["vec_mlp"], vec)
    if cfg.guidance_embed and guidance is not None:
        emb = emb + _mlp_fwd(params["guidance_mlp"],
                             timestep_embedding(guidance, 256).to(img.dtype))
    vec_emb = emb[:, None, :]
    img_h = _lin(params["img_in"], img)
    txt_h = _lin(params["txt_in"], txt)
    cos, sin = rope_2d(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dims,
                       cfg.theta)
    for blk in params["double"]:
        img_h, txt_h = double_block(cfg, blk, img_h, txt_h, vec_emb, cos, sin)
    x = torch.cat([txt_h, img_h], dim=1)
    for blk in params["single"]:
        x = single_block(cfg, blk, x, vec_emb, cos, sin)
    x = x[:, txt.shape[1]:]
    mod = _lin(params["final_mod"], F.silu(vec_emb))
    shift, scale = mod.chunk(2, dim=-1)
    x = adaln_modulate(_ln(x), shift, scale)
    return _lin(params["final_out"], x)


def make_img_ids(h_patches: int, w_patches: int, batch: int = 1,
                 device="cpu") -> torch.Tensor:
    ys, xs = np.meshgrid(np.arange(h_patches), np.arange(w_patches),
                         indexing="ij")
    ids = np.stack([np.zeros_like(ys), ys, xs], axis=-1).reshape(-1, 3)
    ids = np.broadcast_to(ids[None], (batch, ids.shape[0], 3))
    return torch.from_numpy(ids.copy()).to(device)


def make_txt_ids(seq_len: int, batch: int = 1, device="cpu") -> torch.Tensor:
    return torch.zeros((batch, seq_len, 3), dtype=torch.int32, device=device)
