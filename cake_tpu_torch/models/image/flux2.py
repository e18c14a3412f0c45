"""FLUX.2-klein text-to-image (counterpart of cake_tpu/models/image/flux2.py:
Flux2Config, Flux2PipelineConfig, tiny_flux2_config, init_flux2_params,
flux2_double_block, flux2_single_block, flux2_forward, make_img_ids4,
make_txt_ids4, empirical_mu, flux2_schedule, default_output_layers,
Flux2TextEncoder, DummyFlux2TextEncoder, Flux2ImageModel).

    model = Flux2ImageModel(tiny_flux2_config(), device="cuda")
    image = model.generate_image("a watercolor fox", 512, 512, steps=4)

What sets it apart from FLUX.1's MMDiT (mmdit.py, whose parameter-free
layer norm, joint attention, rope_2d and timestep embedding it reuses):
  * one modulation for every block, computed once from the timestep
    embedding (image and text [6h] for the double blocks, [3h] for the
    single ones); no pooled vector, no guidance embedding;
  * separate q/k/v/o projections per stream in the double blocks, a
    SiLU-gated MLP (one linear_in emitting gate || up); the single blocks
    fuse qkv || gate || up into one projection and project [attention ;
    silu(gate) * up] with one to_out;
  * no biases; per-head RMS QK-norm (eps 1e-6);
  * 4-axis RoPE (T, H, W, L), theta 2000: image tokens (0, y, x, 0), text
    tokens (0, 0, 0, i);
  * the context is three Qwen3 hidden states concatenated (after layers
    8, 17 and 26 of Qwen3-4B: 3 x 2560 = 7680).

The text encoder runs layers 0..max(captures) once, in order, each layer
with its own weights, and keeps the hidden state after each capture
layer. The reference's encoder calls its stateless forward_layers once per
capture segment with the whole parameter tree, whose stateless branch
counts layers from 0 inside the range: every segment after the first runs
the weights of layers 0, 1, 2, ... (ROADMAP §3). The port does not copy
that.

Noise comes from torch's generator and cannot equal jax.random's:
`denoise(noise=, text=)` takes the initial packed latent [1, S, in_ch]
and the context [1, S_txt, context_dim] from the caller, so parity tests
feed the reference's draws in. `negative_prompt` and `guidance` are
ignored, as the reference ignores them (klein is guidance-distilled).
The packed latents are denormalized with the VAE's BatchNorm statistics,
(x * sqrt(var + 1e-4) + mean), unpatchified and decoded by the VAE in its
own dtype (float32 from a checkpoint), the latent cast to it.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...ops.activations import adaln_modulate, silu_mul
from ...ops.diffusion import flow_matching_euler_step
from ...ops.linear import linear
from ...ops.norms import rms_norm
from ...utils.init import generator, normal
from ...utils.png import RgbImage
from ..common.config import ModelConfig
from ..common.layers import embed_tokens, forward_layers, make_rope
from .flux import to_image
from .mmdit import _joint_attention, _ln, rope_2d, timestep_embedding
from .vae import (VaeConfig, init_vae_decoder_params, patches_to_latents,
                  vae_decode)

log = logging.getLogger("cake_tpu_torch.flux2")


@dataclasses.dataclass(frozen=True)
class Flux2Config:
    """Transformer dims (klein-4B's by default)."""
    in_channels: int = 128           # packed latents: 32-ch VAE x 2x2
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    mlp_ratio: float = 3.0
    depth_double: int = 5
    depth_single: int = 20
    context_in_dim: int = 7680       # 3 concatenated Qwen3 hidden states
    axes_dims: tuple[int, ...] = (32, 32, 32, 32)   # (T, H, W, L)
    theta: float = 2000.0

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class Flux2PipelineConfig:
    transformer: Flux2Config = Flux2Config()
    vae: VaeConfig = VaeConfig(latent_channels=32, base_channels=128,
                               channel_mults=(1, 2, 4, 4), num_res_blocks=3,
                               scaling_factor=1.0, shift_factor=0.0)
    max_txt_len: int = 512           # klein pads prompts to exactly 512
    steps_default: int = 20


def tiny_flux2_config() -> Flux2PipelineConfig:
    return Flux2PipelineConfig(
        transformer=Flux2Config(in_channels=16, hidden_size=64, num_heads=4,
                                head_dim=16, depth_double=2, depth_single=2,
                                context_in_dim=96, axes_dims=(4, 4, 4, 4)),
        vae=VaeConfig(latent_channels=4, base_channels=32,
                      channel_mults=(1, 2), num_res_blocks=1,
                      scaling_factor=1.0, shift_factor=0.0),
        max_txt_len=16)


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------


def init_flux2_params(cfg: Flux2Config, seed: int = 0, dtype=torch.bfloat16,
                      device="cpu") -> dict:
    """Seeded weights from a torch.Generator on `device` (N(0, 0.02^2),
    unit QK-norms); shape-only on "meta"."""
    gen = generator(seed, device)
    h, m, hd = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim

    def w(dout, din):
        return {"weight": normal(gen, (dout, din), dtype, device)}

    def qknorm():
        return {"weight": torch.ones((hd,), dtype=dtype, device=device)}

    def attn_stream():
        return {"q": w(h, h), "k": w(h, h), "v": w(h, h), "o": w(h, h),
                "q_norm": qknorm(), "k_norm": qknorm()}

    def gated_mlp():
        return {"linear_in": w(2 * m, h), "linear_out": w(h, m)}

    return {
        "x_embedder": w(h, cfg.in_channels),
        "context_embedder": w(h, cfg.context_in_dim),
        "time_mlp": {"in": w(h, 256), "out": w(h, h)},
        "double_mod_img": w(6 * h, h),
        "double_mod_txt": w(6 * h, h),
        "single_mod": w(3 * h, h),
        "norm_out": w(2 * h, h),
        "proj_out": w(cfg.in_channels, h),
        "double": [{"img_attn": attn_stream(), "txt_attn": attn_stream(),
                    "ff": gated_mlp(), "ff_context": gated_mlp()}
                   for _ in range(cfg.depth_double)],
        "single": [{"to_qkv_mlp": w(3 * h + 2 * m, h),
                    "to_out": w(h, h + m), "q_norm": qknorm(),
                    "k_norm": qknorm()} for _ in range(cfg.depth_single)],
    }


def _heads(cfg, x):
    b, s, _ = x.shape
    return x.reshape(b, s, cfg.num_heads, cfg.head_dim)


def _stream_qkv(cfg, p, x):
    q = rms_norm(_heads(cfg, linear(x, p["q"]["weight"])),
                 p["q_norm"]["weight"], 1e-6)
    k = rms_norm(_heads(cfg, linear(x, p["k"]["weight"])),
                 p["k_norm"]["weight"], 1e-6)
    v = _heads(cfg, linear(x, p["v"]["weight"]))
    return q, k, v


def _gated_mlp(p, x):
    gate, up = linear(x, p["linear_in"]["weight"]).chunk(2, dim=-1)
    return linear(silu_mul(gate, up), p["linear_out"]["weight"])


def flux2_double_block(cfg, p, img, txt, img_mod, txt_mod, cos, sin):
    """img_mod / txt_mod: [B, 1, 6, h], shared by every double block."""
    img_h = adaln_modulate(_ln(img), img_mod[:, :, 0], img_mod[:, :, 1])
    txt_h = adaln_modulate(_ln(txt), txt_mod[:, :, 0], txt_mod[:, :, 1])
    qi, ki, vi = _stream_qkv(cfg, p["img_attn"], img_h)
    qt, kt, vt = _stream_qkv(cfg, p["txt_attn"], txt_h)
    st = txt.shape[1]
    attn = _joint_attention(cfg, torch.cat([qt, qi], 1),
                            torch.cat([kt, ki], 1), torch.cat([vt, vi], 1),
                            cos, sin)
    attn = attn.reshape(attn.shape[0], attn.shape[1], -1)
    attn_t, attn_i = attn[:, :st], attn[:, st:]
    img = img + img_mod[:, :, 2] * linear(attn_i, p["img_attn"]["o"]["weight"])
    txt = txt + txt_mod[:, :, 2] * linear(attn_t, p["txt_attn"]["o"]["weight"])
    img_h = adaln_modulate(_ln(img), img_mod[:, :, 3], img_mod[:, :, 4])
    img = img + img_mod[:, :, 5] * _gated_mlp(p["ff"], img_h)
    txt_h = adaln_modulate(_ln(txt), txt_mod[:, :, 3], txt_mod[:, :, 4])
    txt = txt + txt_mod[:, :, 5] * _gated_mlp(p["ff_context"], txt_h)
    return img, txt


def flux2_single_block(cfg, p, x, mod, cos, sin):
    """mod: [B, 1, 3, h], shared by every single block."""
    b, s, h = x.shape
    m = cfg.mlp_hidden
    xh = adaln_modulate(_ln(x), mod[:, :, 0], mod[:, :, 1])
    fused = linear(xh, p["to_qkv_mlp"]["weight"])
    q = rms_norm(_heads(cfg, fused[..., :h]), p["q_norm"]["weight"], 1e-6)
    k = rms_norm(_heads(cfg, fused[..., h:2 * h]), p["k_norm"]["weight"],
                 1e-6)
    v = _heads(cfg, fused[..., 2 * h:3 * h])
    gate, up = fused[..., 3 * h:3 * h + m], fused[..., 3 * h + m:]
    attn = _joint_attention(cfg, q, k, v, cos, sin).reshape(b, s, -1)
    merged = torch.cat([attn, silu_mul(gate, up)], dim=-1)
    return x + mod[:, :, 2] * linear(merged, p["to_out"]["weight"])


def flux2_forward(cfg: Flux2Config, params: dict, img, img_ids, txt, txt_ids,
                  t):
    """img: [B, S_img, in_ch] packed latents; txt: [B, S_txt,
    context_dim]; ids: [B, S, 4]; t: [B] in [0, 1]. Returns the velocity
    [B, S_img, in_ch]."""
    b = img.shape[0]
    h = cfg.hidden_size
    img_h = linear(img, params["x_embedder"]["weight"])
    txt_h = linear(txt.to(img.dtype), params["context_embedder"]["weight"])
    emb = timestep_embedding(t, 256).to(img.dtype)
    vec = linear(F.silu(linear(emb, params["time_mlp"]["in"]["weight"])),
                 params["time_mlp"]["out"]["weight"])
    cos, sin = rope_2d(torch.cat([txt_ids, img_ids], dim=1), cfg.axes_dims,
                       cfg.theta)
    vec_silu = F.silu(vec)
    img_mod = linear(vec_silu,
                     params["double_mod_img"]["weight"]).reshape(b, 1, 6, h)
    txt_mod = linear(vec_silu,
                     params["double_mod_txt"]["weight"]).reshape(b, 1, 6, h)
    single_mod = linear(vec_silu,
                        params["single_mod"]["weight"]).reshape(b, 1, 3, h)
    for blk in params["double"]:
        img_h, txt_h = flux2_double_block(cfg, blk, img_h, txt_h, img_mod,
                                          txt_mod, cos, sin)
    x = torch.cat([txt_h, img_h], dim=1)
    for blk in params["single"]:
        x = flux2_single_block(cfg, blk, x, single_mod, cos, sin)
    x = x[:, txt.shape[1]:]
    shift, scale = linear(vec_silu, params["norm_out"]["weight"])[:, None, :] \
        .chunk(2, dim=-1)
    x = adaln_modulate(_ln(x), shift, scale)
    return linear(x, params["proj_out"]["weight"])


# ---------------------------------------------------------------------------
# Position ids and the schedule
# ---------------------------------------------------------------------------


def make_img_ids4(h_half: int, w_half: int, batch: int = 1,
                  device="cpu") -> torch.Tensor:
    """Image ids (0, y, x, 0), row-major."""
    ys, xs = np.meshgrid(np.arange(h_half), np.arange(w_half), indexing="ij")
    ids = np.stack([np.zeros_like(ys), ys, xs, np.zeros_like(ys)],
                   axis=-1).reshape(-1, 4)
    ids = np.broadcast_to(ids[None], (batch, ids.shape[0], 4))
    return torch.from_numpy(ids.copy()).to(device)


def make_txt_ids4(seq_len: int, batch: int = 1, device="cpu") -> torch.Tensor:
    """Text ids (0, 0, 0, i)."""
    ids = np.zeros((seq_len, 4), np.int32)
    ids[:, 3] = np.arange(seq_len)
    ids = np.broadcast_to(ids[None], (batch, seq_len, 4))
    return torch.from_numpy(ids.copy()).to(device)


def empirical_mu(image_seq_len: int, num_steps: int) -> float:
    """diffusers' compute_empirical_mu (FLUX.2's dynamic shift)."""
    seq = float(image_seq_len)
    a1, b1 = 8.73809524e-05, 1.89833333
    a2, b2 = 0.00016927, 0.45666666
    if seq > 4300.0:
        return a2 * seq + b2
    m_200 = a2 * seq + b2
    m_10 = a1 * seq + b1
    a = (m_200 - m_10) / 190.0
    b = m_200 - 200.0 * a
    return a * num_steps + b


def flux2_schedule(num_steps: int, mu: float) -> np.ndarray:
    """linspace(1, 0, N) through the exponential time shift, with a
    terminal 0 appended: N + 1 float64 values."""
    base = np.linspace(1.0, 0.0, num_steps)
    e = math.exp(mu)
    shifted = np.where(base <= 1e-10, base, e / (e + (1.0 / np.maximum(
        base, 1e-12) - 1.0)))
    return np.concatenate([shifted, [0.0]])


# ---------------------------------------------------------------------------
# The Qwen3 text encoder
# ---------------------------------------------------------------------------


def default_output_layers(num_layers: int) -> tuple[int, int, int]:
    """klein-4B captures blocks 8 / 17 / 26 of 36: quarters less one."""
    q = num_layers // 4
    return (q - 1, 2 * q - 1, 3 * q - 1)


# Qwen's ChatML template with an empty thinking block, as the reference
# hardcodes it
CHAT_TEMPLATE = ("<|im_start|>user\n{}<|im_end|>\n"
                 "<|im_start|>assistant\n<think>\n\n</think>\n\n")


class Flux2TextEncoder:
    """prompt -> [1, max_len, captures x hidden]: the prompt in the ChatML
    template, encoded without added special tokens, cut or padded with
    <|endoftext|> to max_len; causal attention with the pad keys masked
    (the stateless forward_layers); one pass over layers 0..max(captures),
    keeping the hidden state after each capture layer. `params["layers"]`
    may hold just those layers."""

    def __init__(self, cfg: ModelConfig, params: dict, tokenizer=None,
                 max_len: int = 512,
                 output_layers: tuple[int, ...] | None = None,
                 pad_id: int = 151643, dtype=torch.bfloat16):
        self.cfg, self.params, self.tokenizer = cfg, params, tokenizer
        self.max_len, self.pad_id, self.dtype = max_len, pad_id, dtype
        self.output_layers = tuple(output_layers or default_output_layers(
            cfg.num_hidden_layers))
        hi = max(self.output_layers) + 1
        if len(params["layers"]) < hi:
            raise ValueError(
                f"encoder has {len(params['layers'])} layers loaded but "
                f"capture layers {self.output_layers} need {hi}")
        dev = params["embed_tokens"]["weight"].device
        self.rope = make_rope(dataclasses.replace(cfg, max_seq_len=max_len),
                              dev)

    def token_ids(self, prompt: str) -> tuple[np.ndarray, int]:
        """([1, max_len] int32 ids, the count of real tokens)."""
        ids = list(self.tokenizer.encode(CHAT_TEMPLATE.format(prompt),
                                         add_special_tokens=False))
        real = min(len(ids), self.max_len)
        ids = ids[:self.max_len] + [self.pad_id] * (self.max_len - len(ids))
        return np.asarray([ids], np.int32), real

    @torch.inference_mode()
    def encode_ids(self, ids, valid_len: int) -> torch.Tensor:
        """[1, S] ids with `valid_len` real tokens -> the captures
        concatenated, [1, S, captures x hidden], in the encoder's dtype."""
        cfg, p = self.cfg, self.params
        dev = p["embed_tokens"]["weight"].device
        x = embed_tokens(cfg, p, torch.as_tensor(ids).long().to(dev))
        captured, lo = [], 0
        for out_layer in self.output_layers:
            hi = out_layer + 1
            x = forward_layers(cfg, {"layers": p["layers"][lo:hi]}, x, None,
                               0, self.rope, valid_len=valid_len,
                               layer_range=(lo, hi))
            captured.append(x)
            lo = hi
        return torch.cat(captured, dim=-1)

    def __call__(self, prompt: str) -> torch.Tensor:
        ids, real = self.token_ids(prompt)
        return self.encode_ids(ids, real).to(self.dtype)


class DummyFlux2TextEncoder:
    """Seeded context from the prompt's CRC32 (stable across processes) on
    the CPU generator, for random-weight demo runs."""

    def __init__(self, context_dim: int, seq_len: int = 16):
        self.context_dim, self.seq_len = context_dim, seq_len

    def __call__(self, prompt: str) -> torch.Tensor:
        gen = torch.Generator().manual_seed(zlib.crc32(prompt.encode()))
        return torch.randn((1, self.seq_len, self.context_dim),
                           generator=gen)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def latent_grid(cfg: Flux2PipelineConfig, width: int,
                height: int) -> tuple[int, int]:
    """(h_half, w_half): the packed latent's grid, rounded up. One 2x VAE
    upsample per channel-multiplier step times the 2 x 2 packing (16 for
    klein's (1, 2, 4, 4))."""
    factor = 2 * 2 ** (len(cfg.vae.channel_mults) - 1)
    return -(-height // factor), -(-width // factor)


class Flux2ImageModel:
    """The image generator of the serve path for FLUX.2-klein. bn_stats:
    (running_mean, running_var) of in_channels from the VAE checkpoint's
    `bn.*` (identity for random weights). `stats` holds the last
    generation's seconds: encode_s, denoise_s (and steps), decode_s."""

    def __init__(self, cfg: Flux2PipelineConfig, params: dict | None = None,
                 text_encoder=None, bn_stats=None, dtype=torch.bfloat16,
                 seed: int = 42, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        if params is None:
            params = {
                "transformer": init_flux2_params(cfg.transformer, seed,
                                                 dtype, self.device),
                "vae": init_vae_decoder_params(cfg.vae, seed + 1,
                                               torch.float32, self.device),
            }
        self.params = params
        self.text_encoder = text_encoder or DummyFlux2TextEncoder(
            cfg.transformer.context_in_dim, seq_len=min(cfg.max_txt_len, 16))
        ic = cfg.transformer.in_channels
        if bn_stats is None:
            bn_stats = (torch.zeros(ic), torch.ones(ic))
        mean, var = (torch.as_tensor(s, dtype=torch.float32)
                     for s in bn_stats)
        self.bn_mean, self.bn_var = mean.to(self.device), var.to(self.device)
        self.bn_std = torch.sqrt(self.bn_var + 1e-4)
        self.stats: dict = {}

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @torch.inference_mode()
    def denoise(self, prompt: str, width: int = 1024, height: int = 1024,
                steps: int | None = None, seed: int | None = None,
                on_step=None, noise=None, text=None) -> torch.Tensor:
        """The final packed latent [1, h_half * w_half, in_ch] in the
        model dtype. noise: the initial packed latent (else drawn from
        `seed` on the CPU generator); text: the context (else the text
        encoder's)."""
        cfg, dev = self.cfg, self.device
        steps = steps or cfg.steps_default
        ic = cfg.transformer.in_channels
        h_half, w_half = latent_grid(cfg, width, height)
        seq = h_half * w_half
        if noise is None:
            gen = torch.Generator().manual_seed(seed if seed is not None
                                                else 0)
            noise = torch.randn((1, seq, ic), generator=gen)
        img = noise.to(dev, self.dtype)
        t0 = self._sync()
        txt = self.text_encoder(prompt) if text is None else text
        txt = txt.to(dev, self.dtype)
        t1 = self._sync()
        img_ids = make_img_ids4(h_half, w_half, device=dev)
        txt_ids = make_txt_ids4(txt.shape[1], device=dev)
        ts = flux2_schedule(steps, empirical_mu(seq, steps))
        for i in range(steps):
            t = torch.tensor([ts[i]], dtype=torch.float32, device=dev)
            v = flux2_forward(cfg.transformer, self.params["transformer"],
                              img, img_ids, txt, txt_ids, t)
            # Python-float step sizes keep bf16 latents bf16
            img = flow_matching_euler_step(img, v.to(img.dtype),
                                           float(ts[i]), float(ts[i + 1]))
            del v
            if on_step:
                on_step(i + 1, steps)
        t2 = self._sync()
        self.stats = {"encode_s": t1 - t0, "denoise_s": t2 - t1,
                      "steps": steps}
        log.info("flux2 denoise: %d steps in %.2fs", steps, t2 - t1)
        return img

    @torch.inference_mode()
    def decode(self, packed: torch.Tensor, width: int,
               height: int) -> torch.Tensor:
        """Packed latent -> image [1, 3, 16 h_half, 16 w_half] in the VAE's
        dtype: BatchNorm denormalization in packed space (float32), the
        2 x 2 unpatchify, the VAE."""
        vae = self.params["vae"]
        h_half, w_half = latent_grid(self.cfg, width, height)
        t0 = self._sync()
        z = packed.float() * self.bn_std + self.bn_mean
        z = patches_to_latents(z, 2 * h_half, 2 * w_half)
        image = vae_decode(self.cfg.vae, vae,
                           z.to(vae["conv_in"]["weight"].dtype))
        self.stats["decode_s"] = self._sync() - t0
        return image

    def generate_image(self, prompt: str, width: int = 1024,
                       height: int = 1024, steps: int | None = None,
                       guidance: float | None = None, seed: int | None = None,
                       negative_prompt: str | None = None, on_step=None,
                       noise=None, text=None) -> RgbImage:
        del negative_prompt, guidance     # klein is distilled: no CFG
        packed = self.denoise(prompt, width, height, steps, seed, on_step,
                              noise, text)
        image = self.decode(packed, width, height)
        return to_image(image[0, :, :height, :width])
