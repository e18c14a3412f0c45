"""The image VAE (counterpart of cake_tpu/models/image/vae.py: VaeConfig,
init_vae_decoder_params, init_vae_encoder_params, vae_decode, vae_encode,
latents_to_patches, patches_to_latents).

Decoder: conv_in -> mid (resnet, attention, resnet) -> up blocks (resnets,
then a nearest 2x upsample and a conv) -> GroupNorm + SiLU + conv_out,
channels first. No output activation: the image is nominally in [-1, 1]
and consumers clamp it. Encoder (SD's img2img): its mirror, with
diffusers' asymmetric (0, 1) pad before each stride-2 downsample, ending
in the posterior's moments through quant_conv.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...ops.conv import conv2d
from ...ops.norms import group_norm
from ...utils.init import generator, normal


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    latent_channels: int = 16        # FLUX.1: 16
    base_channels: int = 128
    channel_mults: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 3          # per decoder up block
    out_channels: int = 3
    scaling_factor: float = 0.3611   # FLUX.1
    shift_factor: float = 0.1159


def init_vae_decoder_params(cfg: VaeConfig, seed: int = 0,
                            dtype=torch.float32, device="cpu") -> dict:
    gen = generator(seed, device)

    def conv(cout, cin, k):
        return {"weight": normal(gen, (cout, cin, k, k), dtype, device),
                "bias": torch.zeros((cout,), dtype=dtype, device=device)}

    def norm(c):
        return {"weight": torch.ones((c,), dtype=dtype, device=device),
                "bias": torch.zeros((c,), dtype=dtype, device=device)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(cout, cin, 3),
             "norm2": norm(cout), "conv2": conv(cout, cout, 3)}
        if cin != cout:
            p["shortcut"] = conv(cout, cin, 1)
        return p
    chs = [cfg.base_channels * m for m in cfg.channel_mults]
    top = chs[-1]
    p: dict = {
        "conv_in": conv(top, cfg.latent_channels, 3),
        "mid_res1": resnet(top, top),
        "mid_attn": {"norm": norm(top), "q": conv(top, top, 1),
                     "k": conv(top, top, 1), "v": conv(top, top, 1),
                     "proj": conv(top, top, 1)},
        "mid_res2": resnet(top, top),
        "ups": [],
        "norm_out": norm(chs[0]),
        "conv_out": conv(cfg.out_channels, chs[0], 3),
    }
    cin = top
    for i, c in enumerate(reversed(chs)):
        blk = {"res": [], "upsample": None}
        for _ in range(cfg.num_res_blocks):
            blk["res"].append(resnet(cin, c))
            cin = c
        if i < len(chs) - 1:
            blk["upsample"] = conv(c, c, 3)
        p["ups"].append(blk)
    return p


def init_vae_encoder_params(cfg: VaeConfig, seed: int = 0,
                            dtype=torch.float32, device="cpu") -> dict:
    """The encoder mirror of the decoder (diffusers' AutoencoderKL
    Encoder): conv_in -> per-level resnets and a stride-2 downsample ->
    mid (resnet, attention, resnet) -> norm + conv_out to 2 x latent
    moments -> quant_conv (1x1). A level has the decoder's resnet count
    less one (diffusers' layers_per_block)."""
    gen = generator(seed, device)

    def conv(cout, cin, k):
        return {"weight": normal(gen, (cout, cin, k, k), dtype, device),
                "bias": torch.zeros((cout,), dtype=dtype, device=device)}

    def norm(c):
        return {"weight": torch.ones((c,), dtype=dtype, device=device),
                "bias": torch.zeros((c,), dtype=dtype, device=device)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(cout, cin, 3),
             "norm2": norm(cout), "conv2": conv(cout, cout, 3)}
        if cin != cout:
            p["shortcut"] = conv(cout, cin, 1)
        return p
    chs = [cfg.base_channels * m for m in cfg.channel_mults]
    top, lc = chs[-1], cfg.latent_channels
    p: dict = {
        "conv_in": conv(chs[0], cfg.out_channels, 3),
        "downs": [],
        "mid_res1": resnet(top, top),
        "mid_attn": {"norm": norm(top), "q": conv(top, top, 1),
                     "k": conv(top, top, 1), "v": conv(top, top, 1),
                     "proj": conv(top, top, 1)},
        "mid_res2": resnet(top, top),
        "norm_out": norm(top),
        "conv_out": conv(2 * lc, top, 3),
        "quant_conv": conv(2 * lc, 2 * lc, 1),
    }
    cin = chs[0]
    n_res = max(cfg.num_res_blocks - 1, 1)
    for i, c in enumerate(chs):
        blk = {"res": [], "downsample": None}
        for _ in range(n_res):
            blk["res"].append(resnet(cin, c))
            cin = c
        if i < len(chs) - 1:
            blk["downsample"] = conv(c, c, 3)
        p["downs"].append(blk)
    return p


def _conv(p, x, padding=0):
    return conv2d(x, p["weight"], p["bias"], padding=padding)


def _gn(p, x):
    return group_norm(x, p["weight"], p["bias"], 32)


def _resnet(p, x):
    h = _conv(p["conv1"], F.silu(_gn(p["norm1"], x)), 1)
    h = _conv(p["conv2"], F.silu(_gn(p["norm2"], h)), 1)
    if "shortcut" in p:
        x = _conv(p["shortcut"], x)
    return x + h


def _mid_attention(p, x):
    b, c, hh, ww = x.shape
    h = _gn(p["norm"], x)
    q = _conv(p["q"], h).reshape(b, c, -1)
    k = _conv(p["k"], h).reshape(b, c, -1)
    v = _conv(p["v"], h).reshape(b, c, -1)
    scores = torch.einsum("bcs,bct->bst", q.float(), k.float()) / (c ** 0.5)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    out = torch.einsum("bst,bct->bcs", probs, v).reshape(b, c, hh, ww)
    return x + _conv(p["proj"], out)


def _upsample2x(p, x):
    return _conv(p, F.interpolate(x, scale_factor=2, mode="nearest"), 1)


def _downsample2x(p, x):
    # diffusers' Downsample2D: an ASYMMETRIC (0, 1) pad, then a stride-2
    # conv with no padding
    x = F.pad(x, (0, 1, 0, 1))
    return conv2d(x, p["weight"], p["bias"], stride=2)


def vae_encode(cfg: VaeConfig, p: dict, img: torch.Tensor,
               noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """img: [B, 3, H, W] in [-1, 1] -> the scheduler-space latent [B,
    latent_ch, H/8, W/8], z = (mean - shift) * scale (vae_decode's
    inverse). The posterior's mode, or a sample of it with `noise` (the
    standard normal draws, the latent's shape) or drawn from `generator`
    (on its device, in float32)."""
    x = _conv(p["conv_in"], img, 1)
    for blk in p["downs"]:
        for r in blk["res"]:
            x = _resnet(r, x)
        if blk.get("downsample") is not None:
            x = _downsample2x(blk["downsample"], x)
    x = _resnet(p["mid_res1"], x)
    x = _mid_attention(p["mid_attn"], x)
    x = _resnet(p["mid_res2"], x)
    x = F.silu(_gn(p["norm_out"], x))
    moments = _conv(p["conv_out"], x, 1)
    moments = _conv(p["quant_conv"], moments)
    mean, logvar = moments.chunk(2, dim=1)
    if noise is None and generator is not None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=generator.device)
    if noise is not None:
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        mean = mean + std * noise.to(mean.device, mean.dtype)
    return (mean - cfg.shift_factor) * cfg.scaling_factor


def vae_decode(cfg: VaeConfig, p: dict, z: torch.Tensor) -> torch.Tensor:
    """z: [B, latent_ch, H/8, W/8] -> image [B, 3, H, W], unbounded."""
    z = z / cfg.scaling_factor + cfg.shift_factor
    if "post_quant_conv" in p:
        z = _conv(p["post_quant_conv"], z)
    x = _conv(p["conv_in"], z, 1)
    x = _resnet(p["mid_res1"], x)
    x = _mid_attention(p["mid_attn"], x)
    x = _resnet(p["mid_res2"], x)
    for blk in p["ups"]:
        for r in blk["res"]:
            x = _resnet(r, x)
        if blk.get("upsample") is not None:
            x = _upsample2x(blk["upsample"], x)
    x = F.silu(_gn(p["norm_out"], x))
    return _conv(p["conv_out"], x, 1)


def latents_to_patches(z: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H/2 * W/2, C * 4] 2x2 patches (FLUX packing)."""
    b, c, h, w = z.shape
    z = z.reshape(b, c, h // 2, 2, w // 2, 2)
    return z.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)


def patches_to_latents(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of latents_to_patches; h, w are the full latent dims."""
    b, _, cf = x.shape
    c = cf // 4
    x = x.reshape(b, h // 2, w // 2, c, 2, 2)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w)
