"""Stable Diffusion 1.x / 2.x and SDXL (counterpart of
cake_tpu/models/image/sd.py: UNetConfig, SDPipelineConfig,
tiny_sd_config, init_unet_params, unet_forward, SDImageModel,
SDXLImageModel): CLIP text conditioning -> UNet denoising (epsilon or
v-prediction, DPM-Solver++(2M), batch-2 classifier-free guidance with a
negative prompt) -> VAE decode; img2img from a noised init latent.

    model = SDImageModel(tiny_sd_config(), device="cuda")
    image = model.generate_image("a lighthouse", 512, 512, steps=20)
    image.save("lighthouse.png")

UNet: conv_in -> down levels (resnets, spatial transformers where the
level has cross-attention, a stride-2 conv) -> mid (resnet, transformer,
resnet) -> up levels (resnets over skip concatenations, transformers, a
nearest 2x upsample and a conv) -> GroupNorm + SiLU + conv_out. The time
embedding (sinusoids -> MLP) is added inside each resnet; SDXL adds its
text_time embedding (the second encoder's pooled text and six 256-wide
size / crop sinusoids, through its own MLP). SD2.x's per-level head
counts, linear projections and v-prediction come from the configs.

Attention is plain non-causal attention with float32 scores, as in the
reference (no Pallas kernel there): the scores are freed as soon as the
probabilities exist. Convolutions are cuDNN's and products cuBLAS's.

The initial latent is drawn from `seed` on the CPU generator and cannot
equal the reference's jax.random draws: `noise=` takes one from the
caller, and the parity tests pass the reference's. The VAE decodes (and
encodes) in its own weights' dtype, float32 from a checkpoint, the
latent cast to it. Every generation builds its own solver from the
config, so two jobs never share its multistep state.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ...device import resolve_device
from ...obs.profile import torch_trace
from ...ops.conv import conv2d
from ...ops.diffusion import DpmSolverPP, cfg_combine
from ...ops.linear import linear
from ...ops.norms import group_norm, layer_norm
from ...utils.init import generator, normal
from ...utils.png import RgbImage, resize_bicubic
from .flux import DummyTextEncoder, to_image
from .mmdit import timestep_embedding
from .vae import (VaeConfig, init_vae_decoder_params,
                  init_vae_encoder_params, vae_decode, vae_encode)

log = logging.getLogger("cake_tpu_torch.sd")


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    base_channels: int = 320
    channel_mults: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_levels: tuple[int, ...] = (0, 1, 2)   # levels with cross-attention
    # int: the same head count at every level (SD1.x); tuple: per-level
    # head counts (SD2.x's (5, 10, 20, 20): 64-wide heads as channels
    # grow). diffusers calls both `attention_head_dim`; they are COUNTS.
    num_heads: int | tuple[int, ...] = 8
    context_dim: int = 768                     # the text encoder's width
    time_dim: int = 1280
    # transformer blocks per spatial transformer: 1 for SD1.x / 2.x,
    # per level (1, 2, 10) for SDXL
    transformer_depth: int | tuple[int, ...] = 1
    # SDXL's text_time embedding: add_embedding.linear_1's input width
    # (pooled text 1280 + 6 x 256 time-id sinusoids = 2816); None = off
    addition_embed_dim: int | None = None
    addition_time_embed_dim: int = 256

    def heads_at(self, lvl: int) -> int:
        if isinstance(self.num_heads, tuple):
            return self.num_heads[lvl]
        return self.num_heads

    def depth_at(self, lvl: int) -> int:
        if isinstance(self.transformer_depth, tuple):
            return self.transformer_depth[lvl]
        return self.transformer_depth


@dataclasses.dataclass(frozen=True)
class SDPipelineConfig:
    unet: UNetConfig = UNetConfig()
    vae: VaeConfig = VaeConfig(latent_channels=4, scaling_factor=0.18215,
                               shift_factor=0.0)
    guidance_default: float = 7.5
    steps_default: int = 20
    # SD2.1-768 is v-prediction, 1.x and 2.x-base epsilon (the loader
    # reads scheduler/scheduler_config.json)
    prediction_type: str = "epsilon"
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"


def tiny_sd_config() -> SDPipelineConfig:
    return SDPipelineConfig(
        unet=UNetConfig(base_channels=32, channel_mults=(1, 2),
                        num_res_blocks=1, attn_levels=(1,), num_heads=2,
                        context_dim=32, time_dim=64),
        vae=VaeConfig(latent_channels=4, base_channels=32,
                      channel_mults=(1, 2), num_res_blocks=1,
                      scaling_factor=0.18215, shift_factor=0.0),
    )


# -- parameters ---------------------------------------------------------------

def init_unet_params(cfg: UNetConfig, seed: int = 0, dtype=torch.float32,
                     device="cpu") -> dict:
    """Seeded weights of N(0, 1/fan_in) and zero biases, the reference's
    tree: a level without cross-attention keeps None in its "attn" list,
    the last level None for "down", the first None for "up"."""
    gen = generator(seed, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def conv(cout, cin, k):
        fan = cin * k * k
        return {"weight": normal(gen, (cout, cin, k, k), dtype, device,
                                 std=fan ** -0.5), "bias": zeros(cout)}

    def lin(o, i, bias=True):
        p = {"weight": normal(gen, (o, i), dtype, device, std=i ** -0.5)}
        if bias:
            p["bias"] = zeros(o)
        return p

    def norm(c):
        return {"weight": torch.ones((c,), dtype=dtype, device=device),
                "bias": zeros(c)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(cout, cin, 3),
             "time": lin(cout, cfg.time_dim), "norm2": norm(cout),
             "conv2": conv(cout, cout, 3)}
        if cin != cout:
            p["shortcut"] = conv(cout, cin, 1)
        return p

    def tblock(c, ctx):
        # bias-free q/k/v and a GEGLU feed-forward (value and gate in one
        # 8c projection): the real SD transformer block
        return {"norm1": norm(c), "self_q": lin(c, c, False),
                "self_k": lin(c, c, False), "self_v": lin(c, c, False),
                "self_o": lin(c, c), "norm2": norm(c),
                "cross_q": lin(c, c, False), "cross_k": lin(c, ctx, False),
                "cross_v": lin(c, ctx, False), "cross_o": lin(c, c),
                "norm3": norm(c), "ff1": lin(8 * c, c),
                "ff2": lin(c, 4 * c)}

    def xattn(c, depth):
        return {"norm": norm(c), "proj_in": lin(c, c),
                "blocks": [tblock(c, cfg.context_dim) for _ in range(depth)],
                "proj_out": lin(c, c)}
    chs = [cfg.base_channels * m for m in cfg.channel_mults]
    p: dict = {
        "time_mlp1": lin(cfg.time_dim, cfg.base_channels),
        "time_mlp2": lin(cfg.time_dim, cfg.time_dim),
        "conv_in": conv(cfg.base_channels, cfg.in_channels, 3),
        "down": [], "up": [],
        "norm_out": norm(cfg.base_channels),
        "conv_out": conv(cfg.in_channels, cfg.base_channels, 3),
    }
    if cfg.addition_embed_dim:
        p["add_mlp1"] = lin(cfg.time_dim, cfg.addition_embed_dim)
        p["add_mlp2"] = lin(cfg.time_dim, cfg.time_dim)
    skips = [cfg.base_channels]
    cin = cfg.base_channels
    for lvl, c in enumerate(chs):
        blk = {"res": [], "attn": [], "down": None}
        for _ in range(cfg.num_res_blocks):
            blk["res"].append(resnet(cin, c))
            blk["attn"].append(xattn(c, cfg.depth_at(lvl))
                               if lvl in cfg.attn_levels else None)
            cin = c
            skips.append(c)
        if lvl < len(chs) - 1:
            blk["down"] = conv(c, c, 3)
            skips.append(c)
        p["down"].append(blk)
    n_lv = len(chs)
    p["mid_res1"] = resnet(cin, cin)
    p["mid_attn"] = xattn(cin, cfg.depth_at(n_lv - 1))
    p["mid_res2"] = resnet(cin, cin)
    for lvl in reversed(range(n_lv)):
        c = chs[lvl]
        blk = {"res": [], "attn": [], "up": None}
        for _ in range(cfg.num_res_blocks + 1):
            blk["res"].append(resnet(cin + skips.pop(), c))
            blk["attn"].append(xattn(c, cfg.depth_at(lvl))
                               if lvl in cfg.attn_levels else None)
            cin = c
        if lvl > 0:
            blk["up"] = conv(c, c, 3)
        p["up"].append(blk)
    return p


# -- forward ------------------------------------------------------------------

def _conv(p, x, stride=1, padding=0):
    return conv2d(x, p["weight"], p["bias"], stride=stride, padding=padding)


def _gn(p, x):
    return group_norm(x, p["weight"], p["bias"], 32)


def _ln(p, x):
    return layer_norm(x, p["weight"], p["bias"], 1e-5)


def _lin(p, x):
    return linear(x, p["weight"], p.get("bias"))


def _resnet(p, x, temb):
    h = _conv(p["conv1"], F.silu(_gn(p["norm1"], x)), padding=1)
    h = h + _lin(p["time"], F.silu(temb))[:, :, None, None]
    h = _conv(p["conv2"], F.silu(_gn(p["norm2"], h)), padding=1)
    if "shortcut" in p:
        x = _conv(p["shortcut"], x)
    return x + h


def _mha(q, k, v, heads: int):
    """Non-causal attention, float32 scores whatever the input dtype (the
    reference's preferred_element_type), the probabilities cast to v's
    dtype. The scores are freed once the probabilities exist. The
    `sd.attention` range names its kernels in a profiler trace
    (obs/profile.kernel_split)."""
    b, sq, c = q.shape
    d = c // heads
    with record_function("sd.attention"):
        qh = q.reshape(b, sq, heads, d)
        kh = k.reshape(b, k.shape[1], heads, d)
        vh = v.reshape(b, v.shape[1], heads, d)
        s = torch.einsum("bshd,bthd->bhst", qh.float(), kh.float())
        s.div_(d ** 0.5)
        a = torch.softmax(s, dim=-1)
        del s
        a = a.to(vh.dtype)
        return torch.einsum("bhst,bthd->bshd", a, vh).reshape(b, sq, c)


def _tblock(p, h, ctx, heads: int):
    """One transformer block: self-attention, cross-attention, GEGLU."""
    hn = _ln(p["norm1"], h)
    h = h + _lin(p["self_o"], _mha(_lin(p["self_q"], hn),
                                   _lin(p["self_k"], hn),
                                   _lin(p["self_v"], hn), heads))
    hn = _ln(p["norm2"], h)
    h = h + _lin(p["cross_o"], _mha(_lin(p["cross_q"], hn),
                                    _lin(p["cross_k"], ctx),
                                    _lin(p["cross_v"], ctx), heads))
    hn = _ln(p["norm3"], h)
    # GEGLU: [value ; gate] from one projection, value * gelu(gate) with
    # the exact erf GELU (diffusers')
    val, gate = _lin(p["ff1"], hn).chunk(2, dim=-1)
    return h + _lin(p["ff2"], val * F.gelu(gate))


def _xattn(p, x, ctx, heads: int):
    """Spatial transformer: norm and proj_in, its blocks (1 in SD1.x /
    2.x, up to 10 at SDXL's deepest level), proj_out, the residual."""
    b, c, hh, ww = x.shape
    h = _gn(p["norm"], x).reshape(b, c, hh * ww).transpose(1, 2)
    h = _lin(p["proj_in"], h)
    for bp in p["blocks"]:
        h = _tblock(bp, h, ctx, heads)
    h = _lin(p["proj_out"], h)
    return x + h.transpose(1, 2).reshape(b, c, hh, ww)


def unet_forward(cfg: UNetConfig, p: dict, x: torch.Tensor, t: torch.Tensor,
                 ctx: torch.Tensor, added: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """x: [B, 4, H/8, W/8]; t: [B] float32 timestep fraction in [0, 1];
    ctx: [B, S, context_dim]; added: [B, addition_embed_dim] (SDXL's
    pooled text ++ time-id sinusoids) or None. Returns the noise (or
    velocity) prediction, x's shape and dtype."""
    temb = timestep_embedding(t, cfg.base_channels).to(x.dtype)
    temb = _lin(p["time_mlp1"], temb)
    temb = _lin(p["time_mlp2"], F.silu(temb))
    if added is not None:
        aemb = _lin(p["add_mlp1"], added.to(x.dtype))
        temb = temb + _lin(p["add_mlp2"], F.silu(aemb))

    h = _conv(p["conv_in"], x, padding=1)
    n_lv = len(cfg.channel_mults)
    skips = [h]
    for lvl, blk in enumerate(p["down"]):
        # a mapped load has no structural None: a missing "attn" or
        # "down" reads as None
        attns = blk.get("attn") or [None] * len(blk["res"])
        for r, a in zip(blk["res"], attns):
            h = _resnet(r, h, temb)
            if a is not None:
                h = _xattn(a, h, ctx, cfg.heads_at(lvl))
            skips.append(h)
        if blk.get("down") is not None:
            h = _conv(blk["down"], h, stride=2, padding=1)
            skips.append(h)
    h = _resnet(p["mid_res1"], h, temb)
    h = _xattn(p["mid_attn"], h, ctx, cfg.heads_at(n_lv - 1))
    h = _resnet(p["mid_res2"], h, temb)
    for k, blk in enumerate(p["up"]):
        lvl = n_lv - 1 - k                  # up.0 is the deepest level
        attns = blk.get("attn") or [None] * len(blk["res"])
        for r, a in zip(blk["res"], attns):
            h = _resnet(r, torch.cat([h, skips.pop()], dim=1), temb)
            if a is not None:
                h = _xattn(a, h, ctx, cfg.heads_at(lvl))
        if blk.get("up") is not None:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = _conv(blk["up"], h, padding=1)
    h = F.silu(_gn(p["norm_out"], h))
    return _conv(p["conv_out"], h, padding=1)


# -- pipelines ----------------------------------------------------------------

def latent_size(cfg: SDPipelineConfig, width: int, height: int
                ) -> tuple[int, int]:
    """(lh, lw): the reference's floor to the VAE's factor, at least 8."""
    factor = 2 ** (len(cfg.vae.channel_mults) - 1)
    return max(height // factor, 8), max(width // factor, 8)


class SDImageModel:
    """The SD 1.x / 2.x image generator of the serve path: CFG with a
    negative prompt, img2img, intermediate images and a profiler trace.
    `stats` holds the last generation's seconds: encode_s, denoise_s (and
    steps), decode_s."""

    def __init__(self, cfg: SDPipelineConfig, params: dict | None = None,
                 text_encoder=None, dtype=torch.float32, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        if params is None:
            params = {
                "unet": init_unet_params(cfg.unet, seed, dtype, self.device),
                "vae": init_vae_decoder_params(cfg.vae, seed + 1, dtype,
                                               self.device),
                "vae_enc": init_vae_encoder_params(cfg.vae, seed + 2, dtype,
                                                   self.device)}
        self.params = params
        self.text_encoder = text_encoder or DummyTextEncoder(
            cfg.unet.context_dim, 1, seq_len=8)
        self.stats: dict = {}

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # -- img2img -------------------------------------------------------------

    def init_latent_from(self, img, width: int, height: int,
                         noise: torch.Tensor | None = None) -> torch.Tensor:
        """img2img's preprocessing (cli image --init-image and the API's
        init_image_b64): RGB pixels (an RgbImage or uint8 [H, W, 3], as
        utils/png.decode_png gives them) resized to width x height as
        Pillow's default bicubic resize does, then encoded. Raises
        ValueError for the user's input (no encoder weights, an image
        below the latent's floor)."""
        pixels = np.asarray(img)
        if pixels.shape[:2] != (height, width):
            pixels = resize_bicubic(pixels, width, height)
        return self.encode_image(pixels, noise=noise)

    @torch.inference_mode()
    def encode_image(self, pixels, noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
        """pixels: [H, W, 3] (or [B, H, W, 3]), an integer dtype in 0..255
        or floats already in [-1, 1] (the dtype decides). Returns the
        scheduler-space init latent for generate_image(init_image=...):
        the posterior's mode, or a sample with `noise` / `generator`.
        Needs the VAE encoder's weights (a decoder-only bundle raises)."""
        if "vae_enc" not in self.params:
            raise ValueError(
                "this checkpoint has no VAE encoder weights: img2img from "
                "a real image needs a full AutoencoderKL dump")
        arr = np.asarray(pixels)
        px = torch.tensor(arr, dtype=torch.float32)
        if np.issubdtype(arr.dtype, np.integer):
            px = px / 127.5 - 1.0           # 0..255 -> [-1, 1]
        if px.dim() == 3:
            px = px[None]
        px = px.permute(0, 3, 1, 2)         # NHWC -> NCHW
        factor = 2 ** (len(self.cfg.vae.channel_mults) - 1)
        if px.shape[2] < 8 * factor or px.shape[3] < 8 * factor:
            # the noise latent is at least 8 x 8; a smaller init latent
            # would not mix with it
            raise ValueError(
                f"img2img needs at least {8 * factor}x{8 * factor} pixels")
        enc = self.params["vae_enc"]
        px = px.to(self.device, enc["conv_in"]["weight"].dtype)
        return vae_encode(self.cfg.vae, enc, px, noise=noise,
                          generator=generator)

    # -- generation ----------------------------------------------------------

    def _encode_prompt(self, prompt: str, negative_prompt: str,
                       width: int, height: int):
        """(ctx [2, S, C], added [2, A] or None), the unconditional
        stream first."""
        ctx_p, _ = self.text_encoder(prompt)
        ctx_n, _ = self.text_encoder(negative_prompt)
        return torch.cat([self._cast(ctx_n), self._cast(ctx_p)]), None

    def _cast(self, t) -> torch.Tensor:
        return torch.as_tensor(t).to(self.device, self.dtype)

    def _decode(self, x: torch.Tensor) -> torch.Tensor:
        vae = self.params["vae"]
        return vae_decode(self.cfg.vae, vae,
                          x.to(vae["conv_in"]["weight"].dtype))

    @torch.inference_mode()
    def denoise(self, prompt: str, width: int = 512, height: int = 512,
                steps: int | None = None, guidance: float | None = None,
                seed: int | None = None, negative_prompt: str | None = None,
                init_image=None, strength: float = 0.75, on_step=None,
                intermediate_every: int = 0, on_image=None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        """The final latent [1, C, lh, lw] in the model dtype. noise: the
        initial latent (else drawn from `seed` on the CPU generator);
        init_image: a latent from init_latent_from / encode_image, noised
        to the step that `strength` starts from."""
        cfg, dev = self.cfg, self.device
        steps = steps or cfg.steps_default
        g = cfg.guidance_default if guidance is None else guidance
        lh, lw = latent_size(cfg, width, height)
        down = 2 ** (len(cfg.unet.channel_mults) - 1)
        if lh % down or lw % down:
            # the UNet's skip concatenations would not meet
            raise ValueError(f"size {width}x{height}: the latent {lw}x{lh} "
                             f"must divide by {down} (the UNet's levels)")
        if noise is None:
            gen = torch.Generator().manual_seed(seed if seed is not None
                                                else 0)
            noise = torch.randn((1, cfg.vae.latent_channels, lh, lw),
                                generator=gen)
        noise = noise.to(dev, self.dtype)
        t0 = self._sync()
        ctx, added = self._encode_prompt(prompt, negative_prompt or "",
                                         width, height)
        t1 = self._sync()
        sch = DpmSolverPP.from_betas(
            beta_start=cfg.beta_start, beta_end=cfg.beta_end,
            schedule=cfg.beta_schedule, prediction_type=cfg.prediction_type)
        ts = sch.timesteps(steps)
        if init_image is not None:
            start = min(max(int(steps * (1.0 - strength)), 0), steps - 1)
            ts = ts[start:]
            z0 = torch.as_tensor(init_image).to(dev, self.dtype)
            a = float(sch.alphas_cumprod[int(ts[0])])
            x = (a ** 0.5) * z0 + ((1 - a) ** 0.5) * noise
        else:
            x = noise
        unet = self.params["unet"]
        for j, t in enumerate(ts):
            with record_function("sd.unet_step"):
                tv = torch.full((2,), float(t) / sch.T, dtype=torch.float32,
                                device=dev)
                eps2 = unet_forward(cfg.unet, unet, torch.cat([x, x]), tv,
                                    ctx, added)
                eps = cfg_combine(eps2[:1], eps2[1:], g)
                del eps2
                t_next = int(ts[j + 1]) if j + 1 < len(ts) else 0
                x = sch.step(eps, int(t), t_next, x)
            if on_step:
                on_step(j + 1, len(ts))
            if intermediate_every and (j + 1) % intermediate_every == 0 \
                    and j + 1 < len(ts):
                mid = to_image(self._decode(x)[0, :, :height, :width])
                if on_image:
                    on_image(j + 1, mid)
                else:
                    mid.save(f"sd_intermediate_{j + 1}.png")
        t2 = self._sync()
        self.stats = {"encode_s": t1 - t0, "denoise_s": t2 - t1,
                      "steps": len(ts)}
        log.info("denoise: %d steps in %.2fs", len(ts), t2 - t1)
        return x

    @torch.inference_mode()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent -> image [1, 3, H, W] in the VAE's dtype."""
        t0 = self._sync()
        image = self._decode(z)
        self.stats["decode_s"] = self._sync() - t0
        return image

    def generate_image(self, prompt: str, width: int = 512, height: int = 512,
                       steps: int | None = None, guidance: float | None = None,
                       seed: int | None = None,
                       negative_prompt: str | None = None, init_image=None,
                       strength: float = 0.75, on_step=None,
                       intermediate_every: int = 0, on_image=None,
                       trace_dir: str | None = None,
                       noise: torch.Tensor | None = None) -> RgbImage:
        """intermediate_every=N decodes the image in progress every N
        steps (not after the last) into on_image(step, RgbImage), or,
        without a callback, sd_intermediate_<step>.png in the working
        directory. trace_dir wraps the generation in a torch.profiler
        trace written there (obs/profile.py)."""
        with torch_trace(trace_dir):
            z = self.denoise(prompt, width, height, steps, guidance, seed,
                             negative_prompt, init_image, strength, on_step,
                             intermediate_every, on_image, noise)
            image = self.decode(z)
            return to_image(image[0, :, :height, :width])


class SDXLImageModel(SDImageModel):
    """SDXL: two text encoders (CLIP-L and OpenCLIP bigG), their
    penultimate states concatenated into the 2048-wide context, and the
    text_time embedding of encoder 2's pooled (projected) text with six
    256-wide sinusoids of (height, width, 0, 0, height, width)."""

    def __init__(self, cfg: SDPipelineConfig, params: dict, text_encoder,
                 text_encoder2, dtype=torch.float32, seed: int = 0,
                 force_zeros_for_empty_prompt: bool = True, device=None):
        super().__init__(cfg, params=params, text_encoder=text_encoder,
                         dtype=dtype, seed=seed, device=device)
        self.text_encoder2 = text_encoder2
        # diffusers' SDXL: an EMPTY negative prompt conditions on zeros
        # (model_index.json's force_zeros_for_empty_prompt, default true)
        self.force_zeros_for_empty_prompt = force_zeros_for_empty_prompt

    def _encode_prompt(self, prompt: str, negative_prompt: str,
                       width: int, height: int):
        def enc(text):
            _, _, pen1 = self.text_encoder.encode3(text)
            _, pooled2, pen2 = self.text_encoder2.encode3(text)
            return (torch.cat([self._cast(pen1), self._cast(pen2)], dim=-1),
                    self._cast(pooled2))
        ctx_p, pooled_p = enc(prompt)
        if not negative_prompt and self.force_zeros_for_empty_prompt:
            ctx_n, pooled_n = torch.zeros_like(ctx_p), \
                torch.zeros_like(pooled_p)
        else:
            ctx_n, pooled_n = enc(negative_prompt)
        # original size, crop top-left, target size (no cropping)
        time_ids = torch.tensor([float(height), float(width), 0.0, 0.0,
                                 float(height), float(width)],
                                dtype=torch.float32, device=self.device)
        d = self.cfg.unet.addition_time_embed_dim
        tid = timestep_embedding(time_ids, d, scale=1.0).reshape(1, -1)
        tid = tid.to(self.dtype)
        return (torch.cat([ctx_n, ctx_p]),
                torch.cat([torch.cat([pooled_n, tid], dim=-1),
                           torch.cat([pooled_p, tid], dim=-1)]))
