"""FLUX.1 text-to-image: text encode -> flow-matching denoise -> VAE
decode (counterpart of cake_tpu/models/image/flux.py: FluxPipelineConfig,
tiny_flux_config, DummyTextEncoder, FluxImageModel.generate_image,
to_pil).

    model = FluxImageModel(tiny_flux_config(), device="cuda")
    image = model.generate_image("a watercolor fox", 512, 512, steps=4)
    image.save("fox.png")

The text encoder is a callable prompt -> (txt [1, S, txt_dim], vec [1,
vec_dim]): FLUX.1-dev's is CLIP-L's pooled vector with T5-XXL's sequence
(flux_loader.Flux1TextEncoder); DummyTextEncoder draws seeded noise from
the prompt so the pipeline runs without encoder weights. Its values, and
the initial latent noise, come from torch's generator and cannot equal
the reference's jax.random draws: `noise=` takes an initial latent from
the caller, and parity tests pass the same (txt, vec) and noise to both.

The latent is rounded up to even sizes (2x2 patches) and the decoded
image cropped back to the size asked for. The Euler steps take Python
floats, so bf16 latents stay bf16. The VAE decodes in its own weights'
dtype (float32 from a checkpoint), the latent cast to it (the reference
feeds bf16 latents into float32 convs there and fails). Images come back
as utils/png.RgbImage: the card's machine has no Pillow.
"""
from __future__ import annotations

import dataclasses
import logging
import time
import zlib

import torch

from ...device import resolve_device
from ...ops.diffusion import flow_matching_euler_step, flow_matching_schedule
from ...utils.png import RgbImage
from .mmdit import (MMDiTConfig, init_mmdit_params, make_img_ids,
                    make_txt_ids, mmdit_forward)
from .vae import (VaeConfig, init_vae_decoder_params, latents_to_patches,
                  patches_to_latents, vae_decode)

log = logging.getLogger("cake_tpu_torch.flux")


@dataclasses.dataclass(frozen=True)
class FluxPipelineConfig:
    mmdit: MMDiTConfig = MMDiTConfig()
    vae: VaeConfig = VaeConfig()
    guidance_default: float = 3.5
    shift_mu: float = 1.15           # resolution timestep shift


def tiny_flux_config() -> FluxPipelineConfig:
    """Test-scale config; txt_dim / vec_dim match the tiny T5 and CLIP."""
    return FluxPipelineConfig(
        mmdit=MMDiTConfig(in_channels=16, hidden_size=64, num_heads=4,
                          head_dim=16, depth_double=2, depth_single=2,
                          txt_dim=32, vec_dim=32, axes_dims=(4, 6, 6)),
        vae=VaeConfig(latent_channels=4, base_channels=32,
                      channel_mults=(1, 2), num_res_blocks=1),
    )


class DummyTextEncoder:
    """Seeded embeddings from the prompt's CRC32 (stable across processes)
    on the CPU generator."""

    def __init__(self, txt_dim: int, vec_dim: int, seq_len: int = 16):
        self.txt_dim, self.vec_dim, self.seq_len = txt_dim, vec_dim, seq_len

    def __call__(self, prompt: str):
        gen = torch.Generator().manual_seed(zlib.crc32(prompt.encode()))
        txt = torch.randn((1, self.seq_len, self.txt_dim), generator=gen)
        vec = torch.randn((1, self.vec_dim), generator=gen)
        return txt, vec


def latent_size(cfg: FluxPipelineConfig, width: int, height: int
                ) -> tuple[int, int]:
    """(lh, lw): the latent rounded UP to the VAE's factor and to even
    sizes, so the decoded image is never smaller than asked."""
    factor = 2 ** (len(cfg.vae.channel_mults) - 1)
    lh = -(-height // factor)
    lw = -(-width // factor)
    return lh + lh % 2, lw + lw % 2


class FluxImageModel:
    """The image generator of the serve path. `stats` holds the last
    generation's seconds: encode_s, denoise_s (and steps), decode_s."""

    def __init__(self, cfg: FluxPipelineConfig, params: dict | None = None,
                 text_encoder=None, dtype=torch.float32, seed: int = 42,
                 device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        if params is None:
            params = {
                "transformer": init_mmdit_params(cfg.mmdit, seed, dtype,
                                                 self.device),
                "vae": init_vae_decoder_params(cfg.vae, seed + 1, dtype,
                                               self.device),
            }
        self.params = params
        self.text_encoder = text_encoder or DummyTextEncoder(
            cfg.mmdit.txt_dim, cfg.mmdit.vec_dim)
        self.stats: dict = {}

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @torch.inference_mode()
    def denoise(self, prompt: str, width: int = 1024, height: int = 1024,
                steps: int = 20, guidance: float | None = None,
                seed: int | None = None, on_step=None, noise=None,
                text=None) -> torch.Tensor:
        """The final latent [1, C, lh, lw] in the model dtype. noise: the
        initial latent (else drawn from `seed` on the CPU generator);
        text: (txt, vec) (else the text encoder's)."""
        cfg, dev = self.cfg, self.device
        lh, lw = latent_size(cfg, width, height)
        if noise is None:
            gen = torch.Generator().manual_seed(seed if seed is not None
                                                else 0)
            noise = torch.randn((1, cfg.vae.latent_channels, lh, lw),
                                generator=gen)
        z = noise.to(dev, self.dtype)
        t0 = self._sync()
        txt, vec = text if text is not None else self.text_encoder(prompt)
        txt = txt.to(dev, self.dtype)
        vec = vec.to(dev, self.dtype)
        t1 = self._sync()
        img = latents_to_patches(z)
        img_ids = make_img_ids(lh // 2, lw // 2, device=dev)
        txt_ids = make_txt_ids(txt.shape[1], device=dev)
        g = torch.tensor([cfg.guidance_default if guidance is None
                          else guidance], dtype=torch.float32, device=dev)
        ts = flow_matching_schedule(steps, cfg.shift_mu)
        for i in range(steps):
            t = torch.tensor([ts[i]], dtype=torch.float32, device=dev)
            v = mmdit_forward(cfg.mmdit, self.params["transformer"], img,
                              img_ids, txt, txt_ids, t, vec, g)
            # Python-float step sizes keep bf16 latents bf16
            img = flow_matching_euler_step(img, v, float(ts[i]),
                                           float(ts[i + 1]))
            del v
            if on_step:
                on_step(i + 1, steps)
        t2 = self._sync()
        self.stats = {"encode_s": t1 - t0, "denoise_s": t2 - t1,
                      "steps": steps}
        log.info("denoise: %d steps in %.2fs", steps, t2 - t1)
        return patches_to_latents(img, lh, lw)

    @torch.inference_mode()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent -> image [1, 3, H, W] in the VAE's dtype."""
        vae = self.params["vae"]
        t0 = self._sync()
        image = vae_decode(self.cfg.vae, vae,
                           z.to(vae["conv_in"]["weight"].dtype))
        self.stats["decode_s"] = self._sync() - t0
        return image

    def generate_image(self, prompt: str, width: int = 1024,
                       height: int = 1024, steps: int = 20,
                       guidance: float | None = None, seed: int | None = None,
                       negative_prompt: str | None = None, on_step=None,
                       noise=None, text=None) -> RgbImage:
        del negative_prompt      # FLUX.1-dev is guidance-distilled
        z = self.denoise(prompt, width, height, steps, guidance, seed,
                         on_step, noise, text)
        image = self.decode(z)
        return to_image(image[0, :, :height, :width])


def to_image(chw: torch.Tensor) -> RgbImage:
    """[-1, 1] CHW -> RgbImage, the reference's to_pil arithmetic in the
    tensor's own dtype: clip((x + 1) * 127.5, 0, 255) then truncation to
    uint8."""
    hwc = chw.detach().to("cpu").permute(1, 2, 0)
    pix = ((hwc + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    return RgbImage(pix.contiguous().numpy())
