"""Image generation (counterpart of cake_tpu/models/image/): FLUX.1 (the
MMDiT, the VAE decoder, the pipeline and its checkpoint loader). SD and
FLUX.2 are not ported yet (ROADMAP module 14)."""
from .flux import (DummyTextEncoder, FluxImageModel, FluxPipelineConfig,
                   tiny_flux_config, to_image)
from .flux_loader import (Flux1TextEncoder, detect_flux_checkpoint,
                          flux1_dev_configs, infer_flux_configs,
                          load_flux_image_model, load_flux_params,
                          mmdit_mapping, seeded_flux1,
                          vae_decoder_mapping)
from .mmdit import MMDiTConfig, init_mmdit_params, mmdit_forward
from .vae import (VaeConfig, init_vae_decoder_params, latents_to_patches,
                  patches_to_latents, vae_decode)

__all__ = [n for n in dir() if not n.startswith("_")]
