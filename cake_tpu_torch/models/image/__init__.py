"""Image generation (counterpart of cake_tpu/models/image/): FLUX.1 (the
MMDiT, the VAE, the pipeline and its checkpoint loader), Stable Diffusion
1.x / 2.x / SDXL (the UNet, the pipelines and the diffusers loader) and
FLUX.2-klein (its transformer, Qwen3 encoder, pipeline and diffusers
loader)."""
from .flux import (DummyTextEncoder, FluxImageModel, FluxPipelineConfig,
                   tiny_flux_config, to_image)
from .flux_loader import (Flux1TextEncoder, detect_flux_checkpoint,
                          flux1_dev_configs, infer_flux_configs,
                          load_flux_image_model, load_flux_params,
                          mmdit_mapping, seeded_flux1,
                          vae_decoder_mapping)
from .flux2 import (DummyFlux2TextEncoder, Flux2Config, Flux2ImageModel,
                    Flux2PipelineConfig, Flux2TextEncoder, flux2_forward,
                    init_flux2_params, tiny_flux2_config)
from .flux2_loader import (detect_flux2_checkpoint, flux2_transformer_mapping,
                           flux2_vae_mapping, infer_flux2_configs,
                           klein_4b_configs, load_flux2_image_model,
                           seeded_flux2)
from .mmdit import MMDiTConfig, init_mmdit_params, mmdit_forward
from .sd import (SDImageModel, SDPipelineConfig, SDXLImageModel, UNetConfig,
                 init_unet_params, tiny_sd_config, unet_forward)
from .sd_loader import (SDTextEncoder, detect_sd_checkpoint,
                        load_sd_image_model, sd_configs_from_dir,
                        sd_unet_mapping, sd_vae_decoder_mapping,
                        sd_vae_encoder_mapping)
from .vae import (VaeConfig, init_vae_decoder_params,
                  init_vae_encoder_params, latents_to_patches,
                  patches_to_latents, vae_decode, vae_encode)

__all__ = [n for n in dir() if not n.startswith("_")]
