"""The modality map (counterpart of cake_tpu/models/registry.py:
TEXT_FAMILIES, IMAGE_ARCHS, AUDIO_ARCHS, modality_for_arch): an HF
architecture string to the path that serves it. Every text family is a
config adapter of models/common/config.py over the one block of
models/common/layers.py; the image pipelines are built by
runtime.build_image_model and the speech models by
runtime.build_audio_model. Every entry names a family the port serves.
"""
from __future__ import annotations

from .common.config import FAMILY_ADAPTERS

# the short family names, without the aliases of another family's adapter
TEXT_FAMILIES = tuple(sorted(set(FAMILY_ADAPTERS) - {"llama", "phi3"}))

IMAGE_ARCHS = {"FluxPipeline": "flux1", "Flux2Pipeline": "flux2",
               "StableDiffusionPipeline": "sd"}
AUDIO_ARCHS = {"VibeVoiceForConditionalGeneration": "vibevoice",
               "LuxTTSForTextToSpeech": "luxtts"}


def modality_for_arch(arch: str) -> str:
    """"image", "audio" or "text" (anything else is a text model)."""
    if arch in IMAGE_ARCHS:
        return "image"
    if arch in AUDIO_ARCHS:
        return "audio"
    return "text"
