"""The port's modality map (models/registry.py) against the reference's
(cake_tpu/models/registry.py): the same text families, image and audio
architectures and modality for every architecture string; and every
entry names a family the port serves: each text family's tiny config
builds a TextModel that generates, each image architecture's seeded demo
builds through runtime.build_image_model and each audio architecture's
through runtime.build_audio_model, all on the CPU."""
import gc

import pytest
import torch

from cake_tpu.models import registry as jreg
from cake_tpu_torch.models import registry as treg
from cake_tpu_torch.models.common.config import tiny_config
from cake_tpu_torch.models.common.text_model import TextModel
from cake_tpu_torch.runtime import build_audio_model, build_image_model

torch.set_num_threads(1)

# the seeded demo of each family
IMAGE_DEMOS = {"flux1": ("demo:flux", "FluxImageModel"),
               "flux2": ("demo:flux2", "Flux2ImageModel"),
               "sd": ("demo:sd", "SDImageModel")}
AUDIO_DEMOS = {"vibevoice": ("demo:vibevoice", "VibeVoiceTTS"),
               "luxtts": ("demo:luxtts", "LuxTTS")}


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


def test_map_equals_the_reference():
    assert treg.TEXT_FAMILIES == jreg.TEXT_FAMILIES
    assert treg.IMAGE_ARCHS == jreg.IMAGE_ARCHS
    assert treg.AUDIO_ARCHS == jreg.AUDIO_ARCHS
    for arch in (*jreg.IMAGE_ARCHS, *jreg.AUDIO_ARCHS, "Qwen3ForCausalLM",
                 "LlamaForCausalLM", "", "Unknown"):
        assert treg.modality_for_arch(arch) == jreg.modality_for_arch(arch)
    assert set(IMAGE_DEMOS) == set(treg.IMAGE_ARCHS.values())
    assert set(AUDIO_DEMOS) == set(treg.AUDIO_ARCHS.values())


@pytest.mark.parametrize("family", treg.TEXT_FAMILIES)
def test_every_text_family_is_served(family):
    cfg = tiny_config(family, num_hidden_layers=2)
    model = TextModel(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens, _ = model.generate([1, 5, 9], max_new_tokens=2, spec=False)
    assert 1 <= len(tokens) <= 2


@pytest.mark.parametrize("family", sorted(IMAGE_DEMOS))
def test_every_image_family_is_served(family):
    name, cls = IMAGE_DEMOS[family]
    assert type(build_image_model(name, "f32", device="cpu")).__name__ == cls


@pytest.mark.parametrize("family", sorted(AUDIO_DEMOS))
def test_every_audio_family_is_served(family):
    name, cls = AUDIO_DEMOS[family]
    model = build_audio_model(name, "f32", device="cpu")
    assert type(model).__name__ == cls
