"""FLUX.2-klein (module 14c) on the card: the tiny pipeline with a tiny
Qwen3 encoder, seeded on the card in float32 with TF32 off, against the
same weights on the CPU (the encoder's captures, one flux2_forward and 3
Euler steps within 1e-4 of the largest magnitude: summation order
only), and in bf16 a finite image. No hand-written kernel runs on this
path (the flash launch counts stay put). Every test is marked `cuda` and
skips without a card. This file imports no JAX, so it runs on the card's
machine:

    python -m pytest tests/test_torch_flux2_card.py -m cuda -s --noconftest
"""
import numpy as np
import pytest
import torch

from cake_tpu_torch.models.image import (Flux2ImageModel, Flux2TextEncoder,
                                         seeded_flux2, tiny_flux2_config)
from cake_tpu_torch.ops import flash

TOL = 1e-4
ENCODER = dict(architectures=["Qwen3ForCausalLM"], vocab_size=1024,
               hidden_size=32, intermediate_size=64, num_hidden_layers=4,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=128)


def _tree(tree, device):
    if tree is None:                # a VAE level with no upsample
        return None
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, device) for v in tree]
    return tree.to(device)


def _cfgs():
    pipe = tiny_flux2_config()
    return {"flux2": pipe.transformer, "vae": pipe.vae, "encoder": ENCODER,
            "output_layers": (0, 1, 2)}


def _rel(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
def test_card_matches_cpu_in_float32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = seeded_flux2(_cfgs(), torch.float32, "cuda", seed=3,
                            max_txt_len=16)
        enc = card.text_encoder
        cpu = Flux2ImageModel(
            card.cfg, params=_tree(card.params, "cpu"),
            text_encoder=Flux2TextEncoder(
                enc.cfg, _tree(enc.params, "cpu"), tokenizer=enc.tokenizer,
                max_len=16, output_layers=(0, 1, 2), pad_id=enc.pad_id,
                dtype=torch.float32),
            dtype=torch.float32, device="cpu")
        before = flash.launch_counts()
        ids, real = enc.token_ids("a fox")
        want_txt = cpu.text_encoder.encode_ids(ids, real)
        assert _rel(enc.encode_ids(ids, real), want_txt) < TOL
        noise = torch.randn((1, 8 * 8, 16), generator=torch.Generator()
                            .manual_seed(1))          # 32 x 32: an 8 x 8 grid
        want = cpu.denoise("a fox", 32, 32, 3, noise=noise, text=want_txt)
        got = card.denoise("a fox", 32, 32, 3, noise=noise, text=want_txt)
        assert _rel(got, want) < TOL
        assert flash.launch_counts() == before
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.cuda
def test_bf16_image_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = seeded_flux2(_cfgs(), torch.bfloat16, "cuda", seed=4)
    assert model.params["vae"]["conv_in"]["weight"].dtype == torch.float32
    img = np.asarray(model.generate_image("a fox", 48, 40, steps=2, seed=2))
    assert img.shape == (40, 48, 3) and img.std() > 0
