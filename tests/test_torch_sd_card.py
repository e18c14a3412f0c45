"""SD 1.x / 2.x / SDXL (module 14b) on the card: the tiny families of
bench/synth_sd.py in float32 with TF32 off, the UNet's output and a
3-step latent from the same noise against the same model on the CPU
(within 1e-4 and 1e-3 of the largest magnitude: cuDNN's and cuBLAS's
sum order), a directory written and loaded through
runtime.build_image_model equal to the seeded model bit for bit, and a
bf16 img2img image. SD runs no hand-written kernel (its attention is the
reference's plain float32 one). Every test is marked `cuda` and skips
without a card. This file imports no JAX, so it runs on the card's
machine:

    python -m pytest tests/test_torch_sd_card.py -m cuda -s --noconftest
"""
import contextlib

import numpy as np
import pytest
import torch

from cake_tpu_torch.bench import synth_sd as ss


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _rel(got, want) -> float:
    want = want.float().cpu()
    return float((got.float().cpu() - want).abs().max()
                 / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ss.FAMILIES))
def test_tiny_family_on_card_equals_cpu(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cake_tpu_torch.models.image import sd as tsd
    from cake_tpu_torch.runtime import build_image_model
    fam = ss.tiny_family(name)
    cpu = ss.seeded_sd(fam, torch.float32, "cpu", seed=2)
    card = ss.seeded_sd(fam, torch.float32, "cpu", seed=2)
    card.params = _to(card.params, "cuda")
    for enc in (card.text_encoder, getattr(card, "text_encoder2", None)):
        if enc is not None:
            enc.params = _to(enc.params, "cuda")
    card.device = torch.device("cuda")
    noise = torch.randn((1, 4, 16, 16), generator=torch.Generator()
                        .manual_seed(1))
    with _no_tf32():
        ctx, added = cpu._encode_prompt("a fox", "blurry", 32, 32)
        t = torch.tensor([0.5, 0.5])
        x = torch.cat([noise, noise])
        want = tsd.unet_forward(cpu.cfg.unet, cpu.params["unet"], x, t, ctx,
                                added)
        got = tsd.unet_forward(card.cfg.unet, card.params["unet"],
                               x.cuda(), t.cuda(), ctx.cuda(),
                               None if added is None else added.cuda())
        assert _rel(got, want) < 1e-4
        want = cpu.denoise("a fox", 32, 32, 3, noise=noise,
                           negative_prompt="blurry")
        got = card.denoise("a fox", 32, 32, 3, noise=noise,
                           negative_prompt="blurry")
        assert _rel(got, want) < 1e-3
    d = str(tmp_path / name)
    ss.write_sd_checkpoint(d, fam, cpu)
    loaded = build_image_model(d, "f32")
    assert torch.equal(loaded.denoise("a fox", 32, 32, 2, noise=noise),
                       card.denoise("a fox", 32, 32, 2, noise=noise))


@pytest.mark.cuda
def test_bf16_img2img_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = ss.seeded_sd(ss.tiny_family("sdxl"), torch.bfloat16, "cuda")
    pixels = np.random.default_rng(0).integers(0, 256, (40, 28, 3),
                                               dtype=np.uint8)
    z = model.init_latent_from(pixels, 32, 32)
    image = model.generate_image("a fox", 32, 32, 4, init_image=z,
                                 strength=0.6)
    assert np.asarray(image).shape == (32, 32, 3)
    assert model.stats["steps"] == 3
