"""FLUX.1 (module 14a) on the card: the FP8 dequant kernel
(csrc/fp8_dequant.cu) against its plain version at every FLUX.1-dev weight
shape, bf16 (the served dtype), with blockwise scales and with one
per-tensor scale broadcast over the grid (a scaled-FP8 checkpoint read
natively), bit for bit, twice launched, and counted through the wrapper;
and the tiny FLUX.1 pipeline with native FP8 weights on the card equal to
the same weights dequantized at load, with one launch per FP8 weight per
step. Every test is marked `cuda` and skips without a card. This file
imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_image_card.py -m cuda -s --noconftest
"""
import pytest
import torch

from cake_tpu_torch.bench.fp8_cases import (FLUX_SHAPES, fp8_case,
                                            per_tensor_case, same_bits)
from cake_tpu_torch.ops import fp8


@pytest.mark.cuda
@pytest.mark.parametrize("scales", ["blockwise", "per_tensor"])
@pytest.mark.parametrize("case", FLUX_SHAPES, ids=[c[0] for c in FLUX_SHAPES])
def test_dequant_kernel_at_flux_shapes_matches_plain(case, scales):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, o, i = case
    make = fp8_case if scales == "blockwise" else per_tensor_case
    w, s = make(o, i, seed=o + 3 * i)
    first = fp8.dequant_fp8_blockwise_kernel(w, s, torch.bfloat16)
    second = fp8.dequant_fp8_blockwise_kernel(w, s, torch.bfloat16)
    torch.cuda.synchronize()
    want = fp8.dequant_fp8_blockwise_plain(w, s, torch.bfloat16)
    assert same_bits(first, want) and torch.equal(
        first.view(torch.uint8), second.view(torch.uint8))
    before = fp8.launch_counts()["bf16"]
    assert same_bits(fp8.dequant_fp8_blockwise(w, s, torch.bfloat16), want)
    assert fp8.launch_counts()["bf16"] == before + 1


@pytest.mark.cuda
def test_tiny_flux_native_equals_at_load_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cake_tpu_torch.models.image import seeded_flux1, tiny_flux_config
    from cake_tpu_torch.models.text_encoders import (tiny_clip_config,
                                                     tiny_t5_config)
    from cake_tpu_torch.utils.mapping import dequant_at_load
    pipe = tiny_flux_config()
    cfgs = dict(mmdit=pipe.mmdit, vae=pipe.vae, clip=tiny_clip_config(),
                t5=tiny_t5_config())
    model = seeded_flux1(cfgs, torch.bfloat16, "cuda", seed=5,
                         fp8_native=True)
    fp8.reset_launches()
    native = model.denoise("w1 w2", 64, 64, steps=2, seed=1)
    assert fp8.launch_counts()["bf16"] == 2 * 36     # 2x10 + 2x3 + 10
    tree = model.params["transformer"]

    def at_load(node):
        if fp8.is_fp8(node):
            return dequant_at_load(node["fp8"], node["scale_inv"][0, 0],
                                   torch.bfloat16)
        if isinstance(node, dict):
            return {k: at_load(v) for k, v in node.items()}
        if isinstance(node, list):
            return [at_load(v) for v in node]
        return node
    model.params["transformer"] = at_load(tree)
    loaded = model.denoise("w1 w2", 64, 64, steps=2, seed=1)
    assert torch.equal(native.view(torch.int16), loaded.view(torch.int16))
    assert torch.isfinite(native).all()
