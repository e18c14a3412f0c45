"""VibeVoice (module 14d) on the card: the tiny model seeded on the card
in float32 with TF32 off against the same weights on the CPU, one whole
generate_speech from the same per-frame noise (the same frame count, the
latents and the waveform within 1e-4 of the largest magnitude: summation
order only, over 4 frames), and in bf16 (the VAE float32) finite speech
from a cloned WAV. No hand-written kernel runs on this path. Every test
is marked `cuda` and skips without a card. This file imports no JAX, so
it runs on the card's machine:

    python -m pytest tests/test_torch_vibevoice_card.py -m cuda -s \
        --noconftest
"""
import numpy as np
import pytest
import torch

from cake_tpu_torch.models.audio import VibeVoiceTTS, tiny_tts_config
from cake_tpu_torch.ops import flash
from cake_tpu_torch.utils.wav import encode_wav

TOL = 1e-4


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
def test_card_matches_cpu_in_float32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = VibeVoiceTTS(tiny_tts_config(), dtype=torch.float32, seed=2,
                            device="cuda")
        cpu = VibeVoiceTTS(tiny_tts_config(), params=_tree(
            {k: v for k, v in card.params.items()}, "cpu"),
            dtype=torch.float32, device="cpu")
        gen = torch.Generator().manual_seed(5)
        noise = [torch.randn((1, 16), generator=gen) for _ in range(4)]
        seen = {}
        for key, m in (("card", card), ("cpu", cpu)):
            real = m.decode_latents
            m.decode_latents = (lambda lat, real=real, key=key: (
                seen.__setitem__(key, lat.cpu()), real(lat))[1])
        before = flash.launch_counts()
        got = card.generate_speech("hello there", max_frames=4,
                                   frame_noise=noise).samples
        want = cpu.generate_speech("hello there", max_frames=4,
                                   frame_noise=noise).samples
        assert seen["card"].shape == seen["cpu"].shape == (1, 4, 16)
        assert float((seen["card"] - seen["cpu"]).abs().max()
                     / seen["cpu"].abs().max()) < TOL
        assert np.abs(got - want).max() / np.abs(want).max() < TOL
        assert flash.launch_counts() == before
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.cuda
def test_bf16_clone_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = VibeVoiceTTS(tiny_tts_config(), dtype=torch.bfloat16, seed=3,
                         device="cuda")
    wav = encode_wav(np.sin(np.linspace(0, 60, 16 * 8)).astype(np.float32),
                     16000)
    out = model.generate_speech("hi there", voice_wav=wav, max_frames=3)
    assert len(out.samples) == 3 * 16 and np.isfinite(out.samples).all()
