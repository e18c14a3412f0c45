"""LuxTTS (module 14d's remainder) on the card: the tiny model seeded on the
card in float32 with TF32 off against the same weights on the CPU, one
whole generate_speech from the same noise (the text condition, the Euler
output and the vocoder's log-magnitude within 1e-4 of the largest
magnitude, the waveform within 1e-3: summation order only), and in bf16
a directory written by bench/synth_luxtts.py loaded on the card (the
Vocos float32) speaking finite audio from a cloned 16 kHz WAV. No
hand-written kernel runs on this path. Every test is marked `cuda` and
skips without a card. This file imports no JAX, so it runs on the card's
machine:

    python -m pytest tests/test_torch_luxtts_card.py -m cuda -s \
        --noconftest
"""
import numpy as np
import pytest
import torch

from cake_tpu_torch.bench.synth_luxtts import write_luxtts_checkpoint
from cake_tpu_torch.models.audio import (LuxTTS, load_luxtts,
                                         tiny_luxtts_config)
from cake_tpu_torch.ops import flash
from cake_tpu_torch.utils.wav import encode_wav

TOL = 1e-4
WAV_TOL = 1e-3


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).float().cpu(), \
        torch.as_tensor(want).float().cpu()
    assert got.shape == want.shape
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
def test_card_matches_cpu_in_float32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = LuxTTS(tiny_luxtts_config(), dtype=torch.float32, seed=2,
                      device="cuda")
        cpu = LuxTTS(tiny_luxtts_config(), params=_tree(card.params, "cpu"),
                     dtype=torch.float32, device="cpu")
        text = "hello there, general"
        frames = len(cpu.phonemizer.tokenize(text))
        noise = torch.randn((1, frames, 16),
                            generator=torch.Generator().manual_seed(5))
        tc = {k: m.encode_text(text) for k, m in (("card", card),
                                                  ("cpu", cpu))}
        assert _rel(tc["card"], tc["cpu"]) < TOL
        seen = {}
        for key, m in (("card", card), ("cpu", cpu)):
            real = m.vocode
            m.vocode = (lambda x, real=real, key=key: (
                seen.__setitem__(key, (x.cpu(), *(t.cpu() for t in
                                                  real(x)))),
                real(x))[1])
        before = flash.launch_counts()
        got = card.generate_speech(text, steps=4, noise=noise).samples
        want = cpu.generate_speech(text, steps=4, noise=noise).samples
        for i, what in enumerate(("Euler output", "log-magnitude",
                                  "phase")):
            err = _rel(seen["card"][i], seen["cpu"][i])
            print(f"{what}: max rel err {err:.2e}")
            assert err < TOL, what
        err = _rel(got, want)
        print(f"waveform: max rel err {err:.2e}")
        assert len(got) == 2 * frames * 16 and err < WAV_TOL
        assert flash.launch_counts() == before
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.cuda
def test_bf16_directory_speaks_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = str(tmp_path / "lux")
    write_luxtts_checkpoint(d, LuxTTS(tiny_luxtts_config(),
                                      dtype=torch.bfloat16, seed=3,
                                      device="cuda"))
    model = load_luxtts(d, torch.bfloat16, device="cuda")
    assert model.params["vocos"]["embed"]["weight"].dtype == torch.float32
    assert model.params["embed"]["weight"].dtype == torch.bfloat16
    clip = encode_wav((0.3 * np.sin(np.arange(16000) * 0.05)).astype(
        np.float32), 16000)
    plain = model.generate_speech("hello there", steps=4, seed=1)
    cloned = model.generate_speech("hello there", voice_wav=clip, steps=4,
                                   seed=1)
    for out in (plain, cloned):
        assert out.sample_rate == 48000
        assert np.isfinite(out.samples).all()
        assert np.abs(out.samples).max() > 0
    assert not np.array_equal(plain.samples, cloned.samples)
