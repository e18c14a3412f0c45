"""The FP8 dequant kernel (csrc/fp8_dequant.cu) against its plain version
on the card, bf16 and float32, at every shape of chip_smoke.py's phase
14(a): bit for bit (NaN at the same places), twice launched, and through
the counted wrapper. Every test is marked `cuda` and skips without a
card. This file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_fp8_card.py -m cuda -s --noconftest
"""
import pytest
import torch

from cake_tpu_torch.bench.fp8_cases import SHAPES, fp8_case, same_bits
from cake_tpu_torch.ops import fp8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", SHAPES, ids=[c[0] for c in SHAPES])
def test_fp8_dequant_kernel_matches_plain_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, o, i = case
    w, s = fp8_case(o, i, seed=o + i)
    first = fp8.dequant_fp8_blockwise_kernel(w, s, dtype)
    second = fp8.dequant_fp8_blockwise_kernel(w, s, dtype)
    torch.cuda.synchronize()
    want = fp8.dequant_fp8_blockwise_plain(w, s, dtype)
    assert same_bits(first, want) and torch.equal(
        first.view(torch.uint8), second.view(torch.uint8))
    before = fp8.launch_counts()[fp8.ROUTES[dtype]]
    counted = fp8.dequant_fp8_blockwise(w, s, dtype)
    assert fp8.launch_counts()[fp8.ROUTES[dtype]] == before + 1
    assert same_bits(counted, want)


@pytest.mark.cuda
def test_fp8_dequant_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, s = fp8_case(256, 256)
    # float16 is a route since module 16: float64 stands for a dtype the
    # kernel does not write
    for args in ((w, s, torch.float64), (w.t(), s, torch.bfloat16),
                 (w, s[:1], torch.bfloat16),
                 (w.view(torch.uint8), s, torch.bfloat16)):
        with pytest.raises(ValueError):
            fp8.dequant_fp8_blockwise(*args)
