"""Both flash kernels against their plain version on the card: bf16 on
the tensor cores (csrc/flash_attn_wgmma.cu) and float32 on FMA
(csrc/flash_attn.cu). Every test is marked `cuda` and skips without a card.
This file imports no JAX, so it runs on the card's machine, which has none:

    python -m pytest tests/test_torch_flash_card.py -m cuda -s --noconftest

Tolerances: bf16 2e-2 (output rounding, ulp 2^-7 near 1, and P rounded to
bf16 before P.V, at most 2^-9 relative per weight); float32 1e-4
(summation order only)."""
import pytest
import torch

from cake_tpu_torch.ops import flash


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_kernel_matches_plain_on_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 300, 16, 128), generator=gen, device="cuda").to(dtype)
    pool = torch.randn((2, 1024, 8, 128), generator=gen,
                       device="cuda").to(dtype)
    for kw, k in ((dict(window=128), pool[:1, :300]),
                  (dict(q_offset=256, valid_len=300), pool[1:2])):
        got = flash.flash_attention_kernel(q, k, k, **kw)
        want = flash.flash_attention_ref(q, k, k, **kw)
        assert (got.float() - want.float()).abs().max().item() <= tol


# (name, spec) of card cases: GQA groups 1, 2, 3, 4 and 8, Sq in {1, 63,
# 64, 100, 256, 300}, causal=False, valid_len 200, windows, append over a
# strided pool view, D 64, batch 2; and the checkpoint families' shapes at
# their published widths (OLMo2 16/16 D 128, Phi-4-mini 24/8 D 128,
# EXAONE-4.0-1.2B 32/8 D 64 with its window of 4096), fresh and append
CARD_CASES = [
    ("g1_sq1", dict(sq=1, hq=8, hkv=8)),
    ("g2_sq63", dict(sq=63)),
    ("g4_sq64", dict(sq=64, hkv=4)),
    ("g2_sq100", dict(sq=100)),
    ("g2_sq256", dict(sq=256)),
    ("g4_sq300", dict(sq=300, hkv=4)),
    ("g1_sq300", dict(sq=300, hq=8, hkv=8)),
    ("g8_sq100", dict(sq=100, hkv=2)),
    ("g3_sq100", dict(sq=100, hq=12, hkv=4)),
    ("non_causal_sq300", dict(sq=300, causal=False)),
    ("valid200", dict(sq=256, valid_len=200)),
    ("window100_sq300", dict(sq=300, window=100)),
    ("append_pool", dict(sq=256, pool_rows=4096, q_offset=256,
                         valid_len=256)),
    ("append_pool_g4_ragged", dict(sq=100, hkv=4, pool_rows=1024,
                                   q_offset=70, valid_len=90)),
    ("d64_sq256", dict(sq=256, d=64)),
    ("d64_append_pool", dict(sq=128, d=64, pool_rows=1024, q_offset=300,
                             valid_len=128)),
    ("batch2_sq100", dict(b=2, sq=100)),
    ("olmo2_g1_sq256", dict(sq=256, hq=16, hkv=16)),
    ("olmo2_g1_append", dict(sq=256, hq=16, hkv=16, pool_rows=4096,
                             q_offset=256, valid_len=256)),
    ("phi4_g3_sq256", dict(sq=256, hq=24, hkv=8)),
    ("phi4_g3_append", dict(sq=256, hq=24, hkv=8, pool_rows=4096,
                            q_offset=256, valid_len=256)),
    ("exaone4_g4_d64_window4096", dict(sq=256, hq=32, hkv=8, d=64,
                                       window=4096)),
    ("exaone4_g4_d64_append", dict(sq=256, hq=32, hkv=8, d=64,
                                   pool_rows=4096, q_offset=256,
                                   valid_len=256)),
]


def _card_inputs(dtype, b=1, sq=256, hq=16, hkv=8, d=128, pool_rows=None,
                 **kw):
    """q, k, v on the card; with pool_rows, K/V are row 1 of a [3,
    pool_rows, Hkv, D] pool (a strided batch-1 view, as in append)."""
    gen = torch.Generator(device="cuda").manual_seed(sq * 131 + hq + d)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = rnd(b, sq, hq, d)
    if pool_rows:
        k, v = rnd(3, pool_rows, hkv, d)[1:2], rnd(3, pool_rows, hkv, d)[1:2]
    else:
        k, v = rnd(b, sq, hkv, d), rnd(b, sq, hkv, d)
    return q, k, v, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_cases_on_card(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name, spec = case
    q, k, v, kw = _card_inputs(dtype, **spec)
    got = flash.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash.flash_attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    print(f"flash card case {name} {flash.kernel_route(dtype)} "
          f"max_abs_err {err:.3e} (tol {tol:g})")
    assert torch.isfinite(got).all().item()
    assert err <= tol
