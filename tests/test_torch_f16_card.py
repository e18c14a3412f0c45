"""The three float16 kernel routes against their plain versions on the
card (module 16): the flash kernel's f16 entry (csrc/flash_attn_wgmma.cu,
wgmma .f16), in the host-int and the device-meta form; the paged decode
kernel's dtype code 2 (csrc/paged_decode.cu), decode and verify; and the
FP8 dequant kernel's f16 output (csrc/fp8_dequant.cu), bit for bit. Every
test is marked `cuda` and skips without a card. This file imports no JAX,
so it runs on the card's machine:

    python -m pytest tests/test_torch_f16_card.py -m cuda -s --noconftest

Tolerances: flash and paged 4e-3 (the f16 output's rounding, a spacing of
2^-10 near 1, and on the flash route P rounded to f16 before P.V, at most
2^-11 relative per weight); the dequant is exact."""
import pytest
import torch

from cake_tpu_torch.bench.fp8_cases import SHAPES, fp8_case, same_bits
from cake_tpu_torch.bench.paged_cases import CARD_CASES, case_args, paged_case
from cake_tpu_torch.ops import flash, fp8
from cake_tpu_torch.ops import paged_attention as pa

F16 = torch.float16
TOL = 4e-3

# (name, spec): the flagship's chunk fresh and append, GQA 1/2/3/4/8, D 64
# and 256, a window, a ragged append
FLASH_CASES = [
    ("flagship_fresh", dict(sq=256)),
    ("flagship_append", dict(sq=256, pool_rows=4096, q_offset=256,
                             valid_len=256)),
    ("g1_sq300", dict(sq=300, hq=8, hkv=8)),
    ("g3_sq100", dict(sq=100, hq=12, hkv=4)),
    ("g8_window100", dict(sq=300, hkv=2, window=100)),
    ("d64_append_ragged", dict(sq=128, d=64, pool_rows=1024, q_offset=300,
                               valid_len=90)),
    ("d256_g4_window512_sq600", dict(sq=600, hq=4, hkv=1, d=256,
                                     window=512)),
    ("d256_g4_append", dict(sq=256, hq=4, hkv=1, d=256, pool_rows=4096,
                            q_offset=256, valid_len=256)),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(b=1, sq=256, hq=16, hkv=8, d=128, pool_rows=None, **kw):
    gen = torch.Generator(device="cuda").manual_seed(sq * 131 + hq + d)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(F16)
    q = rnd(b, sq, hq, d)
    if pool_rows:
        k, v = rnd(3, pool_rows, hkv, d)[1:2], rnd(3, pool_rows, hkv, d)[1:2]
    else:
        k, v = rnd(b, sq, hkv, d), rnd(b, sq, hkv, d)
    return q, k, v, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_f16_route_matches_plain(case):
    _card()
    name, spec = case
    q, k, v, kw = _inputs(**spec)
    assert flash.kernel_route(q.dtype) == "f16"
    got = flash.flash_attention_kernel(q, k, v, **kw)
    again = flash.flash_attention_kernel(q, k, v, **kw)
    want = flash.flash_attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    print(f"flash f16 card case {name} max_abs_err {err:.3e} (tol {TOL:g})")
    assert got.dtype == F16 and torch.isfinite(got).all().item()
    assert torch.equal(got, again) and err <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fresh", "append"])
def test_flash_f16_device_meta_form_equals_host_int_form(mode):
    _card()
    q, k, v, _ = _inputs(sq=256, pool_rows=1024 if mode == "append" else None)
    if mode == "append":
        pool_k = torch.cat([k, k, k])
        meta = torch.tensor([1, 300, 200], dtype=torch.int32, device="cuda")
        got = flash.flash_attention_meta_kernel(q, pool_k, pool_k, meta,
                                                "append")
        want = flash.flash_attention_kernel(q, k, k, q_offset=300,
                                            valid_len=200)
    else:
        meta = torch.tensor([0, 0, 180], dtype=torch.int32, device="cuda")
        got = flash.flash_attention_meta_kernel(q, k, v, meta, "fresh")
        want = flash.flash_attention_kernel(q, k, v, valid_len=180)
    rows = 200 if mode == "append" else 180
    assert torch.equal(got[:, :rows], want[:, :rows])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_paged_f16_route_matches_plain(case):
    _card()
    name, spec = case
    c = paged_case(dtype=F16, device="cuda", **spec)
    assert pa.kernel_route(F16) == "f16"
    got = pa.paged_decode_attention_kernel(*case_args(c))
    want = pa.paged_decode_attention_ref(*case_args(c))
    rows = c["visible_rows"]
    err = (got[rows].float() - want[rows].float()).abs().max().item()
    print(f"paged f16 card case {name} max_abs_err {err:.3e} (tol {TOL:g})")
    assert got.dtype == F16 and err <= TOL


@pytest.mark.cuda
def test_paged_verify_f16_matches_plain():
    _card()
    from cake_tpu_torch.bench import spec_cases
    c = spec_cases.verify_case([(620, 7)] * 3 + [None], 7, dtype=F16,
                               device="cuda")
    got = pa.paged_verify_attention_kernel(*spec_cases.case_args(c))
    want = pa.paged_verify_attention_ref(*spec_cases.case_args(c))
    vis = c["visible"].to("cuda")
    err = (got[vis].float() - want[vis].float()).abs().max().item()
    assert got.dtype == F16 and err <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", SHAPES, ids=[c[0] for c in SHAPES])
def test_fp8_dequant_f16_output_is_bit_for_bit(case):
    _card()
    name, o, i = case
    w, s = fp8_case(o, i)
    got = fp8.dequant_fp8_blockwise_kernel(w, s, F16)
    want = fp8.dequant_fp8_blockwise_plain(w.cpu(), s.cpu(), F16)
    assert same_bits(got.cpu(), want)
