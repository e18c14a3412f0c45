"""Both flash kernels against their plain version on the card: bf16 on
wgmma (csrc/flash_attn_wgmma.cu) and float32 on mma.sync in 3xTF32
(csrc/flash_attn.cu). Every test is marked `cuda` and skips without a card.
This file imports no JAX, so it runs on the card's machine, which has none:

    python -m pytest tests/test_torch_flash_card.py -m cuda -s --noconftest

Tolerances: bf16 2e-2 (output rounding, ulp 2^-7 near 1, and P rounded to
bf16 before P.V, at most 2^-9 relative per weight); float32 1e-4
(summation order, and the 3xTF32 split's dropped lo.lo term and rounded
lo, each about 2^-22 of a product)."""
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
# EXAONE-4.0-1.2B 32/8 D 64 with its window of 4096, Gemma-3-1B 4/1 D 256
# with its window of 512 over 600 queries), fresh and append; and D 256
# at groups 2 and 8
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
    ("gemma3_g4_d256_window512_sq600", dict(sq=600, hq=4, hkv=1, d=256,
                                            window=512)),
    ("gemma3_g4_d256_append", dict(sq=256, hq=4, hkv=1, d=256,
                                   pool_rows=4096, q_offset=256,
                                   valid_len=256)),
    ("d256_g2_sq100", dict(sq=100, hq=4, hkv=2, d=256)),
    ("d256_g8_append_ragged", dict(sq=100, hq=16, hkv=2, d=256,
                                   pool_rows=1024, q_offset=70,
                                   valid_len=90)),
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


@pytest.mark.cuda
def test_c_entries_refuse_other_head_dims():
    """Each C entry point names the head dimensions it was built for
    (64, 128, 256): D 96 returns an error, it does not run another
    instantiation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cake_tpu_torch.kernels.build import load_library
    q = torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(q)
    lib = load_library(flash.LIBRARIES["bf16"], flash._bind_wgmma)
    st = [s * 2 for s in (96, 192, 64 * 192)]   # head, seq, batch bytes
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.cake_flash_wgmma_fwd(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), 1, 64, 64,
        2, 2, 96, *(st * 4), 64, 288, 93288, 1.0, 1, 0, 0, 64, stream)
    assert err != 0
    qf = q.float()
    lib = load_library(flash.LIBRARIES["f32"], flash._bind_f32)
    st = [s * 4 for s in (96, 192, 64 * 192)]
    err = lib.cake_flash_attention_fwd(
        qf.data_ptr(), qf.data_ptr(), qf.data_ptr(), qf.data_ptr(), 1, 64,
        64, 2, 2, 96, *(st * 4), 16, 1, 128, 230496, 1.0, 1, 0, 0, 64,
        stream)
    assert err != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_wgmma_entry_refuses_a_plan_that_is_not_its_layout(d):
    """The bf16 entry point launches only with FlashPlan's threads and
    shared memory equal to its Layout<D>: a plan off by one byte or one
    warp returns an error and writes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cake_tpu_torch.kernels.build import load_library
    q = torch.randn((1, 64, 2, d), dtype=torch.bfloat16, device="cuda")
    plan = flash.plan_flash(q.shape, q.shape)
    lib = load_library(flash.LIBRARIES["bf16"], flash._bind_wgmma)
    st = list(flash.tma_strides(q, "q"))
    stream = torch.cuda.current_stream().cuda_stream
    for threads, smem in ((plan.threads, plan.smem_bytes + 1),
                          (plan.threads - 32, plan.smem_bytes)):
        out = torch.zeros_like(q)
        err = lib.cake_flash_wgmma_fwd(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), 1, 64,
            64, 2, 2, d, *(st * 4), plan.positions, threads, smem, 1.0, 1,
            0, 0, 64, stream)
        torch.cuda.synchronize()
        assert err != 0
        assert not out.any().item()
    got = flash.flash_attention_kernel(q, q, q)
    want = flash.flash_attention_ref(q, q, q)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_d256_is_bit_identical_across_launches(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, kw = _card_inputs(dtype, sq=600, hq=4, hkv=1, d=256,
                               window=512)
    first = flash.flash_attention_kernel(q, k, v, **kw)
    second = flash.flash_attention_kernel(q, k, v, **kw)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_f32_entry_refuses_a_plan_that_is_not_its_layout(d):
    """The float32 entry point launches only with F32FlashPlan's rows,
    threads and shared memory equal to its layout and a split of 1, 2 or
    4: a plan off by one byte, one warp, its rows or its split returns an
    error and writes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cake_tpu_torch.kernels.build import load_library
    q = torch.randn((1, 64, 2, d), device="cuda")
    plan = flash.plan_flash(q.shape, q.shape, route="f32")
    lib = load_library(flash.LIBRARIES["f32"], flash._bind_f32)
    st = list(flash.tma_strides(q, "q"))
    stream = torch.cuda.current_stream().cuda_stream
    for rows, split, threads, smem in (
            (plan.rows, 1, plan.threads, plan.smem_bytes + 1),
            (plan.rows, 1, plan.threads - 32, plan.smem_bytes),
            (plan.rows * 2, 1, plan.threads, plan.smem_bytes),
            (plan.rows, 3, plan.threads, plan.smem_bytes)):
        out = torch.zeros_like(q)
        err = lib.cake_flash_attention_fwd(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), 1, 64,
            64, 2, 2, d, *(st * 4), rows, split, threads, smem, 1.0, 1, 0,
            0, 64, stream)
        torch.cuda.synchronize()
        assert err != 0
        assert not out.any().item()
    got = flash.flash_attention_kernel(q, q, q)
    want = flash.flash_attention_ref(q, q, q)
    assert (got - want).abs().max().item() <= 1e-4


# float32 cases launched twice: D 64, 128 and 256, a window, append over a
# pool view, ragged valid_len, GQA groups 1 to 8
F32_TWICE = [
    ("d64_g4_window100", dict(sq=300, hq=16, hkv=4, d=64, window=100)),
    ("d128_g2_append_pool", dict(sq=256, pool_rows=4096, q_offset=256,
                                 valid_len=256)),
    ("d128_g3_ragged_valid90", dict(sq=100, hq=12, hkv=4, pool_rows=1024,
                                    q_offset=70, valid_len=90)),
    ("d256_g4_append_pool", dict(sq=256, hq=4, hkv=1, d=256,
                                 pool_rows=4096, q_offset=256,
                                 valid_len=256)),
    ("d256_g8_ragged_valid90", dict(sq=100, hq=16, hkv=2, d=256,
                                    pool_rows=1024, q_offset=70,
                                    valid_len=90)),
    ("d256_g1_valid200", dict(sq=256, hq=2, hkv=2, d=256, valid_len=200)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_TWICE, ids=[c[0] for c in F32_TWICE])
def test_f32_is_bit_identical_across_launches(case):
    """The float32 kernel merges its warps' partial softmax states in a
    fixed order: two launches give the same bits, within 1e-4 of the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, spec = case
    q, k, v, kw = _card_inputs(torch.float32, **spec)
    first = flash.flash_attention_kernel(q, k, v, **kw)
    second = flash.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = flash.flash_attention_ref(q, k, v, **kw)
    assert (first - want).abs().max().item() <= 1e-4


def _launch_f32(q, k, v, kw, split):
    """The float32 kernel with the plan's layout and a chosen split."""
    from cake_tpu_torch.kernels.build import load_library
    plan = flash.plan_flash(q.shape, k.shape, route="f32", **kw)
    lib = load_library(flash.LIBRARIES["f32"], flash._bind_f32)
    out = torch.empty_like(q)
    st = [x for t, n in ((q, "q"), (k, "k"), (v, "v"), (out, "o"))
          for x in flash.tma_strides(t, n)]
    b, s, hq, d = q.shape
    flash._raise_on(lib.cake_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
        k.shape[1], hq, k.shape[2], d, *st, plan.rows, split, plan.threads,
        plan.smem_bytes, flash.LOG2E / d ** 0.5, int(plan.causal),
        plan.window, plan.q_offset, plan.kv_len,
        torch.cuda.current_stream().cuda_stream))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_TWICE, ids=[c[0] for c in F32_TWICE])
def test_f32_cluster_split_matches_one_cta(case):
    """Each row group split over a cluster of 2 CTAs (rank 0 merging the
    ranks' partial states) gives the plain version's result within 1e-4,
    the same bits on two launches, and one CTA per group's within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, spec = case
    q, k, v, kw = _card_inputs(torch.float32, **spec)
    want = flash.flash_attention_ref(q, k, v, **kw)
    one = _launch_f32(q, k, v, kw, 1)
    first = _launch_f32(q, k, v, kw, 2)
    second = _launch_f32(q, k, v, kw, 2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert (first - want).abs().max().item() <= 1e-4
    assert (first - one).abs().max().item() <= 1e-4
