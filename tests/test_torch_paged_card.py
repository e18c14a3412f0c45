"""The paged decode kernel (csrc/paged_decode.cu) against its plain version
on the card, bf16 and float32, in every case of chip_smoke.py's phase 3;
a row bit-identical alone, in a batch and after its blocks move; two
launches bit-identical; and a second pool between two calls on a first.
Every test is marked `cuda` and skips without a card. This file imports no
JAX, so it runs on the card's machine, which has none:

    python -m pytest tests/test_torch_paged_card.py -m cuda -s --noconftest

Tolerances: bf16 2e-2 (the output rounded to bf16, ulp 2^-7 near 1, and
another summation order than the plain version's); float32 1e-4
(summation order only). Rows with no visible key are don't-care and are
left out of the comparison."""
import pytest
import torch

from cake_tpu_torch.bench.paged_cases import CARD_CASES, case_args, paged_case
from cake_tpu_torch.ops import paged_attention as pa


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_paged_kernel_matches_plain_on_card(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name, spec = case
    c = paged_case(dtype=dtype, device="cuda", **spec)
    got = pa.paged_decode_attention_kernel(*case_args(c))
    torch.cuda.synchronize()
    want = pa.paged_decode_attention_ref(*case_args(c))
    rows = c["visible_rows"]
    err = (got[rows].float() - want[rows].float()).abs().max().item()
    print(f"paged decode card case {name} {pa.kernel_route(dtype)} "
          f"max_abs_err {err:.3e} (tol {tol:g})")
    assert torch.isfinite(got).all().item()
    assert err <= tol


@pytest.mark.cuda
def test_paged_kernel_row_is_independent_of_batch():
    """A row's output is bit-identical alone and in a batch, and after its
    blocks move to other physical ids (what a swap does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = paged_case([15, 620, 4000], dtype=torch.bfloat16, device="cuda")
    q, k, v, pos, tables, frontier = case_args(c)
    both = pa.paged_decode_attention_kernel(q, k, v, pos, tables, frontier)
    alone = pa.paged_decode_attention_kernel(q[1:2], k, v, pos, tables[1:2],
                                             frontier[1:2])
    assert torch.equal(both[1:2], alone)
    # copy row 1's blocks, in table order, past the end of the pool and
    # add a new sink after them
    live = tables[1][tables[1] < c["null"]].long()
    n = k.shape[0]

    def moved_pool(x, fill):
        sink = torch.full_like(x[:1], fill)
        return torch.cat([x, x[live], sink])
    k2, v2, pos2 = moved_pool(k, 0), moved_pool(v, 0), moved_pool(pos, -1)
    t2 = torch.full_like(tables[1:2], k2.shape[0] - 1)
    t2[0, :live.numel()] = torch.arange(n, n + live.numel(), device="cuda")
    moved = pa.paged_decode_attention_kernel(q[1:2], k2, v2, pos2, t2,
                                             frontier[1:2])
    assert torch.equal(moved, alone)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_paged_kernel_is_bit_identical_across_launches(dtype):
    """Two launches on the same inputs give the same bits: no atomics, no
    state left in device memory, a fixed order for every sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = paged_case([5, 127, 128, 620, 4000], dtype=dtype, device="cuda",
                   null_rows=1, stale=True, shared=True)
    first = pa.paged_decode_attention_kernel(*case_args(c))
    second = pa.paged_decode_attention_kernel(*case_args(c))
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_paged_kernel_follows_a_second_pool_between_calls():
    """A call on another pool (another size, address and block size)
    between two calls on the first gives each pool its own result: the
    kernel's tensor maps are the call's own, never a stale cached one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = paged_case([15, 620, 4000], dtype=torch.bfloat16, device="cuda")
    b = paged_case([100, 1060], dtype=torch.bfloat16, device="cuda", bt=64,
                   seed=9)
    assert a["k"].shape != b["k"].shape
    first = pa.paged_decode_attention_kernel(*case_args(a))
    other = pa.paged_decode_attention_kernel(*case_args(b))
    again = pa.paged_decode_attention_kernel(*case_args(a))
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    want = pa.paged_decode_attention_ref(*case_args(b))
    assert (other.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_paged_kernel_d256_is_bit_identical_across_launches(dtype):
    """Gemma-3-1B's shape (4/1, D 256, bt 16): two launches give the same
    bits, and the plan the wrapper passed is the card's to grant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = paged_case([5, 127, 128, 620, 4000], dtype=dtype, device="cuda",
                   hq=4, hkv=1, d=256, null_rows=1, stale=True)
    first = pa.paged_decode_attention_kernel(*case_args(c))
    second = pa.paged_decode_attention_kernel(*case_args(c))
    assert torch.equal(first, second)
    assert pa.active_clusters(*case_args(c)) >= 1


@pytest.mark.cuda
def test_c_entry_refuses_other_head_dims():
    """The C entry point names each head dimension it was built for: D 96
    (with a plan the shared-memory check accepts) returns an error, it
    does not run another instantiation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cake_tpu_torch.kernels.build import load_library
    lib = load_library(pa.LIBRARY, pa._bind)
    for dtype in (torch.bfloat16, torch.float32):
        c = paged_case([20, 40], dtype=dtype, device="cuda", hq=4, hkv=2,
                       d=96)
        plan = pa.PagedPlan(pa.kernel_route(dtype), 2, 2, 2, 96, 16,
                            c["tables"].shape[1])
        out = torch.empty_like(c["q"])
        args = list(pa._kernel_args(*case_args(c), out, None, plan))
        assert lib.cake_paged_decode_fwd(*args) != 0
        torch.cuda.synchronize()
