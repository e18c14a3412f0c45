"""Qwen3-Next's shapes on the card: both flash routes at a GQA group of 8
and D 256 (16/2 heads; fresh, a ragged valid length, append, and the
device-meta form against the host-int form), the paged decode kernel on
decode rows and on a verify's flattened rows at the same heads, the MoE
routes (the grouped GEMM captured in a CUDA graph equal to its eager run
and to the gathered route; a row's bits independent of the other rows),
and a small bf16 hybrid (linear and gated full layers, routed experts
with a shared expert) whose captured decode step, verify and prefill
programs equal their eager runs, contiguous and paged, conv and
recurrent state included. Every test is marked `cuda` and skips without
a card. This file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_qwen3_next_card.py -m cuda -s --noconftest

Tolerances: bf16 2e-2 (output rounding and another summation order than
the plain version's), float32 1e-4 (summation order)."""
import pytest
import torch

from cake_tpu_torch.bench import flash_meta
from cake_tpu_torch.bench.graph_cases import (build_state, graph_vs_eager,
                                              prefill_vs_eager)
from cake_tpu_torch.bench.paged_cases import case_args as decode_args
from cake_tpu_torch.bench.paged_cases import paged_case
from cake_tpu_torch.bench.spec_cases import (case_args, verify_case,
                                             verify_vs_eager)
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops import flash, moe
from cake_tpu_torch.ops import paged_attention as pa
from cake_tpu_torch.ops.sampling import SamplingConfig

HEADS = dict(hq=16, hkv=2, d=256)
ROUTES = [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)]
GREEDY = SamplingConfig(temperature=0.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rnd(gen, dtype, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ROUTES, ids=["bf16", "f32"])
@pytest.mark.parametrize("kw", [{}, dict(valid_len=200),
                                dict(q_offset=256, valid_len=256)],
                         ids=["fresh", "valid200", "append"])
def test_flash_group8_d256(kw, dtype, tol):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = _rnd(gen, dtype, 1, 256, 16, 256)
    skv = 4096 if kw.get("q_offset") else 256
    k, v = _rnd(gen, dtype, 1, skv, 2, 256), _rnd(gen, dtype, 1, skv, 2, 256)
    got = flash.flash_attention_kernel(q, k, v, **kw)
    again = flash.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (got.float() - flash.flash_attention_ref(q, k, v, **kw).float()
           ).abs().max().item()
    print(f"flash 16/2 D 256 {kw} {flash.kernel_route(dtype)}: {err:.3e}")
    assert err <= tol and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ROUTES, ids=["bf16", "f32"])
@pytest.mark.parametrize("mode,off,vl", [("fresh", 0, 200),
                                         ("append", 256, 256),
                                         ("append", 256, 200)])
def test_flash_meta_group8_d256(mode, off, vl, dtype, tol):
    _card()
    r = flash_meta.check(flash_meta.meta_case(
        f"g8_{mode}{off}_{vl}", 256, 16, 2, mode, off, vl, dtype))
    assert r["finite"] and r["max_abs_err"] <= tol
    assert r["same_as_host_int"] and r["same_twice"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ROUTES, ids=["bf16", "f32"])
def test_paged_decode_and_verify_group8_d256(dtype, tol):
    _card()
    c = paged_case([600, 1100, 40, 2000], dtype=dtype, device="cuda",
                   seed=3, stale=True, shared=True, **HEADS)
    got = pa.paged_decode_attention_kernel(*decode_args(c))
    again = pa.paged_decode_attention_kernel(*decode_args(c))
    torch.cuda.synchronize()
    rows = c["visible_rows"]
    want = pa.paged_decode_attention_ref(*decode_args(c))
    assert (got[rows].float() - want[rows].float()).abs().max() <= tol
    assert torch.equal(got, again)
    s = 7
    c = verify_case([(620, s), (15, s), (300, 4), (40, 1), None], s,
                    dtype=dtype, device="cuda", seed=3, shared=True, **HEADS)
    args = case_args(c)
    got = pa.paged_verify_attention_kernel(*args)
    again = pa.paged_verify_attention_kernel(*args)
    torch.cuda.synchronize()
    vis = c["visible"].to("cuda")
    err = (got.float() - pa.paged_verify_attention_ref(*args).float()
           )[vis].abs().max()
    assert err <= tol and torch.equal(got, again)


@pytest.mark.cuda
def test_moe_grouped_graph_equals_eager_and_gathered():
    """At Qwen3-Next's expert widths (512 x 512 x 2048, top 10) in bf16: a
    256-token chunk's grouped route replayed from a CUDA graph equals its
    eager run and the gathered route, bit for bit; a row's gathered result
    does not depend on the other rows."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    e, i, h, k = 512, 512, 2048, 10
    bank = [_rnd(gen, torch.bfloat16, *shape) * 0.02
            for shape in ((e, h), (e, i, h), (e, i, h), (e, h, i))]
    x = _rnd(gen, torch.bfloat16, 256, h)
    eager = moe.moe_ffn(x, *bank, k, True, route="grouped")
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_ffn(static, *bank, k, True, route="grouped")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.moe_ffn(static, *bank, k, True, route="grouped")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.equal(eager, moe.moe_ffn(x, *bank, k, True,
                                          route="gathered"))
    rows = x[:4].clone()
    alone = torch.zeros_like(rows)
    alone[2] = rows[2]
    assert torch.equal(moe.moe_ffn(rows, *bank, k, True)[2],
                       moe.moe_ffn(alone, *bank, k, True)[2])


@pytest.fixture(scope="module")
def hybrid():
    _card()
    cfg = tiny_config("qwen3_5_moe", vocab_size=512, hidden_size=256,
                      num_attention_heads=16, num_key_value_heads=2,
                      head_dim=256, linear_num_key_heads=2,
                      linear_key_head_dim=64, linear_num_value_heads=4,
                      linear_value_head_dim=64, num_experts=16,
                      num_experts_per_tok=4, moe_intermediate_size=64,
                      shared_expert_intermediate_size=64,
                      max_position_embeddings=1024, eos_token_id=None)
    assert [s.kind for s in cfg.layer_specs()] == ["linear"] * 3 + ["full"]
    return TextModel(cfg, dtype=torch.bfloat16, device="cuda", seed=2)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_blocks", [0, 256], ids=["contiguous", "paged"])
def test_hybrid_graphs_equal_eager(hybrid, kv_blocks):
    state = build_state(hybrid, [300, 100, None, 520], [GREEDY] * 4, 1024,
                        kv_blocks=kv_blocks, headroom=256)
    r = graph_vs_eager(hybrid, state.clone(), 12)
    assert r["graph"].graph is not None
    assert r["tokens_equal"] and r["kv_equal"] and r["carries_equal"]
    v = verify_vs_eager(hybrid, state, 4, 6, ["right", "wrong", None, None],
                        True)
    assert v["equal"] and v["kv_equal"] and v["carries_equal"]
    assert v["accepted"][0] > 0 and v["accepted"][1] == 0
    ids = torch.randint(0, 512, (520,),
                        generator=torch.Generator().manual_seed(4)).tolist()
    case = prefill_vs_eager(hybrid, ids, slot=2, slots=4, ctx=1024,
                            kv_blocks=kv_blocks, strict=True)
    assert all(x["logits_equal"] for x in case.results) and case.kv_equal
