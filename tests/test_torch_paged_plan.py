"""The paged decode kernel's launch plan (`PagedPlan`), on the CPU.

The plan is the Python mirror of csrc/paged_decode.cu's work split: one
cluster of CLUSTER CTAs per (row, KV head), rank r walking the row's live
page blocks r, r + C, ... in ascending order, rank 0 merging the ranks in
order. These tests hold that every live block goes to exactly one rank,
that a row's split is the same alone and in a batch, that the shared
memory fits the card, and that the plan's summation order (an online
softmax per rank, then the merge in rank order) computes the plain
version's function. The kernel itself is checked on the card in
tests/test_torch_paged_card.py."""
import math
import re
from pathlib import Path

import pytest
import torch

from cake_tpu_torch.bench.paged_cases import CARD_CASES, case_args, paged_case
from cake_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)

SOURCE = Path(pa.__file__).resolve().parents[1] / "csrc" / "paged_decode.cu"
C = pa.CLUSTER


def _plan(batch=4, hkv=8, group=2, d=128, bt=16, ctx=4096, route="bf16"):
    return pa.PagedPlan(route, batch, hkv, group, d, bt, ctx // bt)


def _case_plan(spec: dict, route: str) -> pa.PagedPlan:
    s = {"bt": 16, "hq": 16, "hkv": 8, "d": 128, "ctx": 4096,
         "null_rows": 0, **spec}
    return pa.PagedPlan(route, len(s["frontiers"]) + s["null_rows"],
                        s["hkv"], s["hq"] // s["hkv"], s["d"], s["bt"],
                        s["ctx"] // s["bt"])


FRONTIERS = [-1, 0, 1, 6, 7, 8, 15, 16, 100, 127, 128, 270, 620, 1060,
             4000, 4095, 5000]


@pytest.mark.parametrize("bt", [16, 64])
@pytest.mark.parametrize("p", FRONTIERS)
def test_every_live_block_goes_to_one_rank_in_order(bt, p):
    plan = _plan(bt=bt)
    seen = []
    for r in range(C):
        blocks = plan.rank_blocks(r, p)
        assert blocks == sorted(blocks)
        assert all(j % C == r for j in blocks)
        seen += blocks
    assert sorted(seen) == list(range(plan.live_blocks(p)))
    keys = 0 if p < 0 else min(p + 1, 4096)
    assert plan.live_blocks(p) == -(-keys // bt)


@pytest.mark.parametrize("p", [0, 15, 127, 128, 620, 4000])
def test_a_rows_split_is_the_same_alone_and_in_a_batch(p):
    alone = pa.plan_paged((1, 1, 16, 128), (300, 16, 8, 128), (1, 256),
                          torch.bfloat16)
    batch = pa.plan_paged((6, 1, 16, 128), (300, 16, 8, 128), (6, 256),
                          torch.bfloat16)
    for r in range(C):
        assert alone.rank_blocks(r, p) == batch.rank_blocks(r, p)
    # everything the kernel receives besides the grid's batch is equal
    assert (alone.cluster, alone.stages, alone.smem_bytes) == \
        (batch.cluster, batch.stages, batch.smem_bytes)


@pytest.mark.parametrize("p,empty", [
    (-1, list(range(C))), (0, list(range(1, C))), (79, [5, 6, 7]),
    (8 * 16 - 1, []), (4000, [])])
def test_small_frontiers_leave_ranks_empty(p, empty):
    plan = _plan()
    assert plan.empty_ranks(p) == empty
    assert all(plan.rank_blocks(r, p) == [] for r in empty)


@pytest.mark.parametrize("name", ["cluster_edges_bt16", "cluster_edges_bt64"])
def test_cluster_edge_cases_cover_the_block_counts(name):
    spec = dict(CARD_CASES)[name]
    plan = _case_plan(spec, "bf16")
    counts = [plan.live_blocks(p) for p in spec["frontiers"]]
    assert counts == [1, C - 1, C, C + 1, 2 * C + 1]


@pytest.mark.parametrize("route", ["bf16", "f32"])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_shared_memory_fits_a_block(case, route):
    plan = _case_plan(case[1], route)
    assert 2 <= plan.stages <= pa.MAX_STAGES
    assert plan.smem_bytes <= pa.SMEM_LIMIT <= 227 * 1024
    assert plan.ctas_per_sm >= 1


@pytest.mark.parametrize("route,stages", [("bf16", 4), ("f32", 3)])
def test_flagship_shape_fits_two_ctas_per_sm(route, stages):
    """At least two CTAs per SM, and the ring as deep as leaves room for
    MIN_CTAS_PER_SM (three) of them."""
    plan = _plan(route=route)
    assert plan.grid == (C, 8, 4)
    assert plan.ctas_per_sm >= pa.MIN_CTAS_PER_SM >= 2
    assert plan.stages == stages
    deeper = pa.PagedPlan(route, 4, 8, 2, 128, 16, 256)
    assert deeper._ctas_per_sm(stages + 1) < pa.MIN_CTAS_PER_SM or \
        stages == pa.MAX_STAGES


def test_plan_refuses_block_sizes_the_kernel_does_not_take():
    for bt in (6, 512):
        with pytest.raises(ValueError, match="block"):
            pa.plan_paged((1, 1, 16, 128), (9, bt, 8, 128), (1, 4),
                          torch.bfloat16)


@pytest.mark.parametrize("route,smem", [("bf16", 82816), ("f32", 115584)])
def test_gemma3_shape_plan(route, smem):
    """Gemma-3-1B's decode shape (4 rows, Hq/Hkv 4/1, D 256, bt 16): the
    warps' states and the cluster's slots take 49 KB before the ring, so
    the plan falls to its floor of 2 stages, 2 CTAs per SM."""
    plan = pa.plan_paged((4, 1, 4, 256), (1025, 16, 1, 256), (4, 256),
                         getattr(torch, {"bf16": "bfloat16",
                                         "f32": "float32"}[route]))
    assert (plan.grid, plan.group, plan.stages) == ((C, 1, 4), 4, 2)
    assert plan.smem_bytes == smem <= pa.SMEM_LIMIT
    assert plan.ctas_per_sm == 2


def test_wrapper_refuses_head_dims_and_rings_the_kernel_cannot_take():
    for d in (64, 128, 256):
        pa.check_head_dim(d)
    for d in (32, 96, 512):
        with pytest.raises(ValueError, match="head_dim"):
            pa.check_head_dim(d)
    # float32 at bt 64, D 256: two stages of 64 KB K and V boxes
    with pytest.raises(ValueError, match="shared memory"):
        pa.plan_paged((1, 1, 4, 256), (9, 64, 1, 256), (1, 4),
                      torch.float32)
    assert pa.plan_paged((1, 1, 4, 256), (9, 64, 1, 256), (1, 4),
                         torch.bfloat16).stages == 2


def test_c_entry_names_each_head_dim():
    """The C entry dispatches 64, 128 and 256 to their own instantiations
    and has no branch that sends another D to one of them."""
    src = SOURCE.read_text()
    body = src[src.index("cudaError_t launch_dim("):]
    body = body[:body.index("\n}\n")]
    assert re.findall(r"case (\d+):", body) == ["64", "128", "256"]
    assert "default" not in body and "d == 128 ?" not in src
    assert "return cudaErrorInvalidValue;" in body


def test_kernel_constants_match_the_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))
    assert const("NW") == pa.CONSUMER_WARPS
    assert const("STEP_KEYS") == pa.STEP_KEYS
    assert const("MAX_G") == pa.MAX_GROUP
    assert const("SMEM_LIMIT") == pa.SMEM_LIMIT
    assert pa.CLUSTER <= const("MAX_CLUSTER")
    assert pa.MAX_STAGES <= const("MAX_STAGES")


# -- the plan's summation order against the plain version ---------------------


def emulate_plan(c: dict, plan: pa.PagedPlan) -> torch.Tensor:
    """The kernel's arithmetic at page-block granularity, in float32: per
    (row, KV head), each rank runs an online softmax (base 2) over its
    blocks in order, skipping unmapped entries and masking keys by the
    visibility rule; rank 0 merges the ranks' (m, l, acc) in rank order."""
    q, k, v, pos, tables, frontier = case_args(c)
    b, _, hq, d = q.shape
    bt, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    null = k.shape[0] - 1
    scale = 1.0 / math.sqrt(d) * math.log2(math.e)
    neg = torch.tensor(-math.inf)
    out = torch.zeros_like(q)
    for row in range(b):
        p = int(frontier[row])
        for kvh in range(hkv):
            qh = q[row, 0, kvh * g:(kvh + 1) * g] * scale         # [g, d]
            states = []
            for r in range(plan.cluster):
                m = torch.full((g,), -math.inf)
                l, acc = torch.zeros(g), torch.zeros(g, d)
                for j in plan.rank_blocks(r, p):
                    pid = int(tables[row, j])
                    if not 0 <= pid < null:
                        continue
                    ps = pos[pid]
                    vis = (ps >= 0) & (ps <= p) & (ps // bt == j)
                    s = torch.where(vis, qh @ k[pid, :, kvh].T, neg)
                    mn = torch.maximum(m, s.max(dim=1).values)
                    mu = torch.where(torch.isinf(mn), 0.0, mn)
                    alpha = torch.exp2(m - mu)
                    w = torch.exp2(s - mu[:, None])
                    l = l * alpha + w.sum(dim=1)
                    acc = acc * alpha[:, None] + w @ v[pid, :, kvh]
                    m = mn
                states.append((m, l, acc))
            mx = torch.stack([s[0] for s in states]).max(dim=0).values
            mu = torch.where(torch.isinf(mx), 0.0, mx)
            lsum, asum = torch.zeros(g), torch.zeros(g, d)
            for m, l, acc in states:                     # rank order
                w = torch.exp2(m - mu)
                lsum = lsum + l * w
                asum = asum + acc * w[:, None]
            out[row, 0, kvh * g:(kvh + 1) * g] = torch.where(
                lsum[:, None] > 0, asum / lsum[:, None], 0.0)
    return out


@pytest.mark.parametrize("spec", [
    dict(frontiers=[1, 15, 16, 70, 127], null_rows=1, bt=8, ctx=128),
    dict(frontiers=[5, 100, 127, 128, 270], ctx=512),
    dict(frontiers=[40, 300, 497], stale=True, shared=True, ctx=512),
    dict(frontiers=[63, 400, 511], bt=64, stale=True, ctx=1024),
    dict(frontiers=[33, 200], hq=4, hkv=4, bt=32, ctx=256),
], ids=["ragged_null_bt8", "cluster_edges", "stale_shared",
        "stale_bt64", "mha_bt32"])
def test_plan_summation_order_matches_plain(spec):
    kw = {"hq": 4, "hkv": 2, "d": 16, **spec}
    c = paged_case(**kw, seed=5)
    plan = pa.plan_paged(c["q"].shape, c["k"].shape, c["tables"].shape,
                         c["q"].dtype)
    got = emulate_plan(c, plan)
    want = pa.paged_decode_attention_ref(*case_args(c))
    rows = c["visible_rows"]
    assert (got[rows] - want[rows]).abs().max().item() <= 1e-5
    # an all-NULL row (no visible key) comes out as zeros
    for row in range(len(rows), got.shape[0]):
        assert torch.equal(got[row], torch.zeros_like(got[row]))

