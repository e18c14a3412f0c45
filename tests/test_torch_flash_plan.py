"""The bf16 flash kernel's launch plan and the wrapper's routes, on the CPU.

The plan (`FlashPlan`) is the Python mirror of what
csrc/flash_attn_wgmma.cu computes per CTA: the packed (query index, head)
rows, the [lo, hi) range of K/V tiles it loads and which of those it masks.
These tests hold it against the plain version's mask: the tiles a CTA loads
cover every visible (query, key) pair, the tiles it skips are wholly
masked, and the tiles it leaves unmasked are wholly visible. The card tests
of the kernel itself are in tests/test_torch_flash.py (marked `cuda`)."""
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from cake_tpu_torch.ops import flash
from test_torch_flash import CASES

torch.set_num_threads(1)

CSRC = Path(flash.__file__).resolve().parents[1] / "csrc"

# (name, sq, skv, hq, hkv, kwargs): CASES of test_torch_flash.py, the
# flagship chunk in both modes, and windows whose edges fall inside tiles
PLAN_CASES = [(c[0], c[2], c[3], c[4], c[5], c[7]) for c in CASES] + [
    ("flagship_fresh", 256, 256, 16, 8, {}),
    ("flagship_append", 256, 4096, 16, 8, dict(q_offset=256, valid_len=256)),
    ("flagship_tail_valid", 256, 4096, 16, 8, dict(q_offset=512,
                                                    valid_len=88)),
    ("window_100_sq300", 300, 300, 8, 4, dict(window=100)),
    ("window_37_offset", 200, 1024, 8, 2, dict(window=37, q_offset=301,
                                                valid_len=150)),
    ("group4_sq100", 100, 100, 16, 4, {}),
    ("group3_sq100", 100, 100, 12, 4, dict(valid_len=90)),
    ("non_causal_limit", 300, 512, 16, 8, dict(causal=False, valid_len=260)),
    ("gemma3_fresh_window512", 600, 600, 4, 1, dict(window=512)),
    ("gemma3_append", 256, 4096, 4, 1, dict(q_offset=512, valid_len=256)),
]


def _plan(sq, skv, hq, hkv, kw, route="bf16"):
    return flash.plan_flash((1, sq, hq, 64), (1, skv, hkv, 64), route=route,
                            **kw)


def _check_tiles_cover(plan, sq, skv, kw):
    """The tiles each CTA loads cover every visible pair of its rows, the
    tiles it skips are wholly masked, and the tiles it leaves unmasked are
    wholly visible."""
    off, limit = flash._limits(sq, kw.get("valid_len"), kw.get("q_offset"))
    mask = flash.visible_mask(sq, skv, off, limit, kw.get("causal", True),
                              kw.get("window"))
    bk = plan.block_keys
    n_tiles = -(-skv // bk)
    for cta in range(plan.ctas):
        rows = sorted({i for r in range(plan.rows)
                       if (row := plan.row(cta, r)) is not None
                       for i in row[:1]})
        lo, hi = plan.tile_range(cta)
        assert 0 <= lo and hi <= n_tiles
        for kt in range(n_tiles):
            pairs = mask[rows, kt * bk:(kt + 1) * bk]
            if not lo <= kt < hi:
                assert not pairs.any(), (cta, kt, "skipped a visible pair")
            elif not plan.tile_masked(cta, kt):
                assert pairs.shape[1] == bk and pairs.all(), (cta, kt)


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_tiles_cover_every_visible_pair(case):
    _, sq, skv, hq, hkv, kw = case
    _check_tiles_cover(_plan(sq, skv, hq, hkv, kw), sq, skv, kw)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_f32_plan_tiles_cover_every_visible_pair(case, d):
    """The same for the float32 kernel's plan, whose CTAs hold 16 packed
    rows that may split a query's heads between two CTAs, and whose tiles
    hold 16 keys at D 128 and 256 and 32 at D 64."""
    _, sq, skv, hq, hkv, kw = case
    plan = flash.plan_flash((1, sq, hq, d), (1, skv, hkv, d), route="f32",
                            **kw)
    assert plan.block_keys == (32 if d == 64 else 16)
    _check_tiles_cover(plan, sq, skv, kw)


@pytest.mark.parametrize("sq,group", [(1, 1), (63, 2), (64, 1), (100, 2),
                                      (300, 4), (100, 3), (5, 64)])
def test_plan_rows_pack_each_query_and_head_once(sq, group):
    plan = flash.plan_flash((1, sq, 2 * group, 128), (1, sq, 2, 128))
    assert plan.positions == flash.BLOCK_ROWS // group
    seen = []
    for cta in range(plan.ctas):
        for r in range(flash.BLOCK_ROWS):
            row = plan.row(cta, r)
            if row is None:
                continue
            i, h = row
            # rows of one query index are its G heads, side by side
            assert (i, h) == (cta * plan.positions + r // group, r % group)
            seen.append(row)
    assert sorted(seen) == [(i, h) for i in range(sq) for h in range(group)]


@pytest.mark.parametrize("sq,group", [(1, 1), (63, 2), (64, 1), (100, 2),
                                      (300, 4), (100, 3), (5, 64), (7, 24),
                                      (33, 5)])
def test_f32_plan_rows_pack_each_query_and_head_once(sq, group):
    """Packed row R of a KV head is (R // G, R % G), 16 to a CTA: every
    (query, head) once, only rows past Sq * G are padding, and any group
    fits (the bf16 plan stops at 64)."""
    plan = flash.plan_flash((1, sq, 2 * group, 128), (1, sq, 2, 128),
                            route="f32")
    assert plan.rows == 16 and plan.ctas == -(-sq * group // 16)
    seen = []
    for cta in range(plan.ctas):
        for r in range(plan.rows):
            row = plan.row(cta, r)
            if row is None:
                assert cta * 16 + r >= sq * group
                continue
            assert row == divmod(cta * 16 + r, group)
            seen.append(row)
    assert sorted(seen) == [(i, h) for i in range(sq) for h in range(group)]


def test_plan_flagship_grid():
    fresh = _plan(256, 256, 16, 8, {})
    append = _plan(256, 4096, 16, 8, dict(q_offset=256, valid_len=256))
    assert (fresh.positions, fresh.ctas) == (32, 8)    # x 8 KV heads = 64
    assert fresh.tile_range(fresh.ctas - 1) == (0, 4)
    assert append.kv_len == 512
    assert append.tile_range(append.ctas - 1) == (0, 8)
    assert append.tile_range(0) == (0, 5)


@pytest.mark.parametrize("d,stages,smem,threads", [
    (64, 4, 93288, 288), (128, 4, 183400, 288), (256, 2, 164920, 384)])
def test_plan_shared_memory_by_head_dim(d, stages, smem, threads):
    """Layout<D> of the kernel: at D 256 a 4-slot ring of 32 KB K and V
    tiles would not fit, so the ring has 2 slots and the warpgroups'
    merge buffer reuses it, and the producer is a warpgroup that gives
    its registers to the consumers. Gemma-3-1B's chunk: 16 CTAs."""
    plan = flash.plan_flash((1, 256, 4, d), (1, 256, 1, d))
    assert (plan.stages, plan.smem_bytes, plan.threads) == \
        (stages, smem, threads)
    assert plan.smem_bytes <= flash.SMEM_LIMIT
    assert (plan.positions, plan.ctas) == (16, 16)


@pytest.mark.parametrize("d,keys,slots,smem", [
    (64, 32, 2, 74816), (128, 16, 2, 83008), (256, 16, 3, 230496)])
def test_f32_plan_shared_memory_by_head_dim(d, keys, slots, smem):
    """Layout<D> of the float32 kernel: each of 4 warps has its own ring of
    K/V tile slots (3 of 16 KB at D 256; 2 of 8 KB below, so that two CTAs
    share an SM), beside Q's hi and lo fragments (2 x 16 x D floats), a
    barrier per slot and 1024 bytes of alignment, within a block's shared
    memory. Gemma-3-1B's chunk (Sq 256, 4/1): 64 CTAs."""
    plan = flash.plan_flash((1, 256, 4, d), (1, 256, 1, d), route="f32")
    assert (plan.block_keys, plan.slots, plan.smem_bytes, plan.threads) \
        == (keys, slots, smem, 128)
    assert plan.smem_bytes <= flash.SMEM_LIMIT
    if d < 256:   # two CTAs per SM, with the 1 KB each reserves
        assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.ctas == 64
    flagship = flash.plan_flash((1, 256, 16, 128), (1, 256, 8, 128),
                                route="f32")
    assert flagship.ctas == 32 and flagship.tile_range(31) == (0, 16)   # x 8


def test_f32_kernel_source_mirrors_its_plan():
    """csrc/flash_attn.cu states the plan's constants, refuses any other
    plan, and runs both products on TF32 tensor cores with the 3xTF32
    split (no FMA loop, no library call)."""
    src = (CSRC / "flash_attn.cu").read_text()
    for name, value in (("ROWS", flash.F32_ROWS), ("NWARP", flash.F32_WARPS),
                        ("MAX_SPLIT", flash.F32_SPLIT)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "p.split < 1 || p.split > MAX_SPLIT" in src
    assert "static constexpr int NSLOT = D == 256 ? 3 : 2;" in src
    assert ("static constexpr int TILE_FLOATS = D == 256 ? 4096 : 2048;"
            in src)
    for d in (64, 128, 256):
        plan = flash.plan_flash((1, 8, 2, d), (1, 8, 2, d), route="f32")
        assert (plan.slots, plan.tile_floats) == ((3, 4096) if d == 256
                                                  else (2, 2048))
    assert ("rows != ROWS || threads != THREADS || smem_bytes != L::ALLOC"
            in src)
    assert src.count("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32") \
        == 1
    assert "hi = __float_as_uint(x) & kTf32;" in src
    assert "fmaf(" not in src and "cublas" not in src.lower()


@pytest.mark.parametrize("sq,q_offset,hq,hkv,d,sms,split", [
    (256, 0, 4, 1, 256, 132, 2),      # Gemma-3-1B's chunk: 64 row groups
    (256, 256, 4, 1, 256, 132, 2),    # and its append
    (600, 0, 4, 1, 256, 132, 1),      # 150 row groups: the card is full
    (256, 0, 16, 8, 128, 132, 1),     # the flagship's: 256
    (128, 0, 4, 1, 256, 132, 1),      # 32 row groups of 8 tiles: too few
    (64, 0, 16, 8, 128, 132, 1),      # 64 of 4 tiles
    (256, 0, 4, 1, 256, None, 1),     # no SM count: one CTA per group
])
def test_f32_plan_splits_small_grids_over_clusters(sq, q_offset, hq, hkv, d,
                                                   sms, split):
    """The plan splits each row group over a cluster of 2 CTAs where twice
    the grid fits the card's SMs and the last group walks at least 16
    tiles (4 for each warp), else keeps one CTA per group."""
    plan = flash.plan_flash((1, sq, hq, d), (1, sq + q_offset, hkv, d),
                            route="f32", sms=sms, q_offset=q_offset or None)
    assert plan.split == split
    lo, hi = plan.tile_range(plan.ctas - 1)
    assert (split == 2) == (plan.ctas * hkv * 2 <= (sms or 0)
                            and hi - lo >= flash.F32_SPLIT_MIN_TILES)


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("case", PLAN_CASES[-6:],
                         ids=[c[0] for c in PLAN_CASES[-6:]])
def test_f32_warps_of_a_cluster_take_each_tile_once(case, split):
    """The split * 4 warps of a row group's cluster walk its [lo, hi)
    tiles between them, each tile once, in the kernel's order."""
    _, sq, skv, hq, hkv, kw = case
    plan = dataclasses.replace(
        flash.plan_flash((1, sq, hq, 256), (1, skv, hkv, 256), route="f32",
                         **kw), split=split)
    for cta in range(plan.ctas):
        walked = sorted(kt for rank in range(split)
                        for warp in range(flash.F32_WARPS)
                        for kt in plan.warp_tiles(cta, rank, warp))
        assert walked == list(range(*plan.tile_range(cta)))


def test_f32_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head_dim"):
        flash.plan_flash((1, 8, 2, 32), (1, 8, 2, 32), route="f32")
    with pytest.raises(ValueError, match="head_dim"):
        flash.plan_flash((1, 8, 2, 96), (1, 8, 2, 96), route="f32")
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash.plan_flash((1, 8, 3, 64), (1, 8, 2, 64), route="f32")
    # a group of 128 heads fits 16-row CTAs: 8 CTAs per query index
    plan = flash.plan_flash((1, 8, 128, 64), (1, 8, 1, 64), route="f32")
    assert plan.ctas == 64 and plan.row(63, 15) == (7, 127)


def test_c_entries_name_each_head_dim():
    """Both flash entry points dispatch 64, 128 and 256 to their own
    instantiations and return an error for any other D."""
    for source in flash.SOURCES.values():
        src = (CSRC / Path(source).name).read_text()
        entry = src[src.index('extern "C" int'):]
        assert re.findall(r"case (\d+):", entry) == ["64", "128", "256"]
        assert "default" not in entry and "d == 128 ?" not in entry
        assert "return static_cast<int>(cudaErrorInvalidValue);" in \
            entry[entry.index("switch (d)"):]


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head_dim"):
        flash.plan_flash((1, 8, 2, 32), (1, 8, 2, 32))
    with pytest.raises(ValueError, match="head_dim"):
        flash.plan_flash((1, 8, 2, 96), (1, 8, 2, 96))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash.plan_flash((1, 8, 3, 64), (1, 8, 2, 64))
    with pytest.raises(ValueError, match="GQA group"):
        flash.plan_flash((1, 8, 128, 64), (1, 8, 1, 64))


def test_tma_strides_of_legal_views():
    q = torch.empty(1, 256, 16, 128, dtype=torch.bfloat16)
    assert flash.tma_strides(q, "q") == (256, 4096, 256 * 4096)
    pool = torch.empty(3, 4096, 8, 128, dtype=torch.bfloat16)
    # a pool row: 2048 bytes per position and 256 per head, as in append
    assert flash.tma_strides(pool[1:2], "k") == (256, 2048, 4096 * 2048)
    assert flash.tma_strides(pool[:, :512], "k") == (256, 2048,
                                                     4096 * 2048)
    # dimensions of size 1 take a legal stand-in stride
    one = torch.empty(1, 1, 1, 64, dtype=torch.bfloat16)
    assert flash.tma_strides(one, "q") == (128, 128, 128)


def test_tma_strides_raise_on_views_tma_cannot_take():
    flat = torch.empty(1 + 4 * 8 * 64, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 4, 8, 64)               # base 2 bytes off
    with pytest.raises(ValueError, match="base address"):
        flash.tma_strides(shifted, "k")
    narrow = torch.empty(1, 4, 8, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="head stride of 136"):
        flash.tma_strides(narrow, "k")
    odd_seq = torch.empty(4096, dtype=torch.bfloat16).as_strided(
        (1, 4, 8, 64), (4096, 516, 64, 1))
    with pytest.raises(ValueError, match="seq stride of 1032"):
        flash.tma_strides(odd_seq, "v")
    with pytest.raises(ValueError, match="contiguous last dimension"):
        flash.tma_strides(torch.empty(1, 4, 64, 8,
                                      dtype=torch.bfloat16).transpose(2, 3),
                          "q")


def test_route_is_chosen_by_dtype():
    assert flash.kernel_route(torch.bfloat16) == "bf16"
    assert flash.kernel_route(torch.float16) == "f16"     # module 16
    assert flash.kernel_route(torch.float32) == "f32"
    for dtype in (torch.float64, torch.int32):
        with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
            flash.kernel_route(dtype)


def test_wrapper_launches_the_route_of_the_dtype(monkeypatch):
    """A bf16 tensor reaches only the wgmma launcher's bf16 route, an f16
    one its f16 route (module 16) and a float32 one only the 3xTF32
    launcher; a dtype none takes raises before any launcher and never
    reaches the plain version."""
    called = []

    def launcher(route):
        def launch(q, *args):
            called.append(route)
            return q
        return launch
    monkeypatch.setattr(flash, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(flash, "_LAUNCHERS",
                        {r: launcher(r) for r in flash.LIBRARIES})
    monkeypatch.setattr(flash, "flash_attention_ref",
                        lambda *a, **k: pytest.fail("plain version reached"))
    for dtype, route in ((torch.bfloat16, "bf16"), (torch.float16, "f16"),
                         (torch.float32, "f32")):
        x = torch.zeros(1, 4, 2, 64, dtype=dtype)
        flash.flash_attention_kernel(x, x, x)
        assert called[-1] == route
    x = torch.zeros(1, 4, 2, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        flash.flash_attention_kernel(x, x, x)
    assert called == ["bf16", "f16", "f32"]


def test_wrapper_counts_launches_by_route_and_mode(monkeypatch):
    """Off the CPU (a meta tensor stands in for the card) the wrapper
    counts each launch under its route and mode."""
    monkeypatch.setattr(flash, "flash_attention_kernel",
                        lambda q, *a, **k: q)
    before = flash.launch_counts()
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        x = torch.empty(1, 4, 2, 64, dtype=dtype, device="meta")
        flash.flash_attention(x, x, x)
        flash.flash_attention(x, x, x, q_offset=4)
    after = flash.launch_counts()
    assert after["bf16"]["fresh"] - before["bf16"]["fresh"] == 2
    assert after["bf16"]["append"] - before["bf16"]["append"] == 2
    assert after["f32"]["fresh"] - before["f32"]["fresh"] == 1
    assert after["f32"]["append"] - before["f32"]["append"] == 1
    flash.reset_launches()
    assert flash.launch_counts() == {"bf16": {"fresh": 0, "append": 0},
                                     "f16": {"fresh": 0, "append": 0},
                                     "f32": {"fresh": 0, "append": 0}}


def test_wrapper_raises_on_cpu_tensors_of_a_kernel_dtype():
    x = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_attention_kernel(x, x, x)


def _c_params(source: str, entry: str) -> int:
    text = (CSRC / source).read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', text, re.S)
    return len(sig.group(1).split(","))


@pytest.mark.parametrize("route,entry,bind", [
    ("bf16", "cake_flash_wgmma_fwd", flash._bind_wgmma),
    ("f16", "cake_flash_wgmma_fwd_f16", flash._bind_wgmma),
    ("f32", "cake_flash_attention_fwd", flash._bind_f32),
])
def test_ctypes_signature_matches_the_c_entry(route, entry, bind):
    class Lib:
        pass
    lib = Lib()
    setattr(lib, entry, type("Fn", (), {})())
    bind(lib)
    source = Path(flash.SOURCES[route]).name
    assert len(getattr(lib, entry).argtypes) == _c_params(source, entry)
