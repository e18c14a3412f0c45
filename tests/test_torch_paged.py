"""Paged KV in the port against the JAX package: the cache helpers (both
stale-tenant guards, block write-back, prefix blocks) compared on visible
entries exactly, the BlockAllocator copy driven through the same seeded
op sequence as the reference's, the paged decode attention's plain version
against the JAX gather + multi_head_attention, the paged model programs
against JAX's, and the port's engine against itself and against the JAX
engine (paged, prefix hit and miss, swap preemption).

The port's pool has one more block than JAX's: the sink, index NB, which
is also the NULL table id. Visible contents exclude it."""
import gc
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.models.common import cache as jcache
from cake_tpu.ops.attention import make_attention_mask as jax_mask
from cake_tpu.ops.attention import multi_head_attention as jax_mha
from cake_tpu.ops.sampling import SamplingConfig as JaxSampling
from cake_tpu.serve import ServeEngine as JaxServeEngine
from cake_tpu.serve.paged import BlockAllocator as JaxBlockAllocator
from cake_tpu_torch.bench.paged_cases import case_args, paged_case
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common import cache as tcache
from cake_tpu_torch.ops import paged_attention as pa
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import KVPoolExhausted, PagedKV, ServeEngine
from cake_tpu_torch.serve.paged import BlockAllocator, pow2_block_tokens
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _collect_reference_engines():
    """Collect, after each test, the JAX serve engines it dropped: their
    admission queues sit in reference cycles, and a JAX queue finalized by
    a later automatic collection, while its thread holds the reference's
    board lock, deadlocks the process (ROADMAP §3, "Not a port fault")."""
    yield
    gc.collect()


GREEDY = SamplingConfig(temperature=0.0)
CTX, CHUNK, BT = 128, 16, 8


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_visible_equal(port: dict, ref: dict, atol=0.0):
    """pos equal everywhere; K/V equal where the entry is visible."""
    pos = _np(port["pos"])
    np.testing.assert_array_equal(pos, _np(ref["pos"]))
    vis = pos >= 0
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(port[name])[vis], _np(ref[name])[vis],
                                   atol=atol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    over = dict(max_position_embeddings=512)
    jm = JaxTextModel(jax_tiny_config("qwen3", **over), dtype=jnp.float32,
                      seed=7, max_cache_len=CTX)
    cfg = tiny_config("qwen3", **over)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   dtype=torch.float32, device="cpu", max_cache_len=CTX)
    return jm, tm


def _pool_pair(cfg_t, nb, bt, seed=0):
    """The same random pool in both packages: JAX's NB blocks, the port's
    NB + the sink (zeros, pos -1)."""
    rng = np.random.default_rng(seed)
    h, d = cfg_t.num_key_value_heads, cfg_t.head_dim
    k = rng.standard_normal((nb, bt, h, d)).astype(np.float32)
    v = rng.standard_normal((nb, bt, h, d)).astype(np.float32)
    pos = rng.integers(-1, 8 * bt, (nb, bt)).astype(np.int32)
    jpl = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)}
    tpl = {"k": torch.from_numpy(np.concatenate([k, np.zeros_like(k[:1])])),
           "v": torch.from_numpy(np.concatenate([v, np.zeros_like(v[:1])])),
           "pos": torch.from_numpy(np.concatenate(
               [pos, np.full((1, bt), -1, np.int32)]))}
    return jpl, tpl


# -- cache helpers -------------------------------------------------------------


def test_init_paged_layers_matches_jax(pair):
    jm, tm = pair
    jpool, jrows = jcache.init_paged_layers(jm.cfg, 6, BT, 2, CTX,
                                            jnp.float32)
    tpool, trows = tcache.init_paged_layers(tm.cfg, 6, BT, 2, CTX,
                                            torch.float32)
    for jp, tp, jr, tr in zip(jpool, tpool, jrows, trows):
        assert set(jp) == set(tp) and set(jr) == set(tr)
        for name in jp:                       # the port adds the sink
            assert tuple(tp[name].shape) == (7,) + tuple(jp[name].shape[1:])
            np.testing.assert_array_equal(_np(tp[name])[:6],
                                          np.asarray(jp[name]))
            np.testing.assert_array_equal(_np(tp[name])[6],
                                          np.asarray(jp[name][0]))


@pytest.mark.parametrize("table,frontier", [
    ([1, 3, 5, 5], 32),          # mapped, stale other-range, NULL tail
    ([5, 1, 5, 5], 14),          # same-index recycling below the frontier
    ([2, 0, 4, 3], 30),          # every entry mapped, frontier mid-block
    ([5, 5, 5, 5], 40),          # all NULL: an inactive row
])
def test_paged_gather_layer_matches_jax(pair, table, frontier):
    _, tm = pair
    jpl, tpl = _pool_pair(tm.cfg, 5, BT)
    # block 1 holds positions 8..15 (entry 1's own range)
    jpl["pos"] = jpl["pos"].at[1].set(jnp.arange(8, 16))
    tpl["pos"][1] = torch.arange(8, 16)
    want = jcache.paged_gather_layer(jpl, jnp.asarray(table, jnp.int32),
                                     jnp.int32(frontier))
    got = tcache.paged_gather_layer(tpl, torch.tensor(table), frontier)
    assert_visible_equal(got, want)
    # batched form: the same rows under a [B, M] table and [B] frontiers
    got2 = tcache.paged_gather_layer(tpl, torch.tensor([table, table]),
                                     torch.tensor([frontier, 0]))
    assert_visible_equal({n: t[0] for n, t in got2.items()}, want)
    assert int(got2["pos"][1].max()) == -1


def test_paged_block_of_and_scatter_match_jax(pair):
    _, tm = pair
    jpl, tpl = _pool_pair(tm.cfg, 5, BT, seed=1)
    table = [3, 0, 2, 5]
    jview = jcache.paged_gather_layer(jpl, jnp.asarray(table, jnp.int32),
                                      jnp.int32(20))
    tview = tcache.paged_gather_layer(tpl, torch.tensor(table), 20)
    for wb in range(4):
        assert_visible_equal(tcache.paged_block_of(tview, wb, BT),
                             jcache.paged_block_of(jview, jnp.int32(wb), BT))
    blk_j = {n: jnp.stack([jcache.paged_block_of(jview, jnp.int32(w),
                                                 BT)[n] for w in (1, 2)])
             for n in ("k", "v", "pos")}
    blk_t = {n: torch.stack([tcache.paged_block_of(tview, w, BT)[n]
                             for w in (1, 2)]) for n in ("k", "v", "pos")}
    # pids [4, 5]: a live block and NULL (dropped by JAX, the sink here)
    jout = jcache.paged_scatter_blocks(jpl, jnp.asarray([4, 5], jnp.int32),
                                       blk_j)
    tout = tcache.paged_scatter_blocks(tpl, torch.tensor([4, 5]), blk_t)
    assert_visible_equal({n: t[:5] for n, t in tout.items()}, jout)


def test_paged_write_entry_matches_jax_decode_writeback(pair):
    """The decode step's one-entry write leaves the same visible row as the
    reference's whole-block write-back from its masked view."""
    _, tm = pair
    jpl, tpl = _pool_pair(tm.cfg, 5, BT, seed=2)
    table, p = [3, 0, 2, 5], 19                        # p in block 2
    rng = np.random.default_rng(4)
    k_new = rng.standard_normal((1, 1) + tpl["k"].shape[2:]).astype(
        np.float32)
    # reference: gather with frontier p, write p, write back block p // BT
    view = jcache.paged_gather_layer(jpl, jnp.asarray(table, jnp.int32),
                                     jnp.int32(p))
    view = {"k": view["k"].at[p].set(k_new[0, 0]),
            "v": view["v"].at[p].set(k_new[0, 0]),
            "pos": view["pos"].at[p].set(p)}
    blk = {n: t[None] for n, t in jcache.paged_block_of(
        view, jnp.int32(p // BT), BT).items()}
    jout = jcache.paged_scatter_blocks(jpl, jnp.asarray([table[p // BT]],
                                                        jnp.int32), blk)
    before = {n: t.clone() for n, t in tpl.items()}
    tcache.paged_write_entry(tpl, torch.tensor([table, table]),
                             torch.from_numpy(np.repeat(k_new, 2, 0)),
                             torch.from_numpy(np.repeat(k_new, 2, 0)),
                             torch.tensor([p, 3]), torch.tensor([True, False]))
    assert_visible_equal(
        tcache.paged_gather_layer(tpl, torch.tensor(table), p + 1),
        jcache.paged_gather_layer(jout, jnp.asarray(table, jnp.int32),
                                  jnp.int32(p + 1)))
    # one entry of the live pool changed; the inactive row wrote the sink
    changed = (tpl["pos"] != before["pos"]) | \
        (tpl["k"] != before["k"]).flatten(2).any(-1)
    assert changed[:5].nonzero().tolist() == [[table[p // BT], p % BT]]


def test_slot_extract_splice_match_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(5)
    ids = [int(t) for t in rng.integers(0, 256, 40)]
    jl = jm.new_cache(2, kv_len=64)["layers"]
    tl = tm.new_cache(2, kv_len=64)["layers"]
    for s in range(0, 32, CHUNK):
        _, jl = jm.prefill_chunk(jl, 1, ids[s:s + CHUNK], s)
        _, tl = tm.prefill_chunk(tl, 1, ids[s:s + CHUNK], s)
    for b in range(2):
        jblk = jm.slot_extract(jl, 1, b * CHUNK, CHUNK)
        tblk = tm.slot_extract(tl, 1, b * CHUNK, CHUNK)
        for jb, tb in zip(jblk, tblk):
            assert_visible_equal(tb, jb, atol=1e-5)
        jl2 = jm.new_cache(2, kv_len=64)["layers"]
        tl2 = tm.new_cache(2, kv_len=64)["layers"]
        jl2 = jm.slot_splice(jl2, jblk, 0, final=True)
        tl2 = tm.slot_splice(tl2, tblk, 0, b * CHUNK)
        for ja, ta in zip(jl2, tl2):
            assert_visible_equal(ta, ja, atol=1e-5)


# -- allocator -------------------------------------------------------------


def test_allocator_matches_reference_random_ops():
    """The same seeded op sequence as tests/test_paged.py's property test
    through both copies: equal tables, refcounts and free counts after
    every op, and check() holds throughout."""
    assert pow2_block_tokens(24, 64) == 16 and pow2_block_tokens(7, 64) == 8
    allocs = [cls(8, 8, slots=3, max_blocks=6)
              for cls in (BlockAllocator, JaxBlockAllocator)]
    rngs = [random.Random(9), random.Random(9)]
    pins = [[], []]
    for _ in range(400):
        for a, rng, pin in zip(allocs, rngs, pins):
            op = rng.random()
            if op < 0.35:
                slot, idx = rng.randrange(3), rng.randrange(6)
                if a.tables[slot][idx] == a.NULL:
                    a.ensure(slot, idx)
            elif op < 0.55:
                owners = [(s, p) for s in range(3) for p in a.tables[s]
                          if p != a.NULL]
                if owners:
                    _, pid = rng.choice(owners)
                    dst = rng.randrange(3)
                    empties = [i for i, p in enumerate(a.tables[dst])
                               if p == a.NULL]
                    if empties and pid not in a.tables[dst]:
                        a.ref(pid)
                        a.map(dst, rng.choice(empties), pid)
            elif op < 0.7:
                used = [p for p in range(8) if a.refcount(p) >= 1]
                if used:
                    pid = rng.choice(used)
                    a.ref(pid, cache_pin=True)
                    pin.append(pid)
            elif op < 0.78:
                if pin:
                    a.deref(pin.pop(), cache_pin=True)
            elif op < 0.88:
                slot, idx = rng.randrange(3), rng.randrange(6)
                if a.tables[slot][idx] != a.NULL:
                    a.ensure_writable(slot, idx, lambda s, d: None)
            else:
                a.unmap_slot(rng.randrange(3))
            a.check()
        mine, ref = allocs
        assert mine.tables == ref.tables
        assert [mine.refcount(p) for p in range(8)] == \
            [ref.refcount(p) for p in range(8)]
        assert (mine.free_count, mine.shared_count, mine.cow_forks) == \
            (ref.free_count, ref.shared_count, ref.cow_forks)


# -- paged decode attention: plain version vs the JAX reference ---------------


def _jax_paged_decode(c):
    """The reference's arithmetic: gather each row with frontier p, write
    the step's entry (read back from the pool) at p, mask, attend."""
    nb = c["null"]
    pl = {n: jnp.asarray(_np(c[n])[:nb]) for n in ("k", "v", "pos")}
    bt = pl["pos"].shape[1]
    outs = []
    for b in range(c["q"].shape[0]):
        p = int(c["frontier"][b])
        table = jnp.asarray(_np(c["tables"][b]))
        view = jcache.paged_gather_layer(pl, table, jnp.int32(p))
        pid = int(table[p // bt])
        if pid < nb:
            view = {"k": view["k"].at[p].set(pl["k"][pid, p % bt]),
                    "v": view["v"].at[p].set(pl["v"][pid, p % bt]),
                    "pos": view["pos"].at[p].set(p)}
        mask = jax_mask(jnp.asarray([[p]], jnp.int32), view["pos"][None])
        outs.append(jax_mha(jnp.asarray(_np(c["q"][b:b + 1])),
                            view["k"][None], view["v"][None], mask))
    return np.concatenate([np.asarray(o) for o in outs])


@pytest.mark.parametrize("spec", [
    dict(frontiers=[1, 15, 16, 70, 127], null_rows=1),
    dict(frontiers=[1, 15, 16, 70, 127], bt=32),
    dict(frontiers=[40, 100, 60], stale=True, shared=True),
    dict(frontiers=[5, 90], hq=4, hkv=4, d=32, bt=8),
    dict(frontiers=[1, 15, 16, 70, 127], hq=4, hkv=1, d=256, null_rows=1),
    dict(frontiers=[40, 100, 60], hq=8, hkv=1, d=256, stale=True,
         shared=True),
], ids=["ragged_null", "bt32", "stale_shared", "mha_bt8", "gemma3_d256_g4",
        "d256_g8_stale_shared"])
def test_paged_decode_plain_matches_jax(spec):
    kw = dict(hq=4, hkv=2, d=16, ctx=CTX)
    c = paged_case(**{**kw, **spec}, seed=3)
    got = pa.paged_decode_attention(*case_args(c))       # CPU: plain version
    want = _jax_paged_decode(c)
    rows = c["visible_rows"]
    np.testing.assert_allclose(got.numpy()[rows], want[rows], atol=1e-5,
                               rtol=0)


def test_paged_splits_depend_on_the_row_alone():
    """The kernel's plan: the blocks a row reads and each cluster rank's
    share are set by the row's own frontier, whatever the batch."""
    alone = pa.plan_paged((1, 1, 16, 128), (1025, 16, 8, 128), (1, 256),
                          torch.bfloat16)
    batch = pa.plan_paged((5, 1, 16, 128), (1025, 16, 8, 128), (5, 256),
                          torch.bfloat16)
    assert alone.grid == (pa.CLUSTER, 8, 1) and batch.grid == (8, 8, 5)
    assert [alone.live_blocks(p) for p in (
        -1, 0, 15, 16, 620, 4095, 9999)] == [0, 1, 1, 2, 39, 256, 256]
    for p in (0, 15, 16, 620, 4095):
        assert [alone.rank_blocks(r, p) for r in range(pa.CLUSTER)] == \
            [batch.rank_blocks(r, p) for r in range(pa.CLUSTER)]
    assert alone.rank_blocks(3, 620) == [3, 11, 19, 27, 35]


def test_paged_kernel_wrapper_refuses_cpu_and_bad_inputs():
    c = paged_case([3, 9], hq=4, hkv=2, d=16, ctx=64)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention_kernel(*case_args(c))
    assert pa.launch_counts() == {"bf16": 0, "f16": 0, "f32": 0}
    assert pa.kernel_route(torch.float16) == "f16"       # module 16
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        pa.kernel_route(torch.float64)


# -- the paged model programs against JAX's ----------------------------------


def test_paged_programs_match_jax(pair, monkeypatch):
    """prefill_chunk_paged over fresh, append and masked-tail chunks
    (flash in interpret mode on the JAX side), then decode_slots_paged
    over two slots, one inactive: logits within 1e-4, greedy tokens
    identical, visible pool contents within 1e-5."""
    import cake_tpu.ops.flash as fl
    orig = fl.flash_attention
    monkeypatch.setattr(fl, "flash_enabled", lambda: True)
    monkeypatch.setattr(fl, "flash_attention",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    over = dict(max_position_embeddings=1024)
    jm = JaxTextModel(jax_tiny_config("qwen3", **over), dtype=jnp.float32,
                      seed=7, max_cache_len=1024)
    cfg = tiny_config("qwen3", **over)
    tm = TextModel(cfg, params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jm.params), "cpu",
        torch.float32), dtype=torch.float32, device="cpu",
        max_cache_len=1024)
    ctx, bt, nb, m = 1024, 16, 48, 64
    ids = [int(t) for t in np.random.default_rng(8).integers(0, 256, 560)]
    jpool, jrows = jcache.init_paged_layers(jm.cfg, nb, bt, 2, ctx,
                                            jnp.float32)
    tpool, trows = tm.new_paged(nb, bt, 2, ctx)
    perm = np.random.default_rng(1).permutation(nb)[:ids.__len__() // bt + 2]
    table = np.full((2, m), nb, np.int32)
    table[1, :len(perm)] = perm
    jtables, ttables = jnp.asarray(table), torch.from_numpy(table.copy())
    for p0 in (0, 256, 512):                 # fresh, append, masked tail
        chunk = ids[p0:p0 + 256]
        jl, jpool, jrows = jm.prefill_chunk_paged(jpool, jrows, jtables, 1,
                                                  chunk, p0, ctx)
        tl = tm.prefill_chunk_paged(tpool, trows, ttables, 1, chunk, p0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    assert int(np.argmax(np.asarray(jl))) == int(tl.argmax())
    tok = int(tl.argmax())
    n = len(ids)
    jtoks = jnp.asarray([0, tok], jnp.int32)
    ttoks = torch.tensor([0, tok], dtype=torch.int32)
    jpos = jnp.asarray([0, n], jnp.int32)
    tpos = torch.tensor([0, n], dtype=torch.int32)
    jrec = jnp.full((2, 64), -1, jnp.int32)
    trec = torch.full((2, 64), -1, dtype=torch.int32)
    jrngs = jnp.stack([jax.random.PRNGKey(0)] * 2)
    v = cfg.vocab_size
    jc = (jnp.zeros(2, jnp.float32), jnp.full(2, v, jnp.int32),
          jnp.ones(2, jnp.float32), jnp.ones(2, jnp.float32))
    tkeys = torch.zeros(2, dtype=torch.int64)
    tctr = torch.zeros(2, dtype=torch.int64)
    tc = (torch.zeros(2), torch.full((2,), v, dtype=torch.int32),
          torch.ones(2), torch.ones(2))
    jact = jnp.asarray([False, True])
    tact = torch.tensor([False, True])
    jout, tout = [], []
    for _ in range(8):
        (jpk, jpool, jrows, jtoks, jpos, jrngs,
         jrec) = jm.decode_slots_paged(jpool, jrows, jtables, jtoks, jpos,
                                       jrngs, jrec, *jc, jact, nb=2)
        tpk, ttoks, tpos, trec, tctr = tm.decode_slots_paged(
            tpool, trows, ttables, ttoks, tpos, trec, tkeys, tctr, *tc,
            tact)
        jout.append(int(jtoks[1]))
        tout.append(int(ttoks[1]))
    assert tout == jout
    assert int(tpos[0]) == 0 and int(ttoks[0]) == 0        # inactive row
    for jp, tp in zip(jpool, tpool):
        got = tcache.paged_gather_layer(tp, ttables[1], n + 8)
        want = jcache.paged_gather_layer(jp, jtables[1], jnp.int32(n + 8))
        assert_visible_equal(got, want, atol=1e-5)


# -- the port's engine against itself -----------------------------------------


SYS = [3 + (i * 7) % 200 for i in range(40)]          # 2 full share units
PROMPTS = [SYS + [9, 11], SYS + [77, 31, 5], [3, 17, 42, 99, 7],
           [100, 2, 5, 9, 11, 40]]


def _engine(tm, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("ctx_len", CTX)
    kw.setdefault("prefill_chunk", CHUNK)
    return ServeEngine(tm, **kw)


def _run(eng, prompts, n):
    reqs = [eng.submit(p, n, GREEDY) for p in prompts]
    for r in reqs:
        assert r.wait(120)
        assert "error" not in r.result, r.result["error"]
    return [r.result["tokens"] for r in reqs], reqs


@pytest.mark.parametrize("kw", [
    dict(prefix_cache_mb=0),
    dict(prefix_cache_mb=8),
    dict(kv_blocks=48, kv_block_tokens=BT, prefix_cache_mb=0),
    dict(kv_blocks=48, kv_block_tokens=BT, prefix_cache_mb=8),
], ids=["contiguous_miss", "contiguous_hit", "paged_miss", "paged_hit"])
def test_engine_modes_equal_sequential(pair, kw):
    """Contiguous and paged, prefix cache off and on: greedy tokens
    bit-identical to the sequential path; with the cache on, the later
    requests sharing SYS splice its two 16-token units."""
    _, tm = pair
    want = [tm.generate(p, max_new_tokens=12)[0] for p in PROMPTS]
    eng = _engine(tm, **kw)
    try:
        first, _ = _run(eng, PROMPTS[:1], 12)
        rest, reqs = _run(eng, PROMPTS[1:], 12)
        assert first + rest == want
        hits = [r.result["stats"]["prefix_hit_tokens"] for r in reqs]
        assert hits == ([32, 0, 0] if kw["prefix_cache_mb"] else [0, 0, 0])
        h = eng.health()
        assert ("prefix_cache" in h) == bool(kw["prefix_cache_mb"])
        assert ("kv_pool" in h) == ("kv_blocks" in kw)
    finally:
        eng.close()


def test_paged_prefix_hit_shares_blocks(pair):
    """A paged hit maps the cached physical blocks into the new slot's
    table: the same ids, shared by refcount, while the request runs."""
    _, tm = pair
    eng = _engine(tm, kv_blocks=48, kv_block_tokens=BT, prefix_cache_mb=8)
    try:
        _run(eng, PROMPTS[:1], 4)
        r = eng.submit(PROMPTS[1], 40, GREEDY)
        for _ in range(2000):
            if r.tokens or r.done.is_set():
                break
            r.done.wait(0.005)
        assert r.tokens and not r.done.is_set()
        alloc = eng.paged.alloc
        assert eng.health()["kv_pool"]["shared"] >= 4
        entry = next(iter(eng.prefix_cache._blocks.values()))
        assert alloc.tables[r.slot][:len(entry.pids)] == entry.pids
        r.cancel()
        assert r.wait(60)
    finally:
        eng.close()


def test_swap_preemption_is_bit_identical(pair):
    """Two streams outgrow a 12-block pool: the later one is swapped out
    to host memory and resumed, and both equal the unpressured run."""
    _, tm = pair
    prompts = PROMPTS[2:]
    want = [tm.generate(p, max_new_tokens=60)[0] for p in prompts]
    eng = _engine(tm, kv_blocks=12, kv_block_tokens=BT, prefix_cache_mb=8)
    try:
        got, _ = _run(eng, prompts, 60)
        h = eng.health()["kv_pool"]
        assert got == want
        assert h["swaps"] >= 1 and h["preempted_slots"] == 0
        eng.paged.alloc.check()
    finally:
        eng.close()


def test_pool_too_small_refuses_and_fails_typed(pair):
    _, tm = pair
    eng = _engine(tm, kv_blocks=12, kv_block_tokens=BT, prefix_cache_mb=0)
    try:
        with pytest.raises(ValueError, match="KV blocks"):
            eng.submit(list(range(3, 103)), 4, GREEDY)
        r = eng.submit(PROMPTS[2], 110, GREEDY)
        assert r.wait(120)
        assert isinstance(r.result.get("error"), KVPoolExhausted)
        assert len(r.tokens) > 80
        ok, _ = _run(eng, PROMPTS[3:], 6)
        assert ok == [tm.generate(PROMPTS[3], max_new_tokens=6)[0]]
    finally:
        eng.close()
    with pytest.raises(ValueError, match="preempt_mode"):
        _engine(tm, kv_blocks=12, preempt_mode="drop")


def test_resume_gate_reclaims_cache_pins(pair):
    _, tm = pair
    pk = PagedKV.build(tm, 2, CTX, 6, BT, CHUNK)
    pids = [pk.alloc.alloc() for _ in range(4)]
    for p in pids:
        pk.alloc.ref(p, cache_pin=True)
        pk.alloc.deref(p)
    pk.evictor = lambda: (pids and pk.alloc.deref(pids.pop(),
                                                  cache_pin=True)) or 0
    assert pk.alloc.free_count == 2
    assert pk.ensure_free(5)
    assert pk.alloc.free_count >= 5
    assert not pk.ensure_free(7)
    pk.alloc.check()


# -- against the JAX engine ----------------------------------------------------


def test_paged_engine_matches_jax_engine(pair):
    jm, tm = pair
    kw = dict(slots=2, max_queue=8, ctx_len=CTX, prefill_chunk=CHUNK,
              kv_blocks=48, kv_block_tokens=BT, prefix_cache_mb=8)
    prompts = PROMPTS[:3]
    jeng = JaxServeEngine(jm, **kw)
    try:
        jreqs = [jeng.submit(p, 10, JaxSampling(temperature=0.0))
                 for p in prompts]
        for r in jreqs:
            assert r.wait(300)
        want = [r.result["tokens"] for r in jreqs]
    finally:
        jeng.close()
    eng = ServeEngine(tm, **kw)
    try:
        got, _ = _run(eng, prompts, 10)
    finally:
        eng.close()
    assert got == want
