"""The prefill programs' in-place form on the CPU (TextModel.
prefill_chunk_into / prefill_chunk_paged_into behind graphs.PrefillGraphs,
the counterpart of the reference's `_prefill_slot` / `_prefill_slot_paged`):

  (a) a chunk through the in-place program equals the eager, host-int
      prefill (prefill_chunk / prefill_chunk_paged) bit for bit in logits,
      KV bytes and positions: fresh 256 (flash), append 256 at row 1, a
      masked tail in buckets 128 and 32, a prefix-hit continuation, a
      sliding-window ring narrower than the chunk, a paged write-back
      window slid at the pool's last blocks, and a shared prefix block
      below pos0, which is not written;
  (b) the same chunks hold the JAX package's prefill_chunk /
      prefill_chunk_paged (its Pallas kernel in interpret mode) within
      1e-3, and greedy continuations are equal;
  (c) the in-place program reads no tensor value on the host;
  (d) a graph's warm-up (valid_len 0) writes nothing;
  (e) an engine under recompute preemption never moves a buffer that a
      prefill or decode graph reads.

Tiny widths, f32, one torch thread; FLASH_MIN_SEQ is 256, so the flash
chunks are 256 wide."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.models.common import cache as jcache
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common.cache import kv_capacity
from cake_tpu_torch.models.common.graphs import WARMUP, PrefillGraph
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import ServeEngine
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
CTX, BT, NB, CHUNK = 1024, 16, 128, 256
GREEDY = SamplingConfig(temperature=0.0)


def _ids(n: int, seed: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(3, 256, n)]


A, B = _ids(1000, 1), _ids(1000, 2)


def _chunks(ids, start=0, width=CHUNK):
    return [(p0, ids[p0:p0 + width]) for p0 in range(start, len(ids), width)]


def _carry(jm, cfg) -> TextModel:
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    return TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                     dtype=torch.float32, device="cpu", max_cache_len=CTX)


def _pair(fam="qwen3", **over):
    over = dict(max_position_embeddings=CTX, **over)
    global_layers = over.pop("global_layers", None)
    jcfg, cfg = jax_tiny_config(fam, **over), tiny_config(fam, **over)
    if global_layers is not None:
        jcfg = dataclasses.replace(jcfg, global_layers=global_layers)
        cfg = dataclasses.replace(cfg, global_layers=global_layers)
    jm = JaxTextModel(jcfg, dtype=jnp.float32, seed=7, max_cache_len=CTX)
    return jm, _carry(jm, cfg)


@pytest.fixture(scope="module")
def qwen3():
    return _pair()


@pytest.fixture(scope="module")
def windowed():
    """Every layer a ring of 24 entries, narrower than the chunk."""
    return _pair("mistral", sliding_window=24, global_layers=())


@pytest.fixture(scope="module")
def mixed():
    """Full layers 0 and 2, rings of 24 at 1 and 3: the paged pool pages
    the full layers and keeps each slot's rings as rows."""
    return _pair("mistral", sliding_window=24, global_layers=(0, 2))


def _clone(layers):
    return [{n: t.clone() for n, t in lc.items()} for lc in layers]


def _same(a: list[dict], b: list[dict]) -> bool:
    return all(torch.equal(x[n], y[n]) for x, y in zip(a, b) for n in x)


def _tenant(layers, row: int, seed: int) -> None:
    """Another tenant's bytes in pool row `row` (or every block of a paged
    pool but the sink): the chunk must leave them alone."""
    g = torch.Generator().manual_seed(seed)
    for lc in layers:
        if not lc:
            continue
        for n in ("k", "v"):
            t = lc[n][row] if row is not None else lc[n][:-1]
            t.copy_(torch.randn(t.shape, generator=g))
        p = lc["pos"][row] if row is not None else lc["pos"][:-1]
        p.copy_(torch.randint(-1, CTX, p.shape, generator=g))


def _contiguous_graphs(tm, layers):
    cap = kv_capacity(tm.cfg, {"layers": layers})
    return tm.prefill_graphs(
        lambda io, bucket, mode: tm.prefill_chunk_into(layers, io, bucket,
                                                       mode), cap, CHUNK)


def _paged_graphs(tm, pool, rows, tables):
    return tm.prefill_graphs(
        lambda io, bucket, mode: tm.prefill_chunk_paged_into(
            pool, rows, tables, io, bucket, mode), tables.shape[1] * BT,
        CHUNK)


class Contiguous:
    """Two copies of a 2-row pool: one takes the eager chunks, the other
    the in-place program."""

    def __init__(self, tm):
        self.tm = tm
        self.eager = tm.new_cache(2, kv_len=CTX)["layers"]
        _tenant(self.eager, 0, seed=3)
        self.inplace = _clone(self.eager)
        self.graphs = _contiguous_graphs(tm, self.inplace)

    def chunk(self, slot, p0, ids):
        want, _ = self.tm.prefill_chunk(self.eager, slot, ids, p0)
        got = self.graphs.run(slot, ids, p0).clone()
        return want, got

    def same(self) -> bool:
        return _same(self.eager, self.inplace)


class Paged:
    """Two copies of a paged pool (NB blocks of BT, 2 slots, stale bytes
    in every block): slot 1 maps a permutation of the blocks, slot 0 is
    unmapped."""

    def __init__(self, tm, seed=4):
        self.tm = tm
        pool, rows = tm.new_paged(NB, BT, 2, CTX)
        _tenant(pool, None, seed=seed)
        _tenant(rows, 0, seed=seed + 1)
        m = CTX // BT
        table = np.full((2, m), NB, np.int32)
        table[1] = np.random.default_rng(seed).permutation(NB)[:m]
        self.eager = (pool, rows, torch.from_numpy(table))
        self.inplace = (_clone(pool), _clone(rows),
                        torch.from_numpy(table.copy()))
        self.graphs = _paged_graphs(tm, *self.inplace)

    def chunk(self, slot, p0, ids):
        want = self.tm.prefill_chunk_paged(*self.eager, slot, ids, p0)
        got = self.graphs.run(slot, ids, p0).clone()
        return want, got

    def same(self) -> bool:
        """Every block but the sink (masked writes land there), every
        ring row and the tables."""
        (pe, re_, te), (pi, ri, ti) = self.eager, self.inplace
        strip = [{n: t[:-1] for n, t in pl.items()} for pl in pe]
        strip_i = [{n: t[:-1] for n, t in pl.items()} for pl in pi]
        return (_same(strip, strip_i) and _same(re_, ri)
                and torch.equal(te, ti))


def _equal_chunks(pair, slot, chunks):
    keys = []
    for p0, ids in chunks:
        want, got = pair.chunk(slot, p0, ids)
        assert torch.equal(got, want), f"chunk at {p0}: logits differ"
        assert pair.same(), f"chunk at {p0}: KV bytes differ"
        keys.append(pair.graphs.key(len(ids), p0))
    return keys


# -- (a) the in-place program equals the eager prefill, bit for bit ---------


@pytest.mark.parametrize("n,tail", [(600, (128, "off")), (530, (32, "off"))])
@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_inplace_equals_eager(qwen3, kind, n, tail):
    """Fresh 256 (flash), append 256 (flash over row 1 / the gathered
    view) and a masked tail, at row 1 with another tenant's bytes in
    row 0 (and stale bytes in every block)."""
    _, tm = qwen3
    pair = Contiguous(tm) if kind == "contiguous" else Paged(tm)
    keys = _equal_chunks(pair, 1, _chunks(A[:n]))
    assert keys == [(256, "fresh"), (256, "append"), tail]


def test_inplace_equals_eager_prefix_hit(qwen3):
    """A prefix-hit continuation: row 1 takes row 0's first 256 positions
    by splice, then continues from 256 (append, masked tail)."""
    _, tm = qwen3
    pair = Contiguous(tm)
    for layers in (pair.eager, pair.inplace):
        for p0, ids in _chunks(A[:512]):
            tm.prefill_chunk(layers, 0, ids, p0)
        tm.slot_splice(layers, tm.slot_extract(layers, 0, 0, CHUNK), 1, 0)
    assert pair.same()
    keys = _equal_chunks(pair, 1, _chunks(A[:256] + B[256:600], start=256))
    assert keys == [(256, "append"), (128, "off")]


def test_inplace_equals_eager_ring_narrower_than_chunk(windowed):
    """Every layer a ring of 24: fresh flash with the window, then, with
    no unwrapped buffer, the 256-wide chunk and the tail on the masked
    path over [ring ; chunk]; only the last 24 valid entries land."""
    _, tm = windowed
    pair = Contiguous(tm)
    keys = _equal_chunks(pair, 1, _chunks(A[:600]))
    assert keys == [(256, "fresh"), (256, "off"), (128, "off")]
    assert sorted(pair.inplace[0]["pos"][1].tolist()) == list(range(576,
                                                                   600))


def test_inplace_equals_eager_paged_rings(mixed):
    """Paged with ring layers: the rings are row `slot` of the rows pool,
    indexed on the card."""
    _, tm = mixed
    pair = Paged(tm)
    keys = _equal_chunks(pair, 1, _chunks(A[:600]))
    assert keys == [(256, "fresh"), (256, "append"), (128, "off")]


def test_paged_window_slid_at_the_pool_end(qwen3):
    """996 tokens: the last chunk (228 at 768, bucket 256) has a write-back
    window of 17 entries slid back to 47..63; entry 47 holds positions
    752..767, below pos0, and is not written."""
    _, tm = qwen3
    pair = Paged(tm, seed=6)
    chunks = _chunks(A[:996])
    _equal_chunks(pair, 1, chunks[:3])
    pid = int(pair.inplace[2][1, 47])
    before = [{n: t[pid].clone() for n, t in pl.items()}
              for pl in pair.inplace[0]]
    assert _equal_chunks(pair, 1, chunks[3:]) == [(256, "append")]
    assert _same(before, [{n: t[pid] for n, t in pl.items()}
                          for pl in pair.inplace[0]])


def test_shared_prefix_block_is_not_written(qwen3):
    """Slot 1 shares slot 0's first 16 blocks (a paged prefix hit) and
    continues from 256: the shared blocks keep every byte."""
    _, tm = qwen3
    pair = Paged(tm, seed=8)
    m = CTX // BT
    perm = np.random.default_rng(9).permutation(NB)
    for _, _, table in (pair.eager, pair.inplace):
        table[0] = torch.from_numpy(perm[:m].astype(np.int32))
        table[1] = torch.from_numpy(np.concatenate(
            [perm[:16], perm[m:m + m - 16]]).astype(np.int32))
    _equal_chunks(pair, 0, _chunks(A[:512]))
    shared = torch.from_numpy(perm[:16].astype(np.int64))
    before = [{n: t[shared].clone() for n, t in pl.items()}
              for pl in pair.inplace[0]]
    keys = _equal_chunks(pair, 1, _chunks(A[:256] + B[256:600], start=256))
    assert keys == [(256, "append"), (128, "off")]
    assert _same(before, [{n: t[shared] for n, t in pl.items()}
                          for pl in pair.inplace[0]])


# -- (b) against the JAX package's prefill programs ---------------------------


@pytest.fixture
def interpret_flash(monkeypatch):
    """The JAX package's flash path with its Pallas kernel in interpret
    mode, as its own tests run it on the CPU."""
    import cake_tpu.ops.flash as fl
    orig = fl.flash_attention
    monkeypatch.setattr(fl, "flash_enabled", lambda: True)
    monkeypatch.setattr(fl, "flash_attention",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _greedy_jax_paged(jm, jpool, jrows, jtables, tok, n, steps):
    v = jm.cfg.vocab_size
    toks = jnp.asarray([0, tok], jnp.int32)
    pos = jnp.asarray([0, n], jnp.int32)
    rec = jnp.full((2, 64), -1, jnp.int32)
    rngs = jnp.stack([jax.random.PRNGKey(0)] * 2)
    c = (jnp.zeros(2, jnp.float32), jnp.full(2, v, jnp.int32),
         jnp.ones(2, jnp.float32), jnp.ones(2, jnp.float32))
    act = jnp.asarray([False, True])
    out = []
    for _ in range(steps):
        (_, jpool, jrows, toks, pos, rngs, rec) = jm.decode_slots_paged(
            jpool, jrows, jtables, toks, pos, rngs, rec, *c, act, nb=2)
        out.append(int(toks[1]))
    return out


def _greedy_port(tm, layers_or_paged, tok, n, steps):
    v = tm.cfg.vocab_size
    toks = torch.tensor([0, tok], dtype=torch.int32)
    pos = torch.tensor([0, n], dtype=torch.int32)
    rec = torch.full((2, 64), -1, dtype=torch.int32)
    keys = torch.zeros(2, dtype=torch.int64)
    ctr = torch.zeros(2, dtype=torch.int64)
    c = (torch.zeros(2), torch.full((2,), v, dtype=torch.int32),
         torch.ones(2), torch.ones(2))
    act = torch.tensor([False, True])
    out = []
    for _ in range(steps):
        if isinstance(layers_or_paged, tuple):
            _, toks, pos, rec, ctr = tm.decode_slots_paged(
                *layers_or_paged, toks, pos, rec, keys, ctr, *c, act)
        else:
            _, toks, pos, rec, ctr = tm.decode_slots(
                layers_or_paged, toks, pos, rec, keys, ctr, *c, act)
        out.append(int(toks[1]))
    return out


def _greedy_jax(jm, jl, tok, n, steps):
    v = jm.cfg.vocab_size
    toks = jnp.asarray([0, tok], jnp.int32)
    pos = jnp.asarray([0, n], jnp.int32)
    rec = jnp.full((2, 64), -1, jnp.int32)
    rngs = jnp.stack([jax.random.PRNGKey(0)] * 2)
    c = (jnp.zeros(2, jnp.float32), jnp.full(2, v, jnp.int32),
         jnp.ones(2, jnp.float32), jnp.ones(2, jnp.float32))
    act = jnp.asarray([False, True])
    out = []
    for _ in range(steps):
        _, jl, toks, pos, rngs, rec = jm.decode_slots(
            jl, toks, pos, rngs, rec, *c, act, nb=2)
        out.append(int(toks[1]))
    return out


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_inplace_matches_jax(qwen3, interpret_flash, kind):
    """600 tokens in chunks (fresh, append, masked tail) through the
    in-place program and the JAX package's prefill_chunk(_paged): logits
    within 1e-3 per chunk; 8 greedy tokens after it equal."""
    jm, tm = qwen3
    chunks = _chunks(A[:600])
    if kind == "contiguous":
        jl = jm.new_cache(2, kv_len=CTX)["layers"]
        tl = tm.new_cache(2, kv_len=CTX)["layers"]
        graphs = _contiguous_graphs(tm, tl)
        for p0, ids in chunks:
            want, jl = jm.prefill_chunk(jl, 1, ids, p0)
            got = graphs.run(1, ids, p0)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-3, rtol=0)
        tok = int(np.argmax(np.asarray(want)))
        assert int(got.argmax()) == tok
        assert _greedy_port(tm, tl, tok, 600, 8) == \
            _greedy_jax(jm, jl, tok, 600, 8)
        return
    m = CTX // BT
    jpool, jrows = jcache.init_paged_layers(jm.cfg, NB, BT, 2, CTX,
                                            jnp.float32)
    tpool, trows = tm.new_paged(NB, BT, 2, CTX)
    table = np.full((2, m), NB, np.int32)
    table[1] = np.random.default_rng(3).permutation(NB)[:m]
    jtables, ttables = jnp.asarray(table), torch.from_numpy(table.copy())
    graphs = _paged_graphs(tm, tpool, trows, ttables)
    for p0, ids in chunks:
        want, jpool, jrows = jm.prefill_chunk_paged(jpool, jrows, jtables, 1,
                                                    ids, p0, CTX)
        got = graphs.run(1, ids, p0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                                   rtol=0)
    tok = int(np.argmax(np.asarray(want)))
    assert int(got.argmax()) == tok
    assert _greedy_port(tm, (tpool, trows, ttables), tok, 600, 8) == \
        _greedy_jax_paged(jm, jpool, jrows, jtables, tok, 600, 8)


# -- (c) nothing is read on the host ---------------------------------------


def _no_host_reads(monkeypatch):
    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"Tensor.{name} read a value on the host")
        return read
    for name in ("item", "__int__", "__bool__", "__index__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))


@pytest.mark.parametrize("kind", ["contiguous", "paged", "rings"])
def test_inplace_reads_nothing_on_the_host(qwen3, mixed, windowed, kind,
                                           monkeypatch):
    """Tensor.item, __int__, __bool__, __index__ and tolist raise while the
    in-place program runs every mode: fresh, append, masked tails (and a
    ring narrower than the chunk)."""
    if kind == "contiguous":
        pair = Contiguous(qwen3[1])
    elif kind == "paged":
        pair = Paged(mixed[1])
    else:
        pair = Contiguous(windowed[1])
    graphs = pair.graphs
    got = []
    with monkeypatch.context() as mp:
        _no_host_reads(mp)
        for p0, ids in _chunks(A[:530]):
            got.append(graphs.run(1, ids, p0).clone())
    assert len(graphs.graphs) == 3
    for (p0, ids), logits in zip(_chunks(A[:530]), got):
        want, _ = pair.chunk(1, p0, ids)
        assert torch.equal(logits, want)


# -- (d) a warm-up writes nothing ---------------------------------------------


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_warmup_writes_nothing(mixed, kind):
    """A PrefillGraph's warm-up body (its program at valid_len 0, after the
    constructor zeroed the meta) leaves every KV byte, position, ring row
    and table as it was, for every program of the engine's set, with rows
    and blocks full of another tenant's bytes (the paged pool's sink
    block, where masked writes land, aside); so does valid_len 0 at a
    non-zero slot and position."""
    _, tm = mixed
    pair = Contiguous(tm) if kind == "contiguous" else Paged(tm)
    state = pair.inplace
    # the paged pool's sink takes the masked writes: it is no one's KV
    flat = state if kind == "contiguous" else [
        *({n: t[:-1] for n, t in pl.items()} for pl in state[0]),
        *state[1], {"t": state[2]}]
    if kind == "contiguous":
        _tenant(state, 1, seed=12)
    else:
        state[2][0] = state[2][1].flip(0)
    before = _clone(flat)
    graphs = pair.graphs
    keys = [(32, "off"), (64, "off"), (128, "off"), (256, "fresh"),
            (256, "append"), (256, "off")]
    for key in keys:
        g = PrefillGraph(lambda key=key: graphs.program(graphs.io, *key),
                         graphs.io, "cpu")
        for _ in range(WARMUP):
            g.step_fn()
        assert _same(before, flat), f"warm-up of {key} wrote"
        graphs.io.io[:3].copy_(torch.tensor([1, 256, 0], dtype=torch.int32))
        g.step_fn()
        assert _same(before, flat), f"valid_len 0 of {key} wrote"


# -- (e) recompute keeps every address ---------------------------------------


def _addresses(eng) -> dict:
    kv = {f"pool{i}.{n}": t for i, pl in enumerate(eng.paged.pool)
          for n, t in pl.items()}
    kv.update({f"rows{i}.{n}": t for i, rl in enumerate(eng.paged.rows)
               for n, t in rl.items()})
    kv["tables"] = eng.paged.tables
    kv.update({f"carry.{n}": t for n, t in eng.carries.tensors().items()})
    kv.update({f"prefill.{n}": t
               for n, t in eng.prefill.io.tensors().items()})
    return {n: t.data_ptr() for n, t in kv.items()}


def test_recompute_keeps_every_address(mixed):
    """Two streams outgrow a 12-block pool under recompute (prefix cache
    on): the replay of the preempted one runs through the same prefill
    buffers, and no tensor a graph reads moves."""
    _, tm = mixed
    eng = ServeEngine(tm, slots=2, ctx_len=128, prefill_chunk=16,
                      prefix_cache_mb=8, kv_blocks=12, kv_block_tokens=8,
                      preempt_mode="recompute")
    try:
        before = _addresses(eng)
        reqs = [eng.submit(p, 60, GREEDY) for p in (A[:5], B[:6])]
        for r in reqs:
            assert r.wait(120) and "error" not in r.result, r.result
        h = eng.health()
        assert h["kv_pool"]["replays"] >= 1
        assert h["prefill_graphs"]["replays"] > 0
        assert _addresses(eng) == before
    finally:
        eng.close()
