"""Speculative decoding in the port's serve engine (the batched verify in
both pools, as captured graphs on a card and eager in-place programs
here), against the JAX package's engine and against the port's own plain
stream, on tiny models whose weights are carried across with
params_from_numpy:

  * greedy, contiguous and paged: the port's spec stream equals the JAX
    engine's spec stream and the port's plain stream, with multi-token
    accepts, a slot whose drafter abstains in the same dispatch, and
    EOS or the budget inside an accepted prefix;
  * swap and recompute preemption mid-speculation (a swapped-out slot
    carries no uncommitted block), the degrade to a plain step at the
    pool's edge (no victim preempted), PagedKV.trim_to, a stateful
    drafter refused, and the verify's carries and graphs at unchanged
    addresses across steps and a rebuild;
  * a sampled stream under speculation equals itself alone and in
    company (its noise is its own key and counter);
  * the windowed-ring question: the JAX engine with a drafter whose
    drafts are rejected departs from its own plain greedy stream on a
    mistral with window 8 once the ring wraps (a rejected draft
    overwrites ring entries the window still needs), logits and tokens;
    the port, which writes a ring only after the accept, equals the JAX
    package's plain greedy stream there, in both pools."""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.ops.sampling import SamplingConfig as JaxSampling
from cake_tpu.serve import ServeEngine as JaxServeEngine
from cake_tpu_torch import obs
from cake_tpu_torch.bench.graph_cases import engine_addresses
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import KVPoolExhausted, PagedKV, ServeEngine, faults
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
CTX, CHUNK, BT, BLOCKS, K = 128, 16, 8, 12, 4
REP = [5, 9, 17, 23] * 4 + [5, 9]
P_B = [100, 2, 5, 9, 11, 40]
MODES = {"contiguous": {}, "paged": dict(kv_blocks=BLOCKS,
                                         kv_block_tokens=BT)}


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.clear()


def _carry(jm, cfg, ctx=CTX):
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    return TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                     dtype=torch.float32, device="cpu", max_cache_len=ctx)


@pytest.fixture(scope="module")
def pair():
    over = dict(max_position_embeddings=512)
    jm = JaxTextModel(jax_tiny_config("qwen3", **over), dtype=jnp.float32,
                      seed=7, max_cache_len=CTX)
    return jm, _carry(jm, tiny_config("qwen3", **over))


def _engine(tm, mode="contiguous", **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_queue", 8)
    kw.setdefault("ctx_len", CTX)
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("prefix_cache_mb", 0)
    kw.setdefault("spec", "ngram")
    kw.setdefault("spec_k", K)
    return ServeEngine(tm, **{**MODES[mode], **kw})


def _serve(eng, plans, sampling=GREEDY):
    try:
        rs = [eng.submit(p, max_new_tokens=n, sampling=sampling)
              for p, n in plans]
        for r in rs:
            assert r.wait(300), "request never finished"
            assert "error" not in r.result, r.result.get("error")
        return [r.result["tokens"] for r in rs], eng.health()
    finally:
        eng.close()


def _plain(tm, plans):
    return [tm.generate(p, n, spec=False)[0] for p, n in plans]


# -- greedy parity ---------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_engine_greedy_parity(pair, mode):
    """REP speculates (multi-token accepts), P_B's drafter abstains at
    first (a plain step inside the verify): the port's streams equal the
    JAX engine's spec streams, the port's plain engine and generate."""
    jm, tm = pair
    plans = [(REP, 40), (P_B, 30)]
    want = _plain(tm, plans)
    jeng = JaxServeEngine(jm, slots=2, max_queue=8, ctx_len=CTX,
                          prefill_chunk=CHUNK, prefix_cache_mb=0,
                          spec="ngram", spec_k=K, **MODES[mode])
    try:
        jrs = [jeng.submit(p, max_new_tokens=n, sampling=JaxSampling())
               for p, n in plans]
        for r in jrs:
            assert r.wait(600) and "error" not in r.result
        jtoks = [r.result["tokens"] for r in jrs]
        jacc = jeng.spec_accepted
    finally:
        jeng.close()
    before = obs.SPEC_ACCEPTED.value()
    got, h = _serve(_engine(tm, mode), plans)
    assert got == jtoks == want
    assert _serve(_engine(tm, mode, spec=False), plans)[0] == want
    assert h["spec"]["accepted"] > 0 and jacc > 0
    assert h["spec"]["verify_replays"] > 0
    assert h["spec"]["k"] == K and h["spec"]["drafter"] == "ngram"
    assert obs.SPEC_ACCEPTED.value() - before == h["spec"]["accepted"]


class WrongDrafter:
    """Shareable, stateless, and almost always wrong: proposes the k
    tokens after the last one shifted by 7 (both packages' Drafter
    protocol)."""
    name = "wrong"
    shareable = True

    def propose(self, ids, k):
        return [(ids[-1] + 7 + j) % 256 for j in range(k)]

    def reset(self):
        pass


class OracleDrafter:
    """Shareable and always right: proposes the continuation of a known
    greedy stream (so every draft is accepted)."""
    name = "oracle"
    shareable = True

    def __init__(self, prompt, stream):
        self.n, self.stream = len(prompt), stream

    def propose(self, ids, k):
        done = len(ids) - self.n
        return self.stream[done:done + k]

    def reset(self):
        pass


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_engine_eos_and_budget_inside_accepted_prefix(pair, mode):
    """With drafts that are always right (5 tokens per verify at k = 4),
    a token of the plain stream made EOS ends the spec stream inside an
    accepted prefix exactly where plain decoding ends, and a budget that
    runs out mid-accept emits exactly max_new_tokens."""
    _, tm = pair
    plain = _plain(tm, [(REP, 40)])[0]
    # a draft of the 2nd verify (stream indices 6..9) seen nowhere before
    j = next(j for j in range(6, 10) if plain[j] not in plain[:j])
    eos = plain[j]
    cfg = dataclasses.replace(tm.cfg, eos_token_ids=(eos,))
    te = TextModel(cfg, tm.params, dtype=torch.float32, device="cpu",
                   max_cache_len=CTX)
    oracle = OracleDrafter(REP, plain)
    got, h = _serve(_engine(te, mode, spec=oracle), [(REP, 40)])
    assert got == [plain[:j + 1]] == [te.generate(REP, 40, spec=False)[0]]
    assert h["spec"]["accepted"] == h["spec"]["proposed"] > 0
    for n in (7, 10, 13):
        got, h = _serve(_engine(tm, mode, spec=oracle), [(REP, n)])
        assert got == [plain[:n]]
        assert h["spec"]["accepted"] == h["spec"]["proposed"] > 0


# -- paged pressure ----------------------------------------------------------------


@pytest.mark.parametrize("preempt_mode", ["swap", "recompute"])
def test_spec_preemption_mid_speculation(pair, preempt_mode):
    """Two speculating streams outgrow a 12-block pool: one is preempted
    mid-speculation and resumed; both equal their plain streams. Swap:
    every position a blob carries lies below its committed frontier (the
    speculative tail went back to the pool first)."""
    _, tm = pair
    plans = [(REP, 60), (P_B, 60)]
    want = _plain(tm, plans)
    eng = _engine(tm, "paged", preempt_mode=preempt_mode, spec_k=6)
    blobs = []
    real = eng.paged.swap_out

    def spy(slot, carries):
        blob = real(slot, carries)
        front = int(blob["carries"][1])
        worst = max((int(saved["pos"].max()) for saved in blob["layers"]
                     if saved), default=-1)
        blobs.append((worst, front))
        return blob

    eng.paged.swap_out = spy
    got, h = _serve(eng, plans)
    assert got == want
    assert h["kv_pool"]["preemptions"][preempt_mode] >= 1
    if preempt_mode == "swap":
        assert blobs and all(w < f for w, f in blobs), blobs
    eng.paged.alloc.check()


def test_spec_degrades_to_decode_at_pool_edge(pair):
    """A window the pool cannot back degrades to a plain step instead of
    preempting: one stream pushed past the 96-token pool gets as far as
    the plain engine (typed KVPoolExhausted at the same token), with no
    preemption, and the engine serves on."""
    _, tm = pair

    def run(spec):
        eng = _engine(tm, "paged", spec=spec, spec_k=6)
        try:
            r = eng.submit(REP, max_new_tokens=110, sampling=GREEDY)
            assert r.wait(300)
            assert isinstance(r.result.get("error"), KVPoolExhausted)
            h = eng.health()
            r2 = eng.submit(P_B, max_new_tokens=6, sampling=GREEDY)
            assert r2.wait(300) and "error" not in r2.result
            return r.tokens, h, r2.result["tokens"]
        finally:
            eng.close()
    plain, _, _ = run(False)
    toks, h, after = run("ngram")
    assert toks == plain and len(toks) > 70
    assert sum(h["kv_pool"]["preemptions"].values()) == 0
    assert h["spec"]["accepted"] > 0
    assert after == _plain(tm, [(P_B, 6)])[0]


def test_paged_trim_to_rolls_back_tail(pair):
    _, tm = pair
    pk = PagedKV.build(tm, 2, CTX, 8, BT, CHUNK)
    assert pk.reserve_range(0, 0, 3 * BT + 2)       # blocks 0..3
    assert pk.alloc.free_count == 4
    assert pk.trim_to(0, 10) == 2                   # 10 tokens: 2 blocks
    assert pk.alloc.free_count == 6
    assert pk.alloc.tables[0][2] == pk.NULL == pk.alloc.tables[0][3]
    assert pk.alloc.tables[0][0] != pk.NULL
    assert int(pk.tables[0, 2]) == pk.NULL          # the device mirror
    assert pk.trim_to(0, 10) == 0
    pk.alloc.check()


# -- the engine's contract -------------------------------------------------------


def test_engine_refuses_stateful_drafter(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="per-sequence state"):
        _engine(tm, spec=tm)


@pytest.mark.parametrize("mode", list(MODES))
def test_verify_addresses_stable_across_steps_and_a_rebuild(pair, mode):
    """The verify reads and writes fixed buffers: every data_ptr the
    decode, verify and prefill programs touch, and the graph objects,
    are unchanged across speculating iterations and an injected device
    failure's in-place rebuild, and the streams still equal plain."""
    _, tm = pair
    plans = [(REP, 30), (P_B, 24)]
    want = _plain(tm, plans)
    faults.install("raise_on_step=8;kind=device")
    eng = _engine(tm, mode)
    ptrs = engine_addresses(eng)
    graphs = dict(eng.verify_graphs)
    assert set(graphs) == {False, True}
    assert {n: t.data_ptr() for n, t in eng.spec.tensors().items()} == \
        {n[5:]: p for n, p in ptrs.items() if n.startswith("spec.")}
    got, h = _serve(eng, plans)
    assert got == want
    assert h["rebuilds"] == 1 and h["spec"]["accepted"] > 0
    assert engine_addresses(eng) == ptrs
    assert all(eng.verify_graphs[f] is g for f, g in graphs.items())
    assert eng.spec.decode is eng.carries


def test_spec_sampled_alone_equals_in_company(pair):
    """A sampled request under speculation (temperature 0.8, top_k 40,
    the filtering verify; drafts from a drafter that always proposes)
    gives the same tokens alone and beside a greedy speculating
    neighbour admitted after it; two runs agree."""
    _, tm = pair
    scfg = SamplingConfig(temperature=0.8, top_k=40)

    def run(company):
        eng = _engine(tm, seed=5, spec=WrongDrafter())
        try:
            r = eng.submit(REP, max_new_tokens=30, sampling=scfg)
            rs = [eng.submit(P_B, max_new_tokens=30, sampling=GREEDY)
                  for _ in range(company)]
            for x in [r] + rs:
                assert x.wait(300) and "error" not in x.result
            return r.result["tokens"], eng.spec_steps
        finally:
            eng.close()
    alone, steps = run(0)
    assert run(0)[0] == alone and steps > 0
    assert run(1)[0] == alone


# -- the windowed-ring question -------------------------------------------------

W = 8
WIN_PROMPT = [int(t) for t in np.random.default_rng(1).integers(3, 256, 10)]


def _windowed(global_layers=()):
    over = dict(sliding_window=W, max_position_embeddings=CTX)
    jcfg = dataclasses.replace(jax_tiny_config("mistral", **over),
                               global_layers=global_layers)
    cfg = dataclasses.replace(tiny_config("mistral", **over),
                              global_layers=global_layers)
    jm = JaxTextModel(jcfg, dtype=jnp.float32, seed=11, max_cache_len=CTX)
    return jm, _carry(jm, cfg)


@pytest.fixture(scope="module")
def windowed():
    return _windowed()


def _jax_serve(jm, spec, n, **kw):
    eng = JaxServeEngine(jm, slots=2, max_queue=4, ctx_len=CTX,
                         prefill_chunk=CHUNK, prefix_cache_mb=0, spec=spec,
                         spec_k=K, **kw)
    try:
        r = eng.submit(WIN_PROMPT, max_new_tokens=n, sampling=JaxSampling())
        assert r.wait(600) and "error" not in r.result
        return r.result["tokens"], eng.spec_steps
    finally:
        eng.close()


def test_reference_windowed_ring_spec_departs_from_plain(windowed):
    """The JAX package alone (a fault of the reference, ROADMAP §3): a
    mistral whose every layer has a window of 8, served greedy past 3x
    its window with a drafter whose drafts are rejected, departs from
    the same engine with speculation off; at the model level, the
    next-token logits after rejected verify steps differ from plain
    decoding's at the same position. Its verify writes all k + 1 entries
    into the ring before the accept is known, and truncate_layers cannot
    bring back the older entries the rejected drafts overwrote."""
    jm, _ = windowed
    assert all(s.window == W for s in jm.cfg.layer_specs())
    n = 3 * W + 16
    plain, _ = _jax_serve(jm, False, n)
    spec, steps = _jax_serve(jm, WrongDrafter(), n)
    assert steps > 0 and len(plain) == len(spec) == n
    assert spec != plain
    # logits: rejected verifies, then one decode step from both caches
    lg, cache = jm.prefill(jm.new_cache(1, kv_len=CTX), WIN_PROMPT)
    out, pos = [int(np.argmax(np.asarray(lg[0])))], len(WIN_PROMPT)
    recent = jnp.full((64,), -1, jnp.int32).at[-1].set(out[0])
    while pos < len(WIN_PROMPT) + 2 * W:
        draft = WrongDrafter().propose(out, K)
        packed, cache, recent = jm.verify_tokens(
            cache, out[-1], draft, K, pos, jax.random.PRNGKey(0), recent,
            JaxSampling())
        n_acc, nxt = (int(t) for t in np.asarray(packed))
        out += draft[:n_acc] + [nxt]
        pos += n_acc + 1
    _, ref = jm.prefill(jm.new_cache(1, kv_len=CTX),
                        WIN_PROMPT + out[:-1])
    want, _ = jm.decode_logits(ref, out[-1])
    got, _ = jm.decode_logits(cache, out[-1])
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) > 1e-2


@pytest.mark.parametrize("mode", list(MODES))
def test_port_windowed_ring_spec_equals_reference_plain(windowed, mode):
    """The port keeps the contract the reference documents: with the same
    rejected drafts its spec stream equals the JAX package's PLAIN greedy
    stream (every layer windowed contiguous; full and windowed layers
    alternating paged, the rings in per-slot rows), and generate under
    the same drafter equals plain generate; after rejected verify steps
    the next logits equal plain decoding's within 1e-4."""
    jm, tm = windowed if mode == "contiguous" else \
        _windowed(global_layers=(0, 2))
    n = 3 * W + 16
    want = jm.generate(WIN_PROMPT, max_new_tokens=n, spec=False)[0]
    got, h = _serve(_engine(tm, mode, spec=WrongDrafter()),
                    [(WIN_PROMPT, n)])
    assert got == [want] and h["spec"]["steps"] > 0
    assert tm.generate(WIN_PROMPT, n, spec=WrongDrafter(),
                       spec_k=K)[0] == want
    if mode != "contiguous":
        return
    _, cache = tm.prefill(tm.new_cache(1, kv_len=CTX), WIN_PROMPT)
    out, pos = [want[0]], len(WIN_PROMPT)
    recent = torch.full((1, 64), -1, dtype=torch.int32)
    recent[0, -1] = out[0]
    while pos < len(WIN_PROMPT) + 2 * W:
        draft = WrongDrafter().propose(out, K)
        packed, cache, recent = tm.verify_tokens(cache, out[-1], draft, K,
                                                 pos, 0, 1, recent, GREEDY)
        n_acc, nxt = packed.tolist()
        out += draft[:n_acc] + [nxt]
        pos += n_acc + 1
    _, ref = jm.prefill(jm.new_cache(1, kv_len=CTX), WIN_PROMPT + out[:-1])
    wantl, _ = jm.decode_logits(ref, out[-1])
    gotl, _ = tm.decode_logits(cache, out[-1])
    np.testing.assert_allclose(gotl.numpy(), np.asarray(wantl), atol=1e-4,
                               rtol=0)
