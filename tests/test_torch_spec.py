"""Speculative decoding in the port (cake_tpu_torch/spec/, ops/sampling.py:
filtered_probs and spec_accept, the cache's verify writes and truncate,
TextModel's verify programs and generate(spec=)) against the JAX
package's cake_tpu/spec/ and its programs, on a tiny qwen3 whose weights
are carried across with params_from_numpy, float32, atol 1e-5 unless a
test says otherwise:

  * NGramDrafter's proposals equal the reference's on repetitive and
    random sequences, and so do DraftModelDrafter's;
  * filtered_probs matches with and without filters;
  * spec_accept, greedy: n_acc, the next token and the recent window
    equal the reference's over seeded logits, drafts, paddings and
    penalties; sampled: properties only (a certain draft is always
    accepted, an impossible one always rejected, the emitted token's
    marginal is p by a chi-square test, a row alone equals the row in
    company), since the noise cannot match JAX's threefry;
  * truncate_layers matches;
  * verify_tokens, spec_slots and spec_slots_paged against the
    reference's programs: logits at 1e-4 (the reference's verify forward
    rebuilt from its own layer functions), equal n_acc and next tokens,
    equal committed positions;
  * generate under speculation (n-gram, and the model as its own draft
    model: every draft accepted) equals plain generate and the JAX
    package's generate, token for token."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.models.common import cache as jcache
from cake_tpu.models.common import layers as jlayers
from cake_tpu.ops import sampling as jsamp
from cake_tpu.spec import DraftModelDrafter as JaxDraftModelDrafter
from cake_tpu.spec import NGramDrafter as JaxNGramDrafter
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common import cache as tcache
from cake_tpu_torch.ops import sampling as tsamp
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.spec import (MAX_SPEC_K, DraftModelDrafter, NGramDrafter,
                                 resolve_drafter, spec_knobs)
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
GREEDY = SamplingConfig(temperature=0.0)
CTX = 128
K = 4
REP = [5, 9, 17, 23] * 4 + [5, 9]
RAND = list(range(3, 43))


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


# -- drafters -------------------------------------------------------------------


@pytest.mark.parametrize("seq,k,max_ngram", [
    (REP, 4, 3), (REP, 2, 3), (REP, 7, 2), (RAND, 4, 3), ([1, 2], 4, 3),
    (REP, 0, 3), ([7, 8, 9, 1, 8, 2, 7, 8, 9, 5, 7, 8], 3, 3),
    ([4, 4, 4, 4, 4], 6, 4),
] + [([int(t) for t in np.random.default_rng(s).integers(0, 6, 40)], k, 3)
     for s, k in ((1, 3), (2, 6), (3, 1), (4, 8))])
def test_ngram_matches_reference(seq, k, max_ngram):
    want = JaxNGramDrafter(max_ngram=max_ngram).propose(seq, k)
    assert NGramDrafter(max_ngram=max_ngram).propose(seq, k) == want


def test_ngram_validates_bounds():
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=1, min_ngram=2)
    with pytest.raises(ValueError):
        NGramDrafter(min_ngram=0)


def test_draft_model_drafter_matches_reference(pair):
    """The target as its own draft model: the same proposals as the JAX
    drafter over a growing sequence (each call forwards the unseen suffix
    and rolls its speculation back), across a cache growth."""
    jm, tm = pair
    jd, td = JaxDraftModelDrafter(jm), DraftModelDrafter(tm)
    seq = list(REP)
    for step in range(6):
        want = jd.propose(seq, K)
        assert td.propose(seq, K) == want
        seq += want[:1 + step % 3] + [11 + step]
    assert td.kv_len > 32                   # it grew past the first bucket


def test_resolve_drafter(monkeypatch, pair):
    _, tm = pair
    for name in ("CAKE_SPEC", "CAKE_SPEC_K", "CAKE_SPEC_NGRAM",
                 "CAKE_SPEC_RESERVE"):
        monkeypatch.delenv(name, raising=False)
    assert resolve_drafter(None) == (None, 6)
    assert resolve_drafter(False, 99) == (None, MAX_SPEC_K)
    monkeypatch.setenv("CAKE_SPEC", "ngram")
    monkeypatch.setenv("CAKE_SPEC_K", "0")
    monkeypatch.setenv("CAKE_SPEC_NGRAM", "1")
    d, k = resolve_drafter(None)
    assert isinstance(d, NGramDrafter) and k == 1 and d.max_ngram == 2
    assert spec_knobs()["spec_reserve"] == 0
    monkeypatch.setenv("CAKE_SPEC_RESERVE", "-3")
    assert spec_knobs()["spec_reserve"] == 0
    d, _ = resolve_drafter(tm)
    assert isinstance(d, DraftModelDrafter) and not d.shareable
    with pytest.raises(ValueError):
        resolve_drafter("medusa")


# -- the target distribution and the accept rule --------------------------------


def _settings(rng, n):
    temp = rng.choice([0.0, 0.7, 1.0, 1.3], n).astype(np.float32)
    top_k = rng.choice([3, 50, 256], n).astype(np.int32)
    top_p = rng.choice([0.5, 0.9, 1.0], n).astype(np.float32)
    pen = rng.choice([1.0, 1.3, 1.8], n).astype(np.float32)
    return temp, top_k, top_p, pen


@pytest.mark.parametrize("use_filters", [True, False])
def test_filtered_probs_matches_reference(use_filters):
    rng = np.random.default_rng(5)
    r, v, n = 12, 256, 16
    logits = (rng.standard_normal((r, v)) * 3).astype(np.float32)
    recent = rng.integers(-1, v, (r, n)).astype(np.int32)
    temp, top_k, top_p, pen = _settings(rng, r)
    temp = np.maximum(temp, 0.5)        # a point mass compares trivially
    if not use_filters:
        top_k[:], top_p[:] = v, 1.0
    got = tsamp.filtered_probs(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(pen), torch.from_numpy(recent), use_filters)
    for i in range(r):
        want = jsamp.filtered_probs(
            jnp.asarray(logits[i]), jnp.float32(temp[i]),
            jnp.int32(top_k[i]), jnp.float32(top_p[i]), jnp.float32(pen[i]),
            jnp.asarray(recent[i]), use_filters=use_filters)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


def _greedy_chain(logits, recent, pen, n_acc, k, v):
    """Drafts whose first n_acc entries are the reference's penalized
    argmax chain and whose entry n_acc is not."""
    drafts, win = [], list(recent)
    for i in range(k):
        p = jsamp.filtered_probs(jnp.asarray(logits[i]), jnp.float32(0.0),
                                 jnp.int32(v), jnp.float32(1.0),
                                 jnp.float32(pen), jnp.asarray(win))
        best = int(jnp.argmax(p))
        d = best if i < n_acc else (best + 1 + i) % v
        drafts.append(d)
        win = win[1:] + [d]
    return drafts


@pytest.mark.parametrize("filt", [True, False])
def test_spec_accept_greedy_matches_reference(filt):
    """Greedy rows over seeded logits: planned accept lengths 0..k,
    padded windows (n_drafts < k, 0 = a plain step) and repeat penalties
    whose windows see the accepted drafts: n_acc, the next token and the
    recent window equal the reference's row by row."""
    rng = np.random.default_rng(11)
    b, v, n = 10, 256, 8
    logits = (rng.standard_normal((b, K + 1, v)) * 2).astype(np.float32)
    recent = rng.integers(-1, v, (b, n)).astype(np.int32)
    pen = rng.choice([1.0, 1.5, 2.5], b).astype(np.float32)
    plan = [0, 1, 2, 3, 4, 4, 2, 0, 3, 1]
    n_drafts = np.asarray([4, 4, 4, 4, 4, 3, 1, 0, 2, 4], np.int32)
    drafts = np.stack([_greedy_chain(logits[i], list(recent[i]), pen[i],
                                     plan[i], K, v) for i in range(b)])
    drafts = drafts.astype(np.int32)
    zeros = np.zeros(b, np.float32)
    n_acc, nxt, rec = tsamp.spec_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(n_drafts), torch.zeros(b, dtype=torch.int64),
        torch.zeros(b, dtype=torch.int64), torch.from_numpy(zeros),
        torch.full((b,), v, dtype=torch.int32), torch.ones(b),
        torch.from_numpy(pen), torch.from_numpy(recent), filt)
    for i in range(b):
        wa, wn, wr = jsamp.spec_accept(
            jnp.asarray(logits[i]), jnp.asarray(drafts[i]),
            jnp.int32(n_drafts[i]), jax.random.PRNGKey(i), jnp.float32(0.0),
            jnp.int32(v), jnp.float32(1.0), jnp.float32(pen[i]),
            jnp.asarray(recent[i]), use_filters=filt)
        assert int(n_acc[i]) == int(wa) == min(plan[i], n_drafts[i])
        assert int(nxt[i]) == int(wn)
        np.testing.assert_array_equal(rec[i].numpy(), np.asarray(wr))


def _accept(logits, drafts, n_drafts, keys, counters, temp=1.0,
            pen=1.0, top_k=None, top_p=1.0):
    b, k1, v = logits.shape

    def full(x, dtype):
        return torch.full((b,), x, dtype=dtype)
    return tsamp.spec_accept(
        torch.as_tensor(logits, dtype=torch.float32),
        torch.as_tensor(drafts, dtype=torch.int32),
        torch.as_tensor(n_drafts, dtype=torch.int32),
        torch.as_tensor(keys, dtype=torch.int64),
        torch.as_tensor(counters, dtype=torch.int64),
        full(temp, torch.float32), full(top_k or v, torch.int32),
        full(top_p, torch.float32), full(pen, torch.float32),
        torch.full((b, 4), -1, dtype=torch.int32))


def test_spec_accept_sampled_certain_and_impossible_drafts():
    n = 64
    certain = np.zeros((n, 3, 4), np.float32)
    certain[:, 0, 2] = certain[:, 1, 1] = certain[:, 2, 3] = 50.0
    n_acc, nxt, _ = _accept(certain, [[2, 1]] * n, [2] * n, np.arange(n),
                            np.arange(n) * 3)
    assert n_acc.tolist() == [2] * n and nxt.tolist() == [3] * n
    impossible = np.zeros((n, 3, 4), np.float32)
    impossible[:, 0, 2] = 50.0
    n_acc, nxt, _ = _accept(impossible, [[1, 0]] * n, [2] * n, np.arange(n),
                            np.zeros(n))
    assert n_acc.tolist() == [0] * n and nxt.tolist() == [2] * n


def test_spec_accept_sampled_marginal_is_p():
    """p = [0.5, 0.3, 0.15, 0.05] with draft token 0 over 20,000 rows
    (each its own key and counter): the accept rate is p(0), and the
    emitted token's marginal is p (chi-square, p-value > 1e-3); the bonus
    token after an accept is drawn from the next row's p as well."""
    p = np.array([0.5, 0.3, 0.15, 0.05])
    n = 20000
    logits = np.log(p)[None, None, :].repeat(n, 0).repeat(2, 1)
    n_acc, nxt, _ = _accept(logits, [[0]] * n, [1] * n, np.arange(n) * 7 + 3,
                            np.arange(n) % 5)
    acc = n_acc.numpy() > 0
    assert abs(acc.mean() - p[0]) < 0.015
    first = np.where(acc, 0, nxt.numpy())
    assert stats.chisquare(np.bincount(first, minlength=4),
                           p * n).pvalue > 1e-3
    bonus = nxt.numpy()[acc]
    assert stats.chisquare(np.bincount(bonus, minlength=4),
                           p * acc.sum()).pvalue > 1e-3


def test_spec_accept_row_alone_equals_row_in_company():
    """Each row's outcome is a function of its own logits, drafts, key and
    counter: a sampled row run alone equals the same row among others
    (and counters change the draw)."""
    rng = np.random.default_rng(3)
    b, v = 6, 64
    logits = rng.standard_normal((b, K + 1, v)).astype(np.float32)
    drafts = rng.integers(0, 8, (b, K)).astype(np.int32)
    nd = np.asarray([4, 3, 0, 4, 2, 1], np.int32)
    keys, ctr = np.arange(b) * 101 + 5, np.arange(b) + 2
    n_acc, nxt, _ = _accept(logits, drafts, nd, keys, ctr, temp=0.9,
                            top_k=20)
    for i in range(b):
        a1, n1, _ = _accept(logits[i:i + 1], drafts[i:i + 1], nd[i:i + 1],
                            keys[i:i + 1], ctr[i:i + 1], temp=0.9, top_k=20)
        assert (int(a1[0]), int(n1[0])) == (int(n_acc[i]), int(nxt[i]))
    draws = {tuple(_accept(logits[:1].repeat(1, 0), drafts[:1], [0], [9],
                           [c], temp=1.0)[1].tolist()) for c in range(40)}
    assert len(draws) > 1


# -- the cache ---------------------------------------------------------------


def test_truncate_layers_matches_reference(pair):
    jm, tm = pair
    rng = np.random.default_rng(2)
    pos = rng.integers(-1, 60, (3, 64)).astype(np.int32)
    kv = rng.standard_normal((3, 64, 2, 16)).astype(np.float32)
    jl = [{"k": jnp.asarray(kv), "v": jnp.asarray(kv),
           "pos": jnp.asarray(pos)}]
    tl = [{"k": torch.from_numpy(kv.copy()), "v": torch.from_numpy(kv.copy()),
           "pos": torch.from_numpy(pos.copy())}]
    cfg1 = dataclasses.replace(jm.cfg, num_hidden_layers=1)
    want = jcache.truncate_layers(cfg1, jl, jnp.int32(37))
    got = tcache.truncate_layers(tm.cfg, tl, 37)
    np.testing.assert_array_equal(got[0]["pos"].numpy(),
                                  np.asarray(want[0]["pos"]))


def test_truncate_and_grow_cache(pair):
    """truncate_cache rolls a prefilled cache back (pos clamped), and
    grow_cache re-homes it: the next decode logits equal a fresh prefill
    of the kept prefix's."""
    _, tm = pair
    _, cache = tm.prefill(tm.new_cache(1, kv_len=32), REP)
    tcache.truncate_cache(tm.cfg, cache, 12)
    assert cache["pos"] == 12
    grown = tm.grow_cache(cache, 64)
    assert grown["layers"][0]["k"].shape[1] == 64
    got, _ = tm.decode_logits(grown, REP[12])
    _, fresh = tm.prefill(tm.new_cache(1, kv_len=64), REP[:12])
    want, _ = tm.decode_logits(fresh, REP[12])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


# -- the verify programs against the reference's ------------------------------


def _ref_verify_logits(jm, layers_np, row, tok, draft, pos, n_input):
    """The reference's verify forward for one row (the body of its
    `_spec_slots.one`): [tok, drafts] at pos over the row's batch-1
    cache, logits at every position."""
    cfg = jm.cfg
    cache = {"layers": [{n: jnp.asarray(lc[n][row:row + 1]) for n in lc}
                        for lc in layers_np], "pos": jnp.int32(pos)}
    tokens = jnp.asarray([[tok] + list(draft)], jnp.int32)
    x = jlayers.embed_tokens(cfg, jm.params, tokens)
    x, _ = jlayers.forward_layers(cfg, jm.params, x, cache, jnp.int32(pos),
                                  valid_len=jnp.int32(n_input))
    return np.asarray(jlayers.lm_head_logits(cfg, jm.params, x)[0])


def _fill(jm, tm, prompts):
    """Both packages' contiguous pools with prompt b prefilled into row
    b; returns (jlayers, tlayers, first tokens)."""
    b = len(prompts)
    jl = jm.new_cache(b, kv_len=CTX)["layers"]
    tl = tm.new_cache(b, kv_len=CTX)["layers"]
    firsts = []
    for i, ids in enumerate(prompts):
        jlog, jl = jm.prefill_chunk(jl, i, ids, 0)
        tlog, _ = tm.prefill_chunk(tl, i, ids, 0)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=0)
        firsts.append(int(np.argmax(np.asarray(jlog)[0])))
    return jl, tl, firsts


def _greedy_future(tm, ids, n):
    """The plain greedy continuation of ids (n tokens)."""
    return tm.generate(ids, n, spec=False)[0]


def _carries(b, v, toks, pos, active):
    jc = dict(toks=jnp.asarray(toks, jnp.int32),
              pos=jnp.asarray(pos, jnp.int32),
              rngs=jnp.stack([jax.random.PRNGKey(i) for i in range(b)]),
              recents=jnp.full((b, 64), -1, jnp.int32),
              temps=jnp.zeros(b, jnp.float32), top_ks=jnp.full(b, v,
                                                               jnp.int32),
              top_ps=jnp.ones(b, jnp.float32), pens=jnp.ones(b, jnp.float32),
              active=jnp.asarray(active))
    tc = dict(toks=torch.tensor(toks, dtype=torch.int32),
              pos=torch.tensor(pos, dtype=torch.int32),
              recents=torch.full((b, 64), -1, dtype=torch.int32),
              keys=torch.arange(b, dtype=torch.int64),
              counters=torch.ones(b, dtype=torch.int64),
              temps=torch.zeros(b), top_ks=torch.full((b,), v,
                                                      dtype=torch.int32),
              top_ps=torch.ones(b), pens=torch.ones(b),
              active=torch.tensor(active))
    return jc, tc


def _args(tc, drafts, nd):
    """The verify's carries, drafts and filt=False, in order."""
    return (tc["toks"], tc["pos"], tc["recents"], tc["keys"],
            tc["counters"], tc["temps"], tc["top_ks"], tc["top_ps"],
            tc["pens"], tc["active"], torch.from_numpy(drafts),
            torch.from_numpy(nd), False)


def _copy(layers):
    return [{n: t.clone() for n, t in lc.items()} for lc in layers]


PROMPTS = [REP, RAND[:20], REP[:10] + [200, 201]]


def _plans(tm, firsts):
    """Per row: drafts the plain greedy stream agrees with (row 0), wrong
    ones (row 1), and a row left inactive (row 2)."""
    fut = _greedy_future(tm, PROMPTS[0], K + 1)
    assert fut[0] == firsts[0]
    right = fut[1:K + 1]
    wrong = [(t + 3) % 256 for t in _greedy_future(tm, PROMPTS[1],
                                                   K + 1)[1:]]
    return np.asarray([right, wrong, [0] * K], np.int32), \
        np.asarray([K, K - 1, 0], np.int32)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_slots_match_reference(pair, paged):
    """One batched verify over 3 rows (all drafts right, drafts wrong with
    a padded window, an inactive row), contiguous or paged: the port's
    logits within 1e-4 of the reference's verify forward at every valid
    position, n_acc and next tokens equal to the reference's spec_slots /
    spec_slots_paged, the committed positions equal (contiguous: every
    pos entry of the pool; paged: each row's gathered view), and the
    carries advanced by n_acc + 1."""
    jm, tm = pair
    v = tm.cfg.vocab_size
    jl, tl, firsts = _fill(jm, tm, PROMPTS)
    lens = [len(p) for p in PROMPTS]
    drafts, nd = _plans(tm, firsts)
    active = [True, True, False]
    jc, tc = _carries(3, v, firsts, lens, active)
    want_logits = [_ref_verify_logits(
        jm, [{n: np.asarray(t) for n, t in lc.items()} for lc in jl], i,
        firsts[i], drafts[i], lens[i], nd[i] + 1) for i in range(2)]
    if not paged:
        jpk, jl2, *_ = jm.spec_slots(
            jl, jc["toks"], jc["pos"], jc["rngs"], jc["recents"],
            jc["temps"], jc["top_ks"], jc["top_ps"], jc["pens"],
            jc["active"], drafts, nd, nb=3, filt=False)
        logits = tm._verify_step(_copy(tl), *_args(tc, drafts, nd))[0]
        tpk, ttoks, tpos, _, tctr = tm.spec_slots(
            tl, *_args(tc, drafts, nd)[:-1], filt=False)
        for jlc, tlc in zip(jl2, tl):
            np.testing.assert_array_equal(tlc["pos"].numpy(),
                                          np.asarray(jlc["pos"]))
    else:
        bt, nb, m = 8, 40, CTX // 8
        table = np.full((3, m), nb, np.int32)
        perm = np.random.default_rng(4).permutation(nb)
        for i, n in enumerate(lens[:2]):
            need = (n + K) // bt + 1
            table[i, :need] = perm[i * 8:i * 8 + need]
        jpool, jrows = jcache.init_paged_layers(jm.cfg, nb, bt, 3, CTX,
                                                jnp.float32)
        tpool, trows = tm.new_paged(nb, bt, 3, CTX)
        jt, tt = jnp.asarray(table), torch.from_numpy(table.copy())
        for i in range(2):
            _, jpool, jrows = jm.prefill_chunk_paged(
                jpool, jrows, jt, i, PROMPTS[i], 0, CTX)
            tm.prefill_chunk_paged(tpool, trows, tt, i, PROMPTS[i], 0)
        jpk, jpool, *_ = jm.spec_slots_paged(
            jpool, jrows, jt, jc["toks"], jc["pos"], jc["rngs"],
            jc["recents"], jc["temps"], jc["top_ks"], jc["top_ps"],
            jc["pens"], jc["active"], drafts, nd, nb=3, filt=False)
        logits = tm._verify_step(
            tm.paged_layers(_copy(tpool), _copy(trows), tt.clone()),
            *_args(tc, drafts, nd))[0]
        tpk, ttoks, tpos, _, tctr = tm.spec_slots_paged(
            tpool, trows, tt, *_args(tc, drafts, nd)[:-1], filt=False)
        for jp, tp in zip(jpool, tpool):
            for i in range(3):
                front = lens[i] + K + 1
                got = tcache.paged_gather_layer(tp, tt[i], front)
                want = jcache.paged_gather_layer(jp, jt[i], jnp.int32(front))
                np.testing.assert_array_equal(got["pos"].numpy(),
                                              np.asarray(want["pos"]))
    for i in range(2):
        n_in = nd[i] + 1
        np.testing.assert_allclose(logits[i, :n_in].numpy(),
                                   want_logits[i][:n_in], atol=1e-4, rtol=0)
    jpk = np.asarray(jpk)
    assert tpk.numpy().tolist() == jpk.tolist()
    assert tpk[1].tolist() == [K, 0, 0]         # right, wrong, inactive
    assert tpos.tolist() == [lens[0] + K + 1, lens[1] + 1, lens[2]]
    assert tctr.tolist() == [2, 2, 1] and int(ttoks[2]) == firsts[2]


def test_verify_tokens_matches_reference(pair):
    """generate's batch-1 verify: a sequence of steps with right, wrong
    and no drafts gives the reference's [n_acc, next] at each step, and
    the same committed cache positions."""
    jm, tm = pair
    fut = _greedy_future(tm, REP, 24)
    jl, jc = jm.prefill(jm.new_cache(1, kv_len=64), REP)
    tl, tc = tm.prefill(tm.new_cache(1, kv_len=64), REP)
    jrec = jnp.full((64,), -1, jnp.int32).at[-1].set(fut[0])
    trec = torch.full((1, 64), -1, dtype=torch.int32)
    trec[0, -1] = fut[0]
    out, pos = [fut[0]], len(REP)
    for step, kind in enumerate(["right", "wrong", "none", "right",
                                 "half", "right"]):
        n_out = len(out)
        right = fut[n_out:n_out + K]
        draft = {"right": right, "none": [],
                 "wrong": [(t + 5) % 256 for t in right],
                 "half": right[:2] + [(right[2] + 1) % 256]}[kind]
        jp, jc, jrec = jm.verify_tokens(jc, out[-1], draft, K, pos,
                                        jax.random.PRNGKey(step), jrec,
                                        jsamp.SamplingConfig())
        tp, tc, trec = tm.verify_tokens(tc, out[-1], draft, K, pos, 5,
                                        step + 1, trec, GREEDY)
        assert tp.tolist() == np.asarray(jp).tolist()
        np.testing.assert_array_equal(trec[0].numpy(), np.asarray(jrec))
        n_acc, nxt = tp.tolist()
        out += draft[:n_acc] + [nxt]
        pos += n_acc + 1
        for jlc, tlc in zip(jc["layers"], tc["layers"]):
            np.testing.assert_array_equal(tlc["pos"].numpy(),
                                          np.asarray(jlc["pos"]))
    assert out == fut[:len(out)]


# -- generate under speculation -------------------------------------------------


@pytest.mark.parametrize("prompt", [REP, RAND[:12]])
def test_generate_spec_equals_plain_and_reference(pair, prompt):
    """Greedy generate with the n-gram drafter and with the model as its
    own draft model equals plain generate and the JAX package's generate
    (with and without its n-gram drafter); the draft model's every
    draft is accepted."""
    jm, tm = pair
    plain, _ = tm.generate(prompt, 40, spec=False)
    assert plain == jm.generate(prompt, max_new_tokens=40, spec=False)[0]
    assert plain == jm.generate(prompt, max_new_tokens=40, spec="ngram",
                                spec_k=K)[0]
    ngram, st = tm.generate(prompt, 40, spec="ngram", spec_k=K)
    assert ngram == plain and st["spec_steps"] > 0
    own, st = tm.generate(prompt, 40, spec=tm, spec_k=K)
    assert own == plain
    assert st["spec_accepted"] == st["spec_proposed"] > 0
    assert st["spec_tokens_per_step"] > 2


def test_generate_spec_sampled_is_deterministic(pair):
    """A sampled stream under speculation is a function of the seed: the
    same seed gives the same tokens, another seed others."""
    _, tm = pair
    scfg = SamplingConfig(temperature=0.8, top_k=50)
    a, _ = tm.generate(REP, 30, scfg, seed=1, spec="ngram", spec_k=K)
    b, _ = tm.generate(REP, 30, scfg, seed=1, spec="ngram", spec_k=K)
    c, _ = tm.generate(REP, 30, scfg, seed=2, spec="ngram", spec_k=K)
    assert a == b and len(a) == 30 and a != c


# -- the paged verify's plain version and the card's helpers, on the CPU ------


@pytest.mark.parametrize("shape", [dict(), dict(hq=4, hkv=1, d=256)])
def test_paged_verify_plain_matches_reference_attention(shape):
    """The paged verify's plain version (what the CPU runs, and what the
    kernel is held against on the card) against the reference's verify
    attention: the JAX package's paged_gather_layer of each slot's
    committed row (frontier p) and multi_head_attention over [row ;
    chunk] with its causal mask, the chunk being the entries the verify
    wrote. Drafts straddle a block boundary, one window is padded, one
    slot shares a prefix block, one is inactive."""
    from cake_tpu.ops.attention import make_attention_mask as jax_mask
    from cake_tpu.ops.attention import multi_head_attention as jax_mha
    from cake_tpu_torch.bench.spec_cases import case_args, verify_case
    from cake_tpu_torch.ops import paged_attention as pa
    s = 7
    slots = [(620, 7), (14, 7), (300, 3), None]   # 14..20 straddles 16
    c = verify_case(slots, s, bt=16, ctx=1024, shared=True, seed=3, **shape)
    got = pa.paged_verify_attention(*case_args(c))
    nb1, bt = c["pos"].shape
    jpl = {n: jnp.asarray(c[n][:-1].numpy()) for n in ("k", "v", "pos")}
    for b, slot in enumerate(slots[:3]):
        p, n = slot
        # the port's sink id is JAX's NULL: the pool without its sink
        table = jnp.asarray(c["tables"][b].numpy())
        view = jcache.paged_gather_layer(jpl, table, jnp.int32(p))
        chunk_pos = np.arange(p, p + s)
        ent = [c["pos"][c["tables"][b, q // bt], q % bt] for q in chunk_pos]
        idx = [(int(c["tables"][b, q // bt]), q % bt) for q in chunk_pos]
        ck = np.stack([c["k"][i, j].numpy() for i, j in idx])[None]
        cv = np.stack([c["v"][i, j].numpy() for i, j in idx])[None]
        kpos = np.where(np.arange(s) < n, chunk_pos, -1)
        assert [int(e) for e in ent[:n]] == list(chunk_pos[:n])
        keys = jnp.concatenate([view["k"][None], jnp.asarray(ck)], 1)
        vals = jnp.concatenate([view["v"][None], jnp.asarray(cv)], 1)
        kp = jnp.concatenate([view["pos"], jnp.asarray(kpos, jnp.int32)])
        mask = jax_mask(jnp.asarray(chunk_pos, jnp.int32)[None], kp[None])
        want = jax_mha(jnp.asarray(c["q"][b:b + 1].numpy()), keys, vals,
                       mask)
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[0, :n], atol=1e-5,
                                   rtol=0)


def test_card_helpers_on_the_cpu(pair):
    """The helpers chip_smoke.py phase 12 runs at full size, on the tiny
    model: the verify 'graph' (the eager call on the CPU) equals the
    eager verify on a clone with a right, a wrong, a sampled and a free
    row, the right row accepting every draft; plain_stream's rows equal
    plain generate; the bounds order as they should."""
    from cake_tpu_torch.bench.graph_cases import build_state
    from cake_tpu_torch.bench.spec_cases import (plain_stream,
                                                 verify_bounds, verify_case,
                                                 verify_vs_eager)
    _, tm = pair
    sampled = SamplingConfig(temperature=0.8, top_k=50)
    for kv_blocks in (0, 40):
        state = build_state(tm, [20, 33, 9, None],
                            [GREEDY, GREEDY, sampled, GREEDY], CTX,
                            kv_blocks=kv_blocks, block_tokens=8, chunk=16,
                            headroom=64, seed=2)
        r = verify_vs_eager(tm, state, K, 4, ["right", "wrong", "right",
                                              None], True)
        assert r["equal"] and r["kv_equal"] and r["carries_equal"]
        assert r["accepted"][0] == 4 * K and r["accepted"][1] == 0
        assert r["tokens"][:, 0, 3].tolist() == [0] * 4
    prompts = [REP, RAND[:9]]
    for kv_blocks in (0, 40):
        rows = plain_stream(tm, prompts, 12, CTX, kv_blocks=kv_blocks,
                            block_tokens=8, chunk=16)
        for row, ids in zip(rows, prompts):
            assert row["tokens"] == tm.generate(ids, 12, spec=False)[0]
            assert len(row["gaps"]) == 12 and min(row["gaps"]) >= 0
    c = verify_case([(620, 7), (100, 4), None], 7, dtype=torch.bfloat16)
    bnd = verify_bounds(c)
    assert 0 < bnd["unique_ms"] < bnd["read_ms"]


def test_cli_reads_the_spec_knobs():
    """`cli serve` and `cli run` take speculation from CAKE_SPEC,
    CAKE_SPEC_K, CAKE_SPEC_NGRAM and CAKE_SPEC_RESERVE with the
    reference's defaults and clamps."""
    from cake_tpu_torch import cli
    assert cli.spec_args({}) == {}
    assert cli.spec_args({"CAKE_SPEC": "off", "CAKE_SPEC_K": "3"}) == {}
    got = cli.spec_args({"CAKE_SPEC": "ngram", "CAKE_SPEC_K": "40",
                         "CAKE_SPEC_NGRAM": "5", "CAKE_SPEC_RESERVE": "3"})
    assert isinstance(got["spec"], NGramDrafter)
    assert got["spec"].max_ngram == 5
    assert (got["spec_k"], got["spec_reserve"]) == (MAX_SPEC_K, 3)
    got = cli.spec_args({"CAKE_SPEC": "ngram"})
    assert (got["spec_k"], got["spec_reserve"], got["spec"].max_ngram) == \
        (6, 0, 3)
