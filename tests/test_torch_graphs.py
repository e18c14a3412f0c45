"""The decode programs' in-place form on the CPU (models/common/graphs.py,
TextModel.decode_slots_into, generate's chunks): the in-place step equals
the eager step bit for bit, contiguous and paged; the engine never moves
a tensor the captured step reads (every KV tensor, table and carry keeps
its data_ptr through admissions, chunked prefill, prefix splices, a swap
and releases); generate's chunks of 16 steps give the step-by-step
loop's tokens with EOS in mid-chunk and with a budget that ends
mid-chunk, and write nothing past the budget."""
import dataclasses

import pytest
import torch

from cake_tpu_torch.bench.graph_cases import (build_state, graph_vs_eager,
                                              step_by_step)
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common.text_model import GEN_CHUNK, bucket_for
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import ServeEngine

torch.set_num_threads(1)
CTX, CHUNK, BT = 128, 16, 8
GREEDY = SamplingConfig(temperature=0.0)
SAMPLED = SamplingConfig(temperature=0.8, top_k=50)
NUCLEUS = SamplingConfig(temperature=1.0, top_p=0.9, repeat_penalty=1.3)


@pytest.fixture(scope="module")
def tm():
    # no EOS: every budget runs to its end unless a test sets one
    cfg = tiny_config("qwen3", max_position_embeddings=512,
                      eos_token_id=None)
    return TextModel(cfg, dtype=torch.float32, device="cpu", seed=3,
                     max_cache_len=CTX)


@pytest.mark.parametrize("kv_blocks", [0, 64], ids=["contiguous", "paged"])
def test_in_place_step_equals_eager_step(tm, kv_blocks):
    """Rows at positions 40, 70 and 23 (greedy, sampled, nucleus with a
    repeat penalty) and one free row: 8 in-place steps through a
    DecodeGraph equal 8 steps of the returning form, token for token,
    KV byte for byte and carry for carry."""
    state = build_state(tm, [40, 70, None, 23],
                        [GREEDY, SAMPLED, GREEDY, NUCLEUS], CTX,
                        kv_blocks=kv_blocks, block_tokens=BT, chunk=CHUNK,
                        headroom=20)
    ref = state.clone()
    r = graph_vs_eager(tm, state, 8)
    assert r["tokens_equal"] and r["kv_equal"] and r["carries_equal"]
    assert r["max_logit_diff"] == 0.0
    assert r["graph"].steps == 8 and r["graph"].graph is None
    ref.activate()
    c = ref.carries
    toks, pos, rec, ctr = c.toks, c.pos, c.recents, c.counters
    args = (c.keys,)
    rest = (c.temps, c.top_ks, c.top_ps, c.pens, c.active)
    for i in range(8):
        if kv_blocks:
            packed, toks, pos, rec, ctr = tm.decode_slots_paged(
                ref.pool, ref.rows, ref.tables, toks, pos, rec, *args, ctr,
                *rest)
        else:
            packed, toks, pos, rec, ctr = tm.decode_slots(
                ref.layers, toks, pos, rec, *args, ctr, *rest)
        assert torch.equal(packed, r["tokens"][i])
    assert all(torch.equal(a, b) for a, b in zip(ref.kv(), state.kv()))
    s = state.carries
    for a, b in ((toks, s.toks), (pos, s.pos), (rec, s.recents),
                 (ctr, s.counters)):
        assert torch.equal(a, b)
    assert s.pos.tolist() == [48, 78, 0, 31]
    assert s.counters.tolist() == [9, 9, 0, 9]
    assert len(set(r["tokens"][:, 1, 1].tolist())) > 1   # sampled row


SYS = [3 + (i * 7) % 200 for i in range(40)]          # 2 full prefix units


def _addresses(eng) -> dict:
    if eng.paged is not None:
        kv = {f"pool{i}.{n}": t for i, pl in enumerate(eng.paged.pool)
              for n, t in pl.items()}
        kv.update({f"rows{i}.{n}": t for i, rl in enumerate(eng.paged.rows)
                   for n, t in rl.items()})
        kv["tables"] = eng.paged.tables
    else:
        kv = {f"layer{i}.{n}": t for i, lc in enumerate(eng._layers)
              for n, t in lc.items()}
    kv.update({f"carry.{n}": t for n, t in eng.carries.tensors().items()})
    return {n: t.data_ptr() for n, t in kv.items()}


@pytest.mark.parametrize("kw", [{}, dict(kv_blocks=12, kv_block_tokens=BT)],
                         ids=["contiguous", "paged"])
def test_engine_keeps_every_address(tm, kw):
    """A prefix insert, a prefix hit (a splice), chunked prefills, two
    sampled streams that outgrow a 12-block paged pool (a swap out and
    in), releases: every tensor the captured step reads keeps its
    address."""
    eng = ServeEngine(tm, slots=2, ctx_len=CTX, prefill_chunk=CHUNK,
                      prefix_cache_mb=8, **kw)
    try:
        before = _addresses(eng)
        assert len(before) > 12
        reqs = [eng.submit(SYS + [9, 11], 4, GREEDY)]
        assert reqs[0].wait(120)
        reqs.append(eng.submit(SYS + [77, 31, 5], 4, SAMPLED))
        assert reqs[1].wait(120)
        reqs += [eng.submit([3, 17, 42, 99, 7], 60, SAMPLED),
                 eng.submit([100, 2, 5, 9, 11, 40], 60, GREEDY)]
        for r in reqs:
            assert r.wait(120) and "error" not in r.result
        assert reqs[1].result["stats"]["prefix_hit_tokens"] == 32
        assert [r.result["stats"]["prefill_chunks"] for r in reqs] == \
            [3, 1, 1, 1]
        if kw:
            assert eng.health()["kv_pool"]["swaps"] >= 1
        assert eng.graph.steps > 60
        assert _addresses(eng) == before
    finally:
        eng.close()


PROMPT = [11, 23, 5, 190, 77, 3, 149, 66, 20]


@pytest.mark.parametrize("max_new,scfg,seed", [
    (21, GREEDY, 0), (40, SAMPLED, 4), (30, NUCLEUS, 9)])
def test_generate_budget_ends_mid_chunk(tm, max_new, scfg, seed):
    """A budget that ends inside a chunk: the loop's tokens, and no cache
    entry written past the last step's position."""
    assert (max_new - 1) % GEN_CHUNK
    got, stats = tm.generate(PROMPT, max_new, scfg, seed=seed)
    assert got == step_by_step(tm, PROMPT, max_new, scfg, seed)
    assert len(got) == max_new and stats["decode_tokens"] == max_new - 1
    n = len(PROMPT)
    kv_len = bucket_for(n + max_new, tm.max_cache_len)
    run = tm._runners[(kv_len, scfg.repeat_last_n)]
    want = torch.full((kv_len,), -1, dtype=torch.int32)
    want[:n + max_new - 1] = torch.arange(n + max_new - 1)
    for lc in run.layers:
        assert torch.equal(lc["pos"][0], want)


def test_generate_stops_at_eos_mid_chunk(tm):
    """An EOS drawn inside the second chunk ends the output there (EOS
    included); the tokens past it that the chunk computed are dropped."""
    free = step_by_step(tm, PROMPT, 60, SAMPLED, seed=2)
    k = next(i for i in range(GEN_CHUNK + 4, 2 * GEN_CHUNK)
             if free[i] not in free[:i])
    cfg = dataclasses.replace(tm.cfg, eos_token_ids=(free[k],))
    eos_model = TextModel(cfg, tm.params, dtype=torch.float32, device="cpu",
                          max_cache_len=CTX)
    got, _ = eos_model.generate(PROMPT, 60, SAMPLED, seed=2)
    assert got == free[:k + 1]
    assert got == step_by_step(eos_model, PROMPT, 60, SAMPLED, seed=2)
    again, _ = eos_model.generate(PROMPT, 60, SAMPLED, seed=2)  # reused
    assert again == got
