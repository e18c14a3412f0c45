"""Recompute preemption in the port's paged engine (the reference's
preempt_mode="recompute": `_preempt_slot`, `_resume_preempted` and
`_replay_slot`, cake_tpu/serve/engine.py:1369-1482, 1580-1640): a victim's
blocks are released, and at resume its prompt and emitted tokens but the
last are replayed through the prefill programs.

Held here, on a tiny llama carried from the JAX package (ctx 128, chunks
of 16, blocks of 8, the reference test's pool of 12 blocks): two greedy
streams that outgrow the pool give the sequential outputs and the JAX
engine's recompute outputs; a mid-prefill admission is requeued and
restarts cleanly; a replay splices a cached prefix; a victim whose first
token was never fetched restarts from its prompt; a sampled victim keeps
the tokens it had and completes on a fresh key."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.ops.sampling import SamplingConfig as JaxSampling
from cake_tpu.serve import ServeEngine as JaxServeEngine
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common.graphs import DecodeGraph
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import ServeEngine
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
GREEDY = SamplingConfig(temperature=0.0)
SAMPLED = SamplingConfig(temperature=0.9, top_k=40)
CTX, CHUNK, BT, BLOCKS = 128, 16, 8, 12
P_A = [3, 17, 42, 99, 7]                    # the reference test's prompts
P_B = [100, 2, 5, 9, 11, 40]
SYS = [3 + (i * 7) % 200 for i in range(40)]   # 2 full prefix units


@pytest.fixture(scope="module")
def pair():
    jm = JaxTextModel(jax_tiny_config("llama"), dtype=jnp.float32,
                      max_cache_len=CTX)
    cfg = tiny_config("llama")
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   dtype=torch.float32, device="cpu", max_cache_len=CTX)
    return jm, tm


def _kw(**over):
    kw = dict(slots=2, max_queue=8, ctx_len=CTX, prefill_chunk=CHUNK,
              kv_blocks=BLOCKS, kv_block_tokens=BT, prefix_cache_mb=0,
              preempt_mode="recompute")
    kw.update(over)
    return kw


def _submit_all(eng, jobs):
    reqs = [eng.submit(p, n, s) for p, n, s in jobs]
    for r in reqs:
        assert r.wait(300)
        assert "error" not in r.result, r.result["error"]
    return reqs


def _pool_end(eng) -> dict:
    h = eng.health()["kv_pool"]
    assert h["preempted_slots"] == 0            # everyone resumed
    eng.paged.alloc.check()
    return h


def test_two_greedy_streams_equal_sequential_and_jax(pair):
    """The reference's case (tests/test_paged.py:276): P_A and P_B, 60
    tokens each, outgrow a 96-token pool. Under recompute both equal the
    sequential generate and the JAX engine under recompute, with at least
    one recompute preemption replayed."""
    jm, tm = pair
    want = [tm.generate(p, max_new_tokens=60)[0] for p in (P_A, P_B)]
    jeng = JaxServeEngine(jm, **_kw())
    try:
        jreqs = [jeng.submit(p, 60, JaxSampling(temperature=0.0))
                 for p in (P_A, P_B)]
        for r in jreqs:
            assert r.wait(600) and "error" not in r.result
        jax_got = [r.result["tokens"] for r in jreqs]
    finally:
        jeng.close()
    eng = ServeEngine(tm, **_kw())
    try:
        reqs = _submit_all(eng, [(P_A, 60, GREEDY), (P_B, 60, GREEDY)])
        h = _pool_end(eng)
    finally:
        eng.close()
    got = [r.result["tokens"] for r in reqs]
    assert got == want
    assert got == jax_got
    assert h["preemptions"]["recompute"] >= 1 and h["replays"] >= 1
    assert h["swaps"] == 0


def test_mid_prefill_requeue_restarts_cleanly(pair):
    """Two 88-token prompts (11 blocks each) prefill side by side in 12
    blocks: one is requeued mid-prefill (labelled recompute, as the
    reference labels it), restarts its prefill when the other is done, and
    both equal the sequential outputs; nothing was emitted, so nothing is
    replayed."""
    _, tm = pair
    prompts = [[3 + (i * 5 + k) % 250 for i in range(88)] for k in (0, 1)]
    want = [tm.generate(p, max_new_tokens=6)[0] for p in prompts]
    eng = ServeEngine(tm, **_kw())
    try:
        reqs = _submit_all(eng, [(p, 6, GREEDY) for p in prompts])
        h = _pool_end(eng)
    finally:
        eng.close()
    assert [r.result["tokens"] for r in reqs] == want
    assert h["preemptions"]["recompute"] >= 1 and h["replays"] == 0
    assert sum("preempted_at" in r.stats for r in reqs) == 0
    assert max(r.stats["prefill_chunks"] for r in reqs) == 6


class _Manual(ServeEngine):
    """An engine whose scheduler the test drives: its thread captures
    nothing (the CPU) and idles until close; `run()` steps."""

    def _loop(self):
        self.graph = DecodeGraph(self._decode_fn(), self.model.device)
        self._ready.set()
        self._stop.wait()

    def run(self, reqs, limit=5000):
        for _ in range(limit):
            if all(r.done.is_set() for r in reqs):
                return
            self._step()
        raise AssertionError("requests did not finish")


def test_replay_splices_a_cached_prefix(pair):
    """Two streams over a shared 40-token system prompt with the prefix
    cache on (a pool with room, driven step by step): the later one,
    preempted by recompute after 5 tokens, replays prompt + tokens[:-1]
    with the cached units (32 tokens) spliced in, and both equal the
    sequential outputs."""
    _, tm = pair
    prompts = [SYS + [9, 11], SYS + [77, 31]]
    want = [tm.generate(p, max_new_tokens=30)[0] for p in prompts]
    eng = _Manual(tm, **_kw(kv_blocks=40, prefix_cache_mb=8))
    try:
        ra, rb = (eng.submit(p, 30, GREEDY) for p in prompts)
        while len(rb.tokens) < 5:
            eng._step()
        assert eng.prefix_cache.occupancy()["blocks"] >= 2
        eng._preempt_slot(rb.slot, rb)
        eng.run([ra, rb])
        h = _pool_end(eng)
    finally:
        eng.close()
    assert [ra.result["tokens"], rb.result["tokens"]] == want
    assert h["replays"] == 1
    assert rb.stats["preempted_at"] == [5]
    assert rb.stats["replay_hit_tokens"] == 32


def test_preempted_before_the_first_token_restarts(pair):
    """A victim whose first token was sampled but never fetched (the
    iteration that completed its prefill has not fanned it out): its
    first token is dropped, it restarts from its prompt under the same
    key, and it gives the sequential output, greedy and sampled."""
    _, tm = pair
    for label, scfg in (("greedy", GREEDY), ("sampled", SAMPLED)):
        eng = _Manual(tm, **_kw(kv_blocks=40, seed=5))
        try:
            ra = eng.submit(P_A, 20, GREEDY)
            rb = eng.submit(P_B, 20, scfg)
            while not rb._first_pending:
                eng._step()
            assert not rb.tokens and rb.slot is not None
            eng._preempt_slot(rb.slot, rb)
            assert not rb._first_pending
            eng.run([ra, rb])
            h = _pool_end(eng)
        finally:
            eng.close()
        assert h["preemptions"]["recompute"] == 1 and h["replays"] == 0
        assert rb.stats["preempted_at"] == [0]
        assert ra.result["tokens"] == tm.generate(P_A, 20)[0]
        if label == "greedy":
            assert rb.result["tokens"] == tm.generate(P_B, 20)[0]
        else:
            ref = _Manual(tm, **_kw(kv_blocks=40, seed=5))
            try:
                r0 = ref.submit(P_A, 20, GREEDY)
                r1 = ref.submit(P_B, 20, scfg)
                ref.run([r0, r1])
            finally:
                ref.close()
            # the same key (admission 1) draws the same first token
            assert rb.result["tokens"] == r1.result["tokens"]


def test_sampled_victim_keeps_its_tokens(pair):
    """A sampled stream preempted by recompute (the greedy one's frontier
    runs one token ahead, so the greedy one asks for a block first and
    the latest admission, the sampled one, is the victim) completes its
    budget; the tokens it had before the preemption equal the same
    stream's unpreempted run (same seed, same admission order), and it
    goes on under a fresh key."""
    _, tm = pair
    jobs = [(P_B, 60, GREEDY), (P_A, 60, SAMPLED)]
    big = ServeEngine(tm, **_kw(kv_blocks=64, seed=3))
    try:
        free = _submit_all(big, jobs)
        assert big.health()["kv_pool"]["preemptions"]["recompute"] == 0
    finally:
        big.close()
    eng = ServeEngine(tm, **_kw(seed=3))
    try:
        reqs = _submit_all(eng, jobs)
        h = _pool_end(eng)
    finally:
        eng.close()
    assert h["replays"] >= 1
    victim = reqs[1]
    k = victim.stats["preempted_at"][0]
    assert k >= 1
    assert victim.result["tokens"][:k] == free[1].result["tokens"][:k]
    assert len(victim.result["tokens"]) == len(free[1].result["tokens"])
    assert reqs[0].result["tokens"] == tm.generate(P_B, 60)[0]
