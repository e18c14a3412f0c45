"""The port's shared-prefix cache against the JAX package's: the same
blake2b hash chain and n-1 match cap, block extract and splice that leave
the row as prefill did, hit == miss through the engine (bit-identical,
with the reuse recorded), LRU eviction under pressure, the cache off, and
a cancel mid-prefill freeing its slot. Mirrors tests/test_prefix_cache.py
on the same tiny qwen3 weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.serve import PrefixCache as JaxPrefixCache
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import PrefixCache, ServeEngine
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
GREEDY = SamplingConfig(temperature=0.0)
CTX = 128
PROMPT = [3 + (i * 7) % 200 for i in range(50)]


@pytest.fixture(scope="module")
def pair():
    over = dict(max_position_embeddings=512)
    jm = JaxTextModel(jax_tiny_config("llama", **over), dtype=jnp.float32,
                      seed=11, max_cache_len=CTX)
    cfg = tiny_config("llama", **over)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   dtype=torch.float32, device="cpu", max_cache_len=CTX)
    return jm, tm


def _ref(tm, prompt, n):
    return tm.generate(list(prompt), max_new_tokens=n)[0]


def test_chain_keys_and_match_cap_match_jax(pair):
    """Same keys as the reference's chain; reuse capped at n-1 tokens."""
    jm, tm = pair
    jpc = JaxPrefixCache.build(jm, CTX, 16, 64)
    pc = PrefixCache.build(tm, CTX, 16, 64)
    for p in (PROMPT, PROMPT[:33], PROMPT[:32], PROMPT[:16]):
        assert pc.chain_keys(p) == jpc.chain_keys(p)
    layers = tm.new_cache(2, kv_len=64)["layers"]
    for s in range(0, 32, 16):
        _, layers = tm.prefill_chunk(layers, 0, PROMPT[s:s + 16], s)
    keys = pc.chain_keys(PROMPT)
    pc.insert(layers, 0, PROMPT, 0, keys)
    pc.insert(layers, 0, PROMPT, 1, keys)

    def match(p):
        return pc.match(p, pc.chain_keys(p))
    assert [match(PROMPT[:50]), match(PROMPT[:33]), match(PROMPT[:32]),
            match(PROMPT[:16] + [9] * 16), match([9] * 40)] == [2, 2, 1, 1, 0]
    assert PrefixCache.build(tm, CTX, 16, 0) is None
    assert PrefixCache.build(tm, CTX, CTX * 2, 64) is None


def test_spliced_prefix_continues_bitwise(pair):
    """Blocks copied out of one pool and spliced into a wiped row of
    another leave the row exactly as prefill left it, and the suffix
    prefilled on top gives the miss path's logits bit for bit."""
    _, tm = pair
    miss = tm.new_cache(3, kv_len=64)["layers"]
    for s in range(0, len(PROMPT), 16):
        ref_logits, miss = tm.prefill_chunk(miss, 1, PROMPT[s:s + 16], s)
    blocks = [tm.slot_extract(miss, 1, b * 16, 16) for b in range(3)]
    hit = tm.new_cache(3, kv_len=64)["layers"]
    for b, blk in enumerate(blocks):
        hit = tm.slot_splice(hit, blk, 2, b * 16)
    for src, dst in zip(miss, hit):
        for name in ("k", "v", "pos"):
            assert torch.equal(dst[name][2, :48], src[name][1, :48])
        assert int(dst["pos"][2, 48:].max()) == -1
        assert float(dst["k"][[0, 1]].abs().max()) == 0.0     # neighbours
    hit_logits, _ = tm.prefill_chunk(hit, 2, PROMPT[48:], 48)
    assert torch.equal(hit_logits, ref_logits)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_prefix_hit_matches_miss(pair, paged):
    jm, tm = pair
    want = jm.generate(PROMPT, max_new_tokens=10, spec=False)[0]
    assert _ref(tm, PROMPT, 10) == want
    kw = dict(kv_blocks=40, kv_block_tokens=8) if paged else {}
    eng = ServeEngine(tm, slots=2, max_queue=4, ctx_len=CTX,
                      prefill_chunk=16, prefix_cache_mb=64, **kw)
    try:
        out = []
        for p in (PROMPT, PROMPT, PROMPT[:32] + [9, 9, 4, 4, 1]):
            r = eng.submit(p, 10, GREEDY)
            assert r.wait(120)
            out.append((r.result["tokens"], r.result["stats"]))
        assert out[0][0] == out[1][0] == want
        assert out[2][0] == _ref(tm, PROMPT[:32] + [9, 9, 4, 4, 1], 10)
        assert [s["prefix_hit_tokens"] for _, s in out] == [0, 48, 32]
        assert [s["prefill_chunks"] for _, s in out] == [4, 1, 1]
        occ = eng.health()["prefix_cache"]
        assert occ["hits"] == 2 and occ["blocks"] >= 3 and occ["bytes"] > 0
    finally:
        eng.close()


def test_engine_prefix_eviction_under_pressure(pair):
    """A capacity of about two blocks evicts LRU while distinct prefixes
    stream through; outputs stay right before, during and after."""
    _, tm = pair
    eng = ServeEngine(tm, slots=1, max_queue=8, ctx_len=CTX,
                      prefill_chunk=16, prefix_cache_mb=0.04)
    try:
        prompts = [[5 + j] + [(j * 31 + i * 7) % 200 + 3 for i in range(39)]
                   for j in range(3)]
        for p in prompts + prompts[:1]:
            r = eng.submit(p, 6, GREEDY)
            assert r.wait(120)
            assert r.result["tokens"] == _ref(tm, p, 6)
        occ = eng.health()["prefix_cache"]
        assert occ["evictions"] > 0 and occ["bytes"] <= occ["capacity_bytes"]
    finally:
        eng.close()


def test_engine_prefix_cache_disabled_and_cancel_mid_prefill(pair):
    _, tm = pair
    eng = ServeEngine(tm, slots=1, max_queue=2, ctx_len=CTX,
                      prefill_chunk=16, prefix_cache_mb=0)
    try:
        assert eng.prefix_cache is None and "prefix_cache" not in \
            eng.health()
        long_prompt = [3 + (i * 13) % 200 for i in range(120)]
        r = eng.submit(long_prompt, 4, GREEDY)
        while not r.admitted.is_set():
            r.admitted.wait(0.01)
        r.cancel()
        assert r.wait(60)
        r2 = eng.submit(PROMPT, 6, GREEDY)
        assert r2.wait(120)
        assert r2.result["tokens"] == _ref(tm, PROMPT, 6)
        assert eng.health()["slots_busy"] == 0
    finally:
        eng.close()
