"""Golden parity of the port for every family it adapts (config.py:
llama, qwen2, qwen3, mistral, falcon3): the JAX package's weights for the
committed fixtures (tests/golden/make_golden.py: seeded under
fixture_prng) carried across with params_from_numpy, then prefill logits,
5 greedy decode steps' logits and the 5 + 4 chunked prefill within atol
1e-3 of tests/golden/<family>.npz, and 16 greedy tokens identical.

A mistral whose sliding window (24) is shorter than prompt plus decode is
held against the live JAX model: through TextModel (the ring cache wraps
in prefill, in chunked prefill and in decode), through the contiguous
engine (prefix hit: blocks spliced into the ring), and, with layers
alternating full and windowed (the paged pool needs a full layer; the
reference refuses an all-window model there too), through the paged
engine with a prefix hit (the final unit's row snapshot installed) and a
swap (row_snapshot / row_install)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common.graphs import DecodeCarries
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import ServeEngine
from cake_tpu_torch.utils import params_from_numpy
from golden.make_golden import PROMPT, SEED, fixture_prng

torch.set_num_threads(1)
HERE = os.path.join(os.path.dirname(__file__), "golden")
ATOL = 1e-3
PORTED = ("llama", "qwen2", "qwen3", "mistral", "falcon3")
GREEDY = SamplingConfig(temperature=0.0)


def _carry(jm, cfg, max_cache_len: int) -> TextModel:
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    return TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                     dtype=torch.float32, device="cpu",
                     max_cache_len=max_cache_len)


def _decode_logits(tm, cache, tok: int, pos: int, steps: int):
    """`steps` greedy batch-1 decode steps from token `tok` at `pos`;
    each step's logits [V]."""
    c = DecodeCarries.build(1, tm.cfg.vocab_size, 64, "cpu")
    c.toks.fill_(tok)
    c.pos.fill_(pos)
    c.active.fill_(True)
    out = []
    for _ in range(steps):
        tm.decode_slots_into(cache["layers"], c)
        out.append(c.logits[0].clone().numpy())
    return np.stack(out)


@pytest.mark.parametrize("fam", PORTED)
def test_port_matches_golden(fam):
    with fixture_prng():
        jm = JaxTextModel(jax_tiny_config(fam, eos_token_id=255),
                          dtype=jnp.float32, seed=SEED, max_cache_len=64)
    tm = _carry(jm, tiny_config(fam, eos_token_id=255), 64)
    want = np.load(os.path.join(HERE, f"{fam}.npz"))
    logits, cache = tm.prefill(tm.new_cache(), PROMPT)
    np.testing.assert_allclose(logits[0].numpy(), want["prefill_logits"],
                               atol=ATOL, rtol=0)
    tid = int(np.argmax(want["prefill_logits"]))
    np.testing.assert_allclose(
        _decode_logits(tm, cache, tid, len(PROMPT), 5),
        want["decode_logits"], atol=ATOL, rtol=0)
    _, cache2 = tm.prefill(tm.new_cache(), PROMPT[:5])
    chunked, _ = tm.prefill(cache2, PROMPT[5:], pos0=5)
    np.testing.assert_allclose(chunked[0].numpy(),
                               want["chunked_prefill_logits"], atol=ATOL,
                               rtol=0)
    toks, _ = tm.generate(PROMPT, max_new_tokens=16)
    assert toks == want["greedy_tokens"].tolist()


# -- a sliding window shorter than prompt plus decode -------------------------

WINDOW, CTX, CHUNK, BT = 24, 128, 16, 8
MIXED = (True, False, True, False)      # full, windowed, full, windowed


def _windowed(global_layers=()):
    over = dict(sliding_window=WINDOW, max_position_embeddings=512)
    jcfg = dataclasses.replace(jax_tiny_config("mistral", **over),
                               global_layers=global_layers)
    jm = JaxTextModel(jcfg, dtype=jnp.float32, seed=11, max_cache_len=CTX)
    cfg = dataclasses.replace(tiny_config("mistral", **over),
                              global_layers=global_layers)
    return jm, _carry(jm, cfg, CTX)


@pytest.fixture(scope="module")
def windowed():
    return _windowed()


def _ids(n: int, seed: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(3, 256, n)]


SHARED = _ids(34, 1)                    # two 16-token prefix units + 2
PROMPTS = [SHARED + _ids(6, 2), SHARED + _ids(9, 3), _ids(41, 4)]


def test_windowed_mistral_text_model(windowed):
    """Prompt 40 > window 24: prefill logits, the 16 + 16 + 8 chunked
    prefill, 12 decode steps' logits (the ring wraps) within 1e-3 of the
    live JAX model, and 20 greedy tokens identical."""
    jm, tm = windowed
    assert all(s.window == WINDOW for s in tm.cfg.layer_specs())
    ids = PROMPTS[0]
    jl, jcache = jm.prefill(jm.new_cache(), ids)
    tl, tcache = tm.prefill(tm.new_cache(), ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    chunked = tm.new_cache()
    for p0 in (0, 16, 32):
        cl, chunked = tm.prefill(chunked, ids[p0:p0 + 16], p0)
    np.testing.assert_allclose(cl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    tid = int(np.argmax(np.asarray(jl)[0]))
    want = []
    jt = tid
    for _ in range(12):
        lg, jcache = jm.decode_logits(jcache, jt)
        want.append(np.asarray(lg[0]))
        jt = int(np.argmax(want[-1]))
    np.testing.assert_allclose(_decode_logits(tm, tcache, tid, len(ids), 12),
                               np.stack(want), atol=ATOL, rtol=0)
    jtoks, _ = jm.generate(ids, max_new_tokens=20, spec=False)
    ttoks, _ = tm.generate(ids, max_new_tokens=20)
    assert ttoks == jtoks


def _serve(tm, prompts, n, **kw):
    eng = ServeEngine(tm, slots=2, ctx_len=CTX, prefill_chunk=CHUNK, **kw)
    try:
        first = eng.submit(prompts[0], n, GREEDY)
        assert first.wait(120)
        reqs = [first] + [eng.submit(p, n, GREEDY) for p in prompts[1:]]
        for r in reqs:
            assert r.wait(120) and "error" not in r.result, r.result
        return reqs, eng.health()
    finally:
        eng.close()


def test_windowed_mistral_contiguous_engine(windowed):
    """The window gate admits a prefix cache (24 >= the 16-token block):
    the second prompt splices the first's two units into its ring, and
    every request's greedy tokens equal the live JAX model's."""
    jm, tm = windowed
    want = [jm.generate(p, max_new_tokens=20, spec=False)[0]
            for p in PROMPTS]
    reqs, _ = _serve(tm, PROMPTS, 20, prefix_cache_mb=8)
    assert [r.result["tokens"] for r in reqs] == want
    assert [r.result["stats"]["prefix_hit_tokens"] for r in reqs] == \
        [0, 32, 0]


def test_windowed_mistral_paged_engine():
    """Layers alternate full and windowed: full KV in a 14-block pool,
    windowed rings in the per-slot rows. A prefix hit installs the final
    unit's row snapshot; two streams outgrow the pool, so one is swapped
    out with its rows and back in; tokens equal the live JAX model's."""
    jm, tm = _windowed(MIXED)
    assert [s.window for s in tm.cfg.layer_specs()] == [None, WINDOW,
                                                        None, WINDOW]
    want = [jm.generate(p, max_new_tokens=40, spec=False)[0]
            for p in PROMPTS]
    reqs, h = _serve(tm, PROMPTS, 40, prefix_cache_mb=8, kv_blocks=14,
                     kv_block_tokens=BT)
    assert [r.result["tokens"] for r in reqs] == want
    assert reqs[1].result["stats"]["prefix_hit_tokens"] == 32
    assert h["kv_pool"]["swaps"] >= 1
