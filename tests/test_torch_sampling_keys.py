"""Per-request sampling keys in the port (ops/sampling.py keyed_uniform and
request_key, the serve engine's key and counter carries): the keyed
uniform bits equal a numpy implementation of the same hash and look
uniform over 10^5 draws; a sampled request's tokens do not depend on its
company or on a swap; greedy and top_k = 1 requests equal the JAX
engine's tokens."""
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
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops import sampling as ts
from cake_tpu_torch.serve import ServeEngine
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


CTX, CHUNK, BT = 128, 16, 8
SAMPLED = ts.SamplingConfig(temperature=0.8, top_k=50)


# -- a numpy twin of the hash (uint32 arithmetic wraps by itself) -------------


def _np_fmix32(h):
    h = np.asarray(h, np.uint32)
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(ts.FMIX_C1)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(ts.FMIX_C2)
        return h ^ (h >> np.uint32(16))


def _np_mul(x, c):
    with np.errstate(over="ignore"):
        return np.asarray(x, np.uint32) * np.uint32(c)


def np_request_key(seed: int, seq: int) -> int:
    s = _np_fmix32(np.uint32((seed ^ (seed >> 32)) & ts.MASK32))
    return int(_np_fmix32(s ^ _np_mul(seq & ts.MASK32, ts.GOLDEN)))


def np_keyed_uniform(keys, counters, width):
    keys = np.asarray(keys, np.uint64).astype(np.uint32)
    counters = (np.asarray(counters, np.uint64)
                & np.uint64(ts.MASK32)).astype(np.uint32)
    row = _np_fmix32(keys ^ _np_mul(counters, ts.GOLDEN))
    salt = _np_fmix32(row ^ np.uint32(ts.ROW_SALT))
    col = _np_mul(np.arange(width, dtype=np.uint32), ts.COLUMN_MUL)
    x = _np_fmix32(_np_fmix32(row[:, None] ^ col[None, :]) ^ salt[:, None])
    return (x >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def test_keyed_uniform_equals_numpy_twin():
    keys = [ts.request_key(s, q) for s, q in ((0, 0), (0, 1), (7, 3),
                                              (2 ** 40 + 5, 9))]
    assert keys == [np_request_key(s, q) for s, q in
                    ((0, 0), (0, 1), (7, 3), (2 ** 40 + 5, 9))]
    assert len(set(ts.request_key(3, q) for q in range(1000))) == 1000
    counters = [0, 1, 2 ** 31 + 3, 17]
    got = ts.keyed_uniform(torch.tensor(keys), torch.tensor(counters), 300)
    want = np_keyed_uniform(keys, counters, 300)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_keyed_uniform_is_uniform_and_row_pure():
    """10^5 draws: mean, variance and ten equal bins within a loose band;
    consecutive counters of one key are not correlated; a row's bits do
    not depend on the rows beside it."""
    key = ts.request_key(11, 0)
    u = ts.keyed_uniform(torch.full((4,), key), torch.arange(4),
                         25_000).numpy()
    flat = u.ravel()
    assert flat.size == 100_000
    assert flat.min() >= 0.0 and flat.max() < 1.0
    assert abs(flat.mean() - 0.5) < 0.005
    assert abs(flat.var() - 1 / 12) < 0.002
    hist, _ = np.histogram(flat, bins=10, range=(0.0, 1.0))
    assert np.all(np.abs(hist - 10_000) < 500), hist
    assert abs(np.corrcoef(u[0], u[1])[0, 1]) < 0.03
    alone = ts.keyed_uniform(torch.tensor([key]), torch.tensor([2]), 64)
    np.testing.assert_array_equal(alone.numpy()[0], u[2, :64])


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 4, 1.0),
                                                     (0.5, 6, 0.8)])
def test_sampled_frequencies_follow_the_distribution(temperature, top_k,
                                                     top_p):
    """20000 rows with one set of logits and 20000 keys: each token's
    frequency is its probability under temperature, top-k and top-p
    (renormalized), within 0.015; tokens outside are never drawn."""
    logits = np.array([2.0, 1.0, 0.5, 0.0, -1.0, -3.0], np.float32)
    n, v = 20_000, logits.size
    keys = torch.tensor([ts.request_key(1, i) for i in range(n)])
    got = ts.sample_traced(
        torch.from_numpy(np.tile(logits, (n, 1))), keys,
        torch.zeros(n, dtype=torch.int64), torch.full((n,), temperature),
        torch.full((n,), top_k, dtype=torch.int32), torch.full((n,), top_p),
        torch.ones(n), torch.full((n, 4), -1, dtype=torch.int32)).numpy()
    z = logits / temperature                  # already in descending order
    p = np.exp(z[:top_k] - z.max())
    p /= p.sum()
    keep = (np.cumsum(p) - p) < top_p
    want = np.zeros(v)
    want[:top_k][keep] = p[keep] / p[keep].sum()
    freq = np.bincount(got, minlength=v) / n
    np.testing.assert_allclose(freq, want, atol=0.015)
    assert np.all(freq[want == 0] == 0)


# -- the engine ----------------------------------------------------------------


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


PROMPTS = [[3, 17, 42, 99, 7], [100, 2, 5, 9, 11, 40], [8, 8, 1, 250],
           [61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76,
            77, 78]]


def _serve(tm, jobs, **kw):
    """Submit (prompt, n, sampling) jobs in order; their tokens."""
    kw = {"slots": 3, "ctx_len": CTX, "prefill_chunk": CHUNK, "seed": 5,
          **kw}
    eng = ServeEngine(tm, **kw)
    try:
        reqs = [eng.submit(p, n, s) for p, n, s in jobs]
        for r in reqs:
            assert r.wait(120)
            assert "error" not in r.result, r.result["error"]
        return [r.result["tokens"] for r in reqs], eng.health()
    finally:
        eng.close()


def test_sampled_request_alone_equals_in_company(pair):
    """Temperature 0.8, a fixed engine seed: the first admission's tokens
    are the same alone and while two later admissions decode beside it
    (each admission draws from its own key and counter)."""
    _, tm = pair
    alone, _ = _serve(tm, [(PROMPTS[0], 24, SAMPLED)])
    company, _ = _serve(tm, [(PROMPTS[0], 24, SAMPLED),
                             (PROMPTS[1], 24, SAMPLED),
                             (PROMPTS[3], 24, SAMPLED)])
    assert company[0] == alone[0]
    assert len(set(map(tuple, company))) == 3
    other_seed, _ = _serve(tm, [(PROMPTS[0], 24, SAMPLED)], seed=6)
    assert other_seed[0] != alone[0]


def test_sampled_swap_resumes_its_own_stream(pair):
    """Two sampled streams outgrow a 12-block paged pool: the later one is
    swapped out and back in, and both equal the same requests on a pool
    that never swaps."""
    _, tm = pair
    jobs = [(PROMPTS[0], 60, SAMPLED), (PROMPTS[1], 60, SAMPLED)]
    paged = dict(slots=2, kv_blocks=48, kv_block_tokens=BT,
                 prefix_cache_mb=0)
    want, roomy = _serve(tm, jobs, **paged)
    got, tight = _serve(tm, jobs, **{**paged, "kv_blocks": 12})
    assert roomy["kv_pool"]["swaps"] == 0
    assert tight["kv_pool"]["swaps"] >= 1
    assert got == want


def test_greedy_and_top_k_one_equal_jax_engine(pair):
    jm, tm = pair
    modes = [(0.0, None), (0.8, 1), (0.0, None)]
    kw = dict(slots=3, max_queue=8, ctx_len=CTX, prefill_chunk=CHUNK,
              prefix_cache_mb=0)
    jeng = JaxServeEngine(jm, **kw)
    try:
        jreqs = [jeng.submit(p, 10, JaxSampling(temperature=t, top_k=k))
                 for p, (t, k) in zip(PROMPTS, modes)]
        for r in jreqs:
            assert r.wait(300)
        want = [r.result["tokens"] for r in jreqs]
    finally:
        jeng.close()
    got, _ = _serve(tm, [(p, 10, ts.SamplingConfig(temperature=t, top_k=k))
                         for p, (t, k) in zip(PROMPTS, modes)], **kw)
    assert got == want
