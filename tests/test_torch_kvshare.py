"""The port's fleet-shared KV tier (cake_tpu_torch/fleet/kvshare/) against
the JAX package's (cake_tpu/fleet/kvshare/).

  * codecs: the same header and arrays encode to the same bytes in both
    packages (bfloat16 included: the port writes its raw 2-byte words),
    each package decodes the other's blob, every corruption mode raises
    KVBlobMismatch in both (hypothesis over truncations and flipped
    bytes), the directory codec agrees on round trips and on malformed
    input, and pool_signature is equal for one pool geometry;
  * prefix parity (a 2-layer qwen3 in float32, the JAX weights copied):
    a chain exported by port engine A and installed into port engine B
    splices, and B's greedy tokens equal its own cold run, A's and the
    JAX engine's; the port's exported K/V equals the JAX engine's within
    the golden bar (atol 1e-3); a JAX prefix blob installs into a port
    engine and a port blob into a JAX engine, each continuing to the
    other's greedy tokens; a foreign pool geometry is refused;
  * stream migration: a stream parked mid-decode on A and adopted on B
    equals the unbroken stream token for token, greedy (with and without
    the n-gram drafter) and sampled (the key and counter ride the blob);
    a JAX stream blob is refused at adoption (its carries are not the
    port's) and the plain continuation then gives the JAX stream's
    tokens; a GDN hybrid (qwen3_5, port side only) round-trips its row
    snapshots through both blob kinds.

Torch threads are pinned to 1; the pool geometry is tests/test_kvshare.py's
(12 blocks of 8 tokens, chunk 16, ctx 128)."""
import gc
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cake_tpu.fleet import kvshare as ref
from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.ops.sampling import SamplingConfig as JaxSampling
from cake_tpu.serve import ServeEngine as JaxServeEngine
from cake_tpu_torch.fleet import kvshare
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import ServeEngine
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)

GREEDY = SamplingConfig(temperature=0.0)
CTX, CHUNK, BT, BLOCKS = 128, 16, 8, 12
SYS = [3 + (i * 7) % 200 for i in range(40)]        # 2 full share units
PA, PB = SYS + [9, 11], SYS + [77, 31]
ENGINE_KW = dict(slots=2, max_queue=8, ctx_len=CTX, prefill_chunk=CHUNK,
                 kv_blocks=BLOCKS, kv_block_tokens=BT, prefix_cache_mb=8)


@pytest.fixture(autouse=True)
def _collect_reference_engines():
    """JAX engines built here are collected after each test (their
    admission queues sit in reference cycles)."""
    yield
    gc.collect()


# -- codecs -------------------------------------------------------------------

def _payload(seed: int = 0):
    """(header, numpy arrays, the same as torch tensors)."""
    rng = np.random.default_rng(seed)
    kv = rng.standard_normal((4, 8, 3)).astype(np.float32)
    arrays = {
        "tokens": np.arange(32, dtype=np.int32),
        "layers/0/k": kv,
        "layers/0/v": kv.astype(ml_dtypes.bfloat16),
        "layers/0/pos": np.arange(32, dtype=np.int32).reshape(4, 8),
        "snap/0/0": np.ones((2, 5), np.float64) * 0.25,
        "carries/0": np.array(7, np.int32),
        "carries/3": np.array(2 ** 40 + 3, np.int64),
        "flags": np.array([True, False, True]),
    }
    tensors = {k: (torch.from_numpy(kv).to(torch.bfloat16)
                   if k == "layers/0/v" else torch.from_numpy(np.array(a)))
               for k, a in arrays.items()}
    header = {"kind": "prefix", "units": 2, "flag": True,
              "pool": [None, {"k": [[8, 3], "bfloat16"]}]}
    return header, arrays, tensors


@pytest.mark.parametrize("seed", [0, 1])
def test_blob_bytes_equal_in_both_packages(seed):
    header, arrays, tensors = _payload(seed)
    want = ref.encode_blob(header, arrays)
    assert kvshare.encode_blob(header, tensors) == want
    assert kvshare.encode_blob(header, arrays) == want     # numpy in too
    assert want.startswith(kvshare.MAGIC) \
        and want[len(kvshare.MAGIC)] == kvshare.VERSION == ref.VERSION


def test_each_package_decodes_the_other():
    header, arrays, tensors = _payload()
    h1, got = kvshare.decode_blob(ref.encode_blob(header, arrays))
    h2, back = ref.decode_blob(kvshare.encode_blob(header, tensors))
    assert h1 == h2
    for k, a in arrays.items():
        t = got[k]
        assert kvshare.blob.dtype_name(t.dtype) == str(a.dtype)
        assert tuple(t.shape) == a.shape == back[k].shape
        assert back[k].dtype == a.dtype
        assert back[k].tobytes() == a.tobytes()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert raw.numpy().tobytes() == a.tobytes()


def _outcome(decode, data):
    try:
        h, arrays = decode(data)
    except Exception as e:          # noqa: BLE001 — the type is compared
        return type(e).__name__
    return ("ok", sorted(arrays))


@settings(max_examples=60, deadline=None)
@given(cut=st.integers(0, 400), flip=st.integers(0, 400),
       bit=st.integers(0, 7))
def test_corruption_modes_refused_alike(cut, flip, bit):
    header, arrays, _ = _payload()
    data = ref.encode_blob(header, arrays)
    for bad in (data[:cut % len(data)],
                data[:flip % len(data)]
                + bytes([data[flip % len(data)] ^ (1 << bit)])
                + data[flip % len(data) + 1:]):
        want = _outcome(ref.decode_blob, bad)
        got = _outcome(kvshare.decode_blob, bad)
        assert got == want
        assert want == "KVBlobMismatch"


def test_named_corruptions_refused_alike():
    """tests/test_kvshare.py's modes: truncation, a payload bit flip, the
    magic, version skew; plus a non-bytes input and garbage."""
    header, arrays, _ = _payload()
    data = ref.encode_blob(header, arrays)
    magic = len(ref.MAGIC)
    cases = [data[:40], data[:-1] + bytes([data[-1] ^ 0x40]),
             b"X" + data[1:],
             data[:magic] + bytes([ref.VERSION + 1]) + data[magic + 1:],
             b"garbage", "not bytes"]
    for bad in cases:
        for decode in (ref.decode_blob, kvshare.decode_blob):
            with pytest.raises(Exception) as e:
                decode(bad)
            assert type(e.value).__name__ == "KVBlobMismatch"


@settings(max_examples=40, deadline=None)
@given(peers=st.lists(st.tuples(
    st.sampled_from(["", "http://a:1", "http://b:2"]),
    st.lists(st.text("0123456789abcdef", min_size=1, max_size=8),
             max_size=3)), max_size=4),
       junk=st.text(max_size=30))
def test_directory_codec_agrees(peers, junk):
    want = ref.encode_directory(peers)
    assert kvshare.encode_directory(peers) == want
    if want is not None:
        assert kvshare.parse_directory(want) == ref.parse_directory(want)
    for text in (junk, '{"p": "nope"}', '{"p": [{"u": 3, "k": ["a"]}]}',
                 '{"p": [{"u": "x", "k": ["a", 3]}]}'):
        assert kvshare.parse_directory(text) == ref.parse_directory(text)


# -- engines ------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) of one 2-layer qwen3 in float32."""
    over = dict(max_position_embeddings=512)
    jm = JaxTextModel(jax_tiny_config("qwen3", **over), dtype=jnp.float32,
                      seed=7, max_cache_len=CTX)
    cfg = tiny_config("qwen3", **over)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   dtype=torch.float32, device="cpu", max_cache_len=CTX)
    return jm, tm


def _port(tm, **kw):
    eng = ServeEngine(tm, **{**ENGINE_KW, **kw})
    eng.kv_share = kvshare.KVShareReplica(eng)
    return eng


def _jax(jm):
    eng = JaxServeEngine(jm, **ENGINE_KW)
    eng.kv_share = ref.KVShareReplica(eng)
    return eng


def _greedy(eng, prompt, n, sampling=None):
    r = eng.submit(prompt, max_new_tokens=n, sampling=sampling
                   or (GREEDY if isinstance(eng, ServeEngine)
                       else JaxSampling(temperature=0.0)))
    assert r.wait(300)
    assert "error" not in r.result, r.result.get("error")
    return r


def _chains(eng, n):
    """The agent's inventory once it lists `n` chains."""
    deadline = time.monotonic() + 30
    while len(eng.kv_share.health_view()["chains"]) < n \
            and time.monotonic() < deadline:
        eng._wake.set()
        time.sleep(0.01)
    chains = eng.kv_share.health_view()["chains"]
    assert len(chains) == n, chains
    return chains


def _export(eng):
    chain = _chains(eng, 2)[0]          # newest first: the 2-unit tip
    ks = eng.kv_share
    blob = ks.export_prefix(chain, 60) if isinstance(eng, ServeEngine) \
        else ks.submit_job("export_prefix", chain, 60)
    assert blob is not None
    return blob


def _import(eng, blob):
    ks = eng.kv_share
    return ks.import_prefix(blob, 60) if isinstance(eng, ServeEngine) \
        else ks.submit_job("import_prefix", blob, 60)


def test_prefix_blob_cross_replica_parity(pair):
    jm, tm = pair
    a, b, c = _port(tm), _port(tm), _port(tm)
    jeng = _jax(jm)
    try:
        ra = _greedy(a, PA, 6)
        blob = _export(a)
        header, arrays = kvshare.decode_blob(blob)
        assert header["units"] == 2 and header["has_snap"] is False
        assert a.kv_share.export_prefix("ab" * 16, 30) is None
        assert b.kv_share.import_prefix(blob, 30) == {
            "installed_units": 2, "tokens": 32}
        # a re-import dedupes instead of pinning twice
        assert b.kv_share.import_prefix(blob, 30)[
            "tokens"] == 32
        assert b.prefix_cache.pinned == 2 * b.prefix_cache.bpu
        rb = _greedy(b, PB, 6)
        assert rb.stats["prefix_hit_tokens"] == 32
        cold = _greedy(c, PB, 6)
        assert cold.stats["prefix_hit_tokens"] == 0
        warm = _greedy(a, PB, 6)
        assert warm.stats["prefix_hit_tokens"] == 32
        _greedy(jeng, PA, 6)
        jb = _greedy(jeng, PB, 6)
        assert rb.result["tokens"] == cold.result["tokens"] \
            == warm.result["tokens"] == jb.result["tokens"]
        assert ra.result["tokens"] == _greedy(jeng, PA, 6).result["tokens"]
        # the exported K/V against the JAX engine's export of the same
        # chain: pos equal, K/V within the golden bar
        jh, jarr = ref.decode_blob(_export(jeng))
        assert jh["pool"] == header["pool"] and jh["chain"] == header["chain"]
        for key, want in jarr.items():
            got = arrays[key].numpy()
            if key.endswith("pos") or key == "tokens":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        b.paged.alloc.check()
    finally:
        for e in (a, b, c, jeng):
            e.close()


def test_prefix_blobs_install_across_packages(pair):
    """A JAX replica's prefix blob installs into a port replica and a port
    blob into a JAX one: the pool signatures are equal, and each importer
    continues to the other package's greedy tokens."""
    jm, tm = pair
    ja, jb = _jax(jm), _jax(jm)
    pa_, pb_ = _port(tm), _port(tm)
    try:
        assert kvshare.pool_signature(pa_.paged) \
            == ref.pool_signature(ja.paged)
        _greedy(ja, PA, 6)
        _greedy(pa_, PA, 6)
        assert pb_.kv_share.import_prefix(_export(ja),
                                       30)["tokens"] == 32
        assert _import(jb, _export(pa_))["tokens"] == 32
        got_port = _greedy(pb_, PB, 8)
        got_jax = _greedy(jb, PB, 8)
        assert got_port.stats["prefix_hit_tokens"] == 32
        assert got_jax.stats["prefix_hit_tokens"] == 32
        assert got_port.result["tokens"] == got_jax.result["tokens"] \
            == _greedy(pa_, PB, 8).result["tokens"]
    finally:
        for e in (ja, jb, pa_, pb_):
            e.close()


def test_foreign_pool_geometry_refused(pair):
    _, tm = pair
    a, b = _port(tm), _port(tm, kv_block_tokens=16)
    try:
        _greedy(a, PA, 4)
        blob = _export(a)
        for bad in (blob, b"garbage"):
            with pytest.raises(kvshare.KVBlobMismatch):
                b.kv_share.import_prefix(bad, 30)
        header, arrays = kvshare.decode_blob(blob)
        header["pool"] = {"layers": "somewhere-else"}
        with pytest.raises(kvshare.KVBlobMismatch):
            a.kv_share.import_prefix(
                kvshare.encode_blob(header, arrays), 30)
        assert len(b.prefix_cache._blocks) == 0
        b.paged.alloc.check()
    finally:
        a.close()
        b.close()


def _migrate(src, dst, prompt, n, sampling, after=4):
    """Park src's stream of `prompt` after `after` tokens, ship its blob
    to dst and adopt it there. Returns (the adopted request, its blob)."""
    req = src.submit(prompt, max_new_tokens=n, sampling=sampling)
    req.streaming = True            # a client reads it as it streams
    deadline = time.monotonic() + 60
    while len(req.tokens) < after and time.monotonic() < deadline:
        time.sleep(0.002)
    assert len(req.tokens) >= after and not req.done.is_set()
    blob = src.kv_share.export_stream(req.id, 30)
    assert blob is not None
    assert req.wait(30)
    assert isinstance(req.result.get("error"), kvshare.StreamMigrated)
    # a parked blob re-exports from host memory
    assert src.kv_share.export_stream(req.id, 30) == blob
    staged = dst.kv_share.store_inbound(req.id, blob)
    assert staged["rid"] == req.id and staged["gen_tokens"] >= after
    got = dst.kv_share.submit_job(
        "adopt", {"rid": req.id, "sampling": sampling}, 30)
    assert got is not None
    assert got.wait(120)
    assert "error" not in got.result, got.result.get("error")
    assert got.stats.get("kv_migrated") is True
    # the inbound blob is consumed: a second adoption misses
    assert dst.kv_share.submit_job(
        "adopt", {"rid": req.id, "sampling": sampling}, 30) is None
    dst.paged.alloc.check()
    return got, blob


@pytest.mark.parametrize("spec", [None, "ngram"])
def test_greedy_stream_migration_equals_unbroken(pair, spec):
    _, tm = pair
    a, b, c = (_port(tm, spec=spec) for _ in range(3))
    try:
        prompt, n = [3, 17, 42, 99, 7, 3, 17, 42], 16
        got, _ = _migrate(a, b, prompt, n, GREEDY)
        assert got.result["tokens"] == _greedy(c, prompt, n).result["tokens"]
    finally:
        for e in (a, b, c):
            e.close()


def test_sampled_stream_migration_keeps_its_key(pair):
    """The key and counter carries ride the blob: the migrated stream is
    the unbroken one drawn on the same key (each engine's first
    admission)."""
    _, tm = pair
    a, b, c = _port(tm, seed=11), _port(tm), _port(tm, seed=11)
    sampled = SamplingConfig(temperature=0.8, top_k=50)
    try:
        prompt, n = [5, 9, 14, 80, 2], 14
        got, _ = _migrate(a, b, prompt, n, sampled)
        want = _greedy(c, prompt, n, sampled).result["tokens"]
        assert got.result["tokens"] == want
    finally:
        for e in (a, b, c):
            e.close()


def test_jax_stream_blob_refused_then_continuation(pair):
    """The reference's swap carries are (toks, pos, rngs, recents): its
    stream blob decodes here but is refused at adoption, and the plain
    continuation (prompt + generated, re-prefilled) gives the JAX
    stream's greedy tokens."""
    jm, tm = pair
    ja = _jax(jm)
    b = _port(tm)
    try:
        prompt, n = [3, 17, 42, 99, 7], 12
        want = _greedy(ja, prompt, n).result["tokens"]
        req = ja.submit(prompt, max_new_tokens=n,
                        sampling=JaxSampling(temperature=0.0))
        req.subscribe(lambda item: None)        # a live streamed client
        deadline = time.monotonic() + 120
        while len(req.tokens) < 4 and time.monotonic() < deadline:
            time.sleep(0.002)
        blob = ja.kv_share.export_stream(req.id, 60)
        assert blob is not None
        gen = list(kvshare.decode_blob(blob)[1]["gen_ids"].tolist())
        assert b.kv_share.store_inbound(req.id, blob)["gen_tokens"] \
            == len(gen)
        assert b.kv_share.submit_job(
            "adopt", {"rid": req.id, "sampling": GREEDY}, 30) is None
        rest = _greedy(b, prompt + gen, n - len(gen)).result["tokens"]
        assert gen + rest == want
    finally:
        ja.close()
        b.close()


def test_gdn_hybrid_row_snapshots_round_trip():
    """qwen3_5 keeps per-slot linear rows: they ride a prefix blob as
    per-unit boundary snapshots and a stream blob as its rows, in the
    reference's leaf order, and both kinds give the cold greedy tokens."""
    torch.manual_seed(0)
    cfg = tiny_config("qwen3_5", max_position_embeddings=512)
    tm = TextModel(cfg, dtype=torch.float32, device="cpu",
                   max_cache_len=CTX)
    a, b, c = _port(tm), _port(tm), _port(tm)
    try:
        _greedy(a, PA, 4)
        blob = _export(a)
        header, arrays = kvshare.decode_blob(blob)
        assert header["has_snap"] is True
        assert any(k.startswith("snap/1/") for k in arrays)
        assert b.kv_share.import_prefix(blob, 60)[
            "tokens"] == 32
        rb = _greedy(b, PB, 6)
        assert rb.stats["prefix_hit_tokens"] == 32
        assert rb.result["tokens"] == _greedy(c, PB, 6).result["tokens"]
        prompt, n = [3, 17, 42, 99, 7], 10
        got, sblob = _migrate(a, b, prompt, n, GREEDY)
        assert kvshare.decode_blob(sblob)[0]["has_rows"] is True
        assert got.result["tokens"] == _greedy(c, prompt, n).result[
            "tokens"]
    finally:
        for e in (a, b, c):
            e.close()


def test_prefix_cache_version_matches_reference(pair):
    """The membership version moves on insert and evict, never on an LRU
    touch, in the same sequence as the reference's over the same
    admissions (a cache of two units' room, so the third evicts)."""
    jm, tm = pair
    prompts = [PA, PB, PA, [9] * 20 + [1, 2], [7] * 36, PA]

    def versions(eng, sampling):
        out = []
        for p in prompts:
            r = eng.submit(p, max_new_tokens=2, sampling=sampling)
            assert r.wait(300)
            out.append(eng.prefix_cache.version)
        return out
    small = dict(ENGINE_KW, prefix_cache_mb=0.04)
    eng = ServeEngine(tm, **small)
    jeng = JaxServeEngine(jm, **small)
    try:
        got = versions(eng, GREEDY)
        want = versions(jeng, JaxSampling(temperature=0.0))
    finally:
        eng.close()
        jeng.close()
    assert got == want and got[-1] > got[0] > 0
