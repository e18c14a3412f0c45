"""The port's Gated DeltaNet (models/qwen3_5.py) and the hybrid models
built on it, against the JAX package (cake_tpu/models/qwen3_5.py), in
float32 on the CPU, the inputs drawn from numpy seeds:

  * gdn_forward over a whole sequence: output, conv carry and recurrent
    state within 1e-5 of the JAX function's;
  * a prefill then decode steps equal to one pass over the whole
    sequence; padding past valid_len advances neither the state nor the
    conv carry; the traced form (device meta, a row of a pool) and the
    batched rows give the eager form's bits;
  * the verify's commit (gdn_commit over the pass's held steps) equals
    the reference's re-forward at valid_len = n_acc + 1;
  * checkpoint IO: both conv1d layouts and the three in_proj layouts load
    to the same tree, the HF qkvz / ba split round-trips and equals the
    JAX package's;
  * a tiny qwen3_5_moe hybrid (three linear layers, one gated full layer,
    routed experts with a shared expert) held against the live JAX model
    through the contiguous engine with a prefix hit, the paged engine
    with a prefix hit, a swap and a recompute, and n-gram speculation
    (greedy equal to plain); a linear draft model is refused, as the
    reference refuses it, and so is truncating linear state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.models import qwen3_5 as jq
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models import qwen3_5 as tq
from cake_tpu_torch.models.common.cache import truncate_cache
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import ServeEngine
from cake_tpu_torch.spec.drafter import DraftModelDrafter
from cake_tpu_torch.utils import params_from_numpy
from cake_tpu_torch.utils.loaders import ParamLoader

torch.set_num_threads(1)
TOL = 1e-5          # float32, the two packages' summation orders
ATOL = 1e-3         # logits through a whole model (the golden bar)
GREEDY = SamplingConfig(temperature=0.0)


@pytest.fixture(scope="module")
def layer():
    """(jax cfg, port cfg, jax params, port params) of one linear layer
    with every parameter drawn (A_log and dt_bias too)."""
    jcfg, cfg = jax_tiny_config("qwen3_5"), tiny_config("qwen3_5")
    p = jq.init_gdn_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        if a.ndim else a, p)
    tree["norm"]["weight"] = 1 + 0.2 * rng.standard_normal(
        tree["norm"]["weight"].shape).astype(np.float32)
    tree["in_proj"]["weight"] *= 0.3
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                tree)
    return jcfg, cfg, jp, tp


def _x(b, s, h, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, h)).astype(np.float32)


def _jax_cache(jcfg, b):
    from cake_tpu.models.common.cache import init_layer_cache
    spec = jcfg.layer_spec(0)
    return init_layer_cache(jcfg, spec, b, 16, jnp.float32)


def _port_cache(cfg, b):
    return tq.init_linear_cache(cfg, b, torch.float32, "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def test_gdn_forward_whole_sequence_matches_jax(layer):
    jcfg, cfg, jp, tp = layer
    x = _x(2, 11, cfg.hidden_size, 1)
    jy, jc = jq.gdn_forward(jcfg, jp, jnp.asarray(x), _jax_cache(jcfg, 2),
                            0)
    lc = _port_cache(cfg, 2)
    ty, lc = tq.gdn_forward(cfg, tp, torch.from_numpy(x), lc, 0)
    _close(ty, jy)
    _close(lc["conv"], jc["conv"])
    _close(lc["state"], jc["state"])


def test_prefill_then_decode_equals_one_pass(layer):
    """A 7-token prefill and 4 decode steps (the rows form) give the
    outputs and the state of one 11-token pass, and the JAX package's."""
    jcfg, cfg, jp, tp = layer
    x = torch.from_numpy(_x(1, 11, cfg.hidden_size, 2))
    y_all, one = tq.gdn_forward(cfg, tp, x, _port_cache(cfg, 1), 0)
    lc = _port_cache(cfg, 1)
    ys = [tq.gdn_forward(cfg, tp, x[:, :7], lc, 0)[0]]
    for t in range(7, 11):
        ys.append(tq.gdn_forward(cfg, tp, x[:, t:t + 1], lc,
                                 torch.tensor([t]),
                                 torch.ones(1, dtype=torch.int32))[0])
    _close(torch.cat(ys, 1), y_all)
    _close(lc["state"], one["state"])
    _close(lc["conv"], one["conv"])
    jc = _jax_cache(jcfg, 1)
    _, jc = jq.gdn_forward(jcfg, jp, jnp.asarray(x[:, :7].numpy()), jc, 0)
    for t in range(7, 11):
        _, jc = jq.gdn_forward(jcfg, jp, jnp.asarray(x[:, t:t + 1].numpy()),
                               jc, t)
    _close(lc["state"], jc["state"])


@pytest.mark.parametrize("valid", [0, 1, 5, 9])
def test_padding_advances_nothing(layer, valid):
    """A 9-wide chunk with `valid` real tokens leaves the state and conv
    carry of the valid tokens alone (host int, device 0-d, and the JAX
    package's valid_len)."""
    jcfg, cfg, jp, tp = layer
    x = torch.from_numpy(_x(1, 9, cfg.hidden_size, 3))
    want = _port_cache(cfg, 1)
    if valid:
        tq.gdn_forward(cfg, tp, x[:, :valid], want, 0)
    got = _port_cache(cfg, 1)
    tq.gdn_forward(cfg, tp, x, got, 0, valid)
    for name in ("conv", "state"):      # other GEMM widths: not bit for bit
        _close(got[name], want[name])
    _, jc = jq.gdn_forward(jcfg, jp, jnp.asarray(x.numpy()),
                           _jax_cache(jcfg, 1), 0,
                           jnp.asarray(valid, jnp.int32))
    _close(got["state"], jc["state"])
    _close(got["conv"], jc["conv"])


def test_traced_form_equals_eager_rows(layer):
    """The traced prefill (pool of 3 rows, meta {row 2, pos0, valid_len}
    on the device) writes row 2 with the eager row view's bits and no
    other row; the batched decode rows step row b only where active."""
    jcfg, cfg, jp, tp = layer
    x = torch.from_numpy(_x(1, 8, cfg.hidden_size, 4))
    pool = _port_cache(cfg, 3)
    for name in pool:
        pool[name].normal_(generator=torch.Generator().manual_seed(1))
    before = {n: t.clone() for n, t in pool.items()}
    view = {n: t[2:3].clone() for n, t in pool.items()}
    ye, _ = tq.gdn_forward(cfg, tp, x, view, 0, 6)
    meta = torch.tensor([2, 0, 6], dtype=torch.int32)
    yt, _ = tq.gdn_forward(cfg, tp, x, dict(pool, meta=meta), meta[1],
                           meta[2])
    assert torch.equal(ye, yt)
    for name in pool:
        assert torch.equal(pool[name][2:3], view[name])
        assert torch.equal(pool[name][:2], before[name][:2])
    # decode rows: row 1 inactive keeps its state
    xd = torch.from_numpy(_x(3, 1, cfg.hidden_size, 5))
    rows = {n: t.clone() for n, t in pool.items()}
    tq.gdn_forward(cfg, tp, xd, rows, torch.tensor([6, 3, 6]),
                   torch.tensor([1, 0, 1], dtype=torch.int32))
    for name in rows:
        assert torch.equal(rows[name][1], pool[name][1])
    for b in (0, 2):
        one = {n: t[b:b + 1].clone() for n, t in pool.items()}
        tq.gdn_forward(cfg, tp, xd[b:b + 1], one, torch.tensor([6]),
                       torch.ones(1, dtype=torch.int32))
        for name in rows:
            _close(rows[name][b:b + 1], one[name])


def test_verify_commit_equals_reforward(layer):
    """A verify's pass over [B, k+1] rows (n_input real tokens per row)
    holds each step; committing n_acc + 1 of them installs the state and
    carry of the reference's re-forward at valid_len = commit (and of
    JAX's gdn_forward), an inactive row (commit 0) keeping its own."""
    jcfg, cfg, jp, tp = layer
    b, s = 3, 5
    x = torch.from_numpy(_x(b, s, cfg.hidden_size, 6))
    base = _port_cache(cfg, b)
    tq.gdn_forward(cfg, tp, torch.from_numpy(_x(b, 4, cfg.hidden_size, 7)),
                   base, 0)
    n_input = torch.tensor([5, 3, 0], dtype=torch.int32)
    commit = torch.tensor([2, 3, 0], dtype=torch.int32)
    lc = {n: t.clone() for n, t in base.items()}
    tq.gdn_forward(cfg, tp, x, lc, torch.full((b,), 4), n_input)
    for name in base:                       # the pass writes nothing
        assert torch.equal(lc[name], base[name])
    tq.gdn_commit(lc, lc.pop("held_linear"), commit)
    for r in range(b):
        want = {n: t[r:r + 1].clone() for n, t in base.items()}
        tq.gdn_forward(cfg, tp, x[r:r + 1], want, 4, int(commit[r]))
        jc = {n: jnp.asarray(base[n][r:r + 1].numpy()) for n in base}
        _, jc = jq.gdn_forward(jcfg, jp, jnp.asarray(x[r:r + 1].numpy()), jc,
                               4, jnp.asarray(int(commit[r]), jnp.int32))
        for name in base:
            _close(lc[name][r:r + 1], want[name])
            _close(lc[name][r:r + 1], jc[name])
    for name in base:                       # commit 0: the row's own
        assert torch.equal(lc[name][2], base[name][2])


class _Dict:
    """A name -> tensor store with `in` and read(), as TensorStorage."""

    def __init__(self, d):
        self.d = d

    def __contains__(self, name):
        return name in self.d

    def read(self, name, device, dtype):
        return self.d[name].to(device=device, dtype=dtype)


def test_in_proj_and_conv_layouts_load_alike(layer):
    """Fused in_proj, HF qkvz + ba, split qkv / a / b / z; conv1d as [C,
    1, K] and as [C, K, 1]: one tree, A_log and dt_bias float32 in a
    bfloat16 load, the gated norm as stored."""
    jcfg, cfg, jp, tp = layer
    _, key_dim, value_dim, conv_dim, total = tq._dims(cfg)
    hv = cfg.linear_attn.num_value_heads
    base = "model.layers.0.linear_attn"
    common = {f"{base}.{n}": tp[n] for n in ("dt_bias", "A_log")}
    common.update({f"{base}.norm.weight": tp["norm"]["weight"],
                   f"{base}.out_proj.weight": tp["out_proj"]["weight"]})
    w = tp["in_proj"]["weight"]
    qkvz, ba = tq.hf_qkvz_ba_from_flat(cfg, w)
    layouts = [
        {f"{base}.in_proj.weight": w},
        {f"{base}.in_proj_qkvz.weight": qkvz, f"{base}.in_proj_ba.weight": ba},
        {f"{base}.in_proj_qkv.weight": w[:conv_dim],
         f"{base}.in_proj_a.weight": w[conv_dim:conv_dim + hv],
         f"{base}.in_proj_b.weight": w[conv_dim + hv:conv_dim + 2 * hv],
         f"{base}.in_proj_z.weight": w[conv_dim + 2 * hv:]}]
    conv = tp["conv1d"]["weight"]
    convs = [conv, conv.transpose(1, 2).contiguous()]
    for dtype in (torch.float32, torch.bfloat16):
        got = []
        for lay in layouts:
            for cv in convs:
                st = _Dict({**common, **lay, f"{base}.conv1d.weight": cv})
                got.append(tq.load_gdn_params(
                    ParamLoader(cfg, st, dtype, "cpu"), "model.layers.0"))
        for g in got:
            for name in ("dt_bias", "A_log"):
                assert g[name].dtype == torch.float32
                assert torch.equal(g[name], tp[name])
            assert torch.equal(g["in_proj"]["weight"], w.to(dtype))
            assert torch.equal(g["conv1d"]["weight"], conv.to(dtype))
            assert torch.equal(g["norm"]["weight"],
                               tp["norm"]["weight"].to(dtype))


def test_qkvz_ba_round_trip_matches_jax(layer):
    jcfg, cfg, jp, tp = layer
    cfg2 = tiny_config("qwen3_5", linear_num_value_heads=8)
    jcfg2 = jax_tiny_config("qwen3_5", linear_num_value_heads=8)
    for c, jc in ((cfg, jcfg), (cfg2, jcfg2)):
        total = tq._dims(c)[4]
        w = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (total, c.hidden_size)).astype(np.float32))
        qkvz, ba = tq.hf_qkvz_ba_from_flat(c, w)
        jqkvz, jba = jq.hf_qkvz_ba_from_flat(jc, w.numpy())
        assert np.array_equal(qkvz.numpy(), jqkvz)
        assert np.array_equal(ba.numpy(), jba)
        assert torch.equal(tq.flat_from_hf_qkvz_ba(c, qkvz, ba), w)
        assert np.array_equal(
            tq.flat_from_hf_qkvz_ba(c, qkvz, ba).numpy(),
            jq.flat_from_hf_qkvz_ba(jc, jqkvz, jba))


# -- the hybrid model through the engines --------------------------------------

CTX, CHUNK, BT = 128, 16, 8


def _ids(n: int, seed: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(3, 256, n)]


SHARED = _ids(34, 1)                    # two 16-token prefix units + 2
PROMPTS = [SHARED + _ids(6, 2), SHARED + _ids(9, 3), _ids(41, 4)]
REP = [5, 9, 17, 23] * 4 + [5, 9]


@pytest.fixture(scope="module")
def hybrid():
    over = dict(max_position_embeddings=512)
    cfg = tiny_config("qwen3_5_moe", **over,
                      shared_expert_intermediate_size=48)
    jcfg = jax_tiny_config("qwen3_5_moe", **over,
                           shared_expert_intermediate_size=48)
    jm = JaxTextModel(jcfg, dtype=jnp.float32, seed=5, max_cache_len=CTX)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   dtype=torch.float32, device="cpu", max_cache_len=CTX)
    assert [s.kind for s in cfg.layer_specs()] == ["linear"] * 3 + ["full"]
    assert all(s.is_moe for s in cfg.layer_specs()) and cfg.attn_output_gate
    assert "shared_expert" in tm.params["layers"][0]["mlp"]
    return jm, tm


def _serve(tm, prompts, n, **kw):
    eng = ServeEngine(tm, slots=2, ctx_len=CTX, prefill_chunk=CHUNK, **kw)
    try:
        first = eng.submit(prompts[0], n, GREEDY)
        assert first.wait(300)
        reqs = [first] + [eng.submit(p, n, GREEDY) for p in prompts[1:]]
        for r in reqs:
            assert r.wait(300) and "error" not in r.result, r.result
        return [r.result for r in reqs], eng.health()
    finally:
        eng.close()


def test_hybrid_text_model_matches_jax(hybrid):
    """Prefill logits, the 16 + 16 + 8 chunked prefill and 12 decode
    steps within 1e-3 of the live JAX model; 20 greedy tokens equal."""
    jm, tm = hybrid
    ids = PROMPTS[0]
    jl, jcache = jm.prefill(jm.new_cache(), ids)
    tl, tcache = tm.prefill(tm.new_cache(), ids)
    _close(tl, jl, ATOL)
    chunked = tm.new_cache()
    for p0 in (0, 16, 32):
        cl, chunked = tm.prefill(chunked, ids[p0:p0 + 16], p0)
    _close(cl, jl, ATOL)
    for name in ("conv", "state"):
        _close(chunked["layers"][0][name], jcache["layers"][0][name], TOL)
    assert tm.generate(ids, max_new_tokens=20)[0] == \
        jm.generate(ids, max_new_tokens=20, spec=False)[0]


def test_hybrid_contiguous_engine_prefix_hit(hybrid):
    """The second prompt splices the first's two units (their KV, and the
    final unit's linear state) and prefills only its suffix; every
    request's tokens equal the live JAX model's."""
    jm, tm = hybrid
    want = [jm.generate(p, max_new_tokens=20, spec=False)[0]
            for p in PROMPTS]
    res, _ = _serve(tm, PROMPTS, 20, prefix_cache_mb=8)
    assert [r["tokens"] for r in res] == want
    assert [r["stats"]["prefix_hit_tokens"] for r in res] == [0, 32, 0]


@pytest.mark.parametrize("preempt_mode", ["swap", "recompute"])
def test_hybrid_paged_engine_hit_and_preemption(hybrid, preempt_mode):
    """Full KV in a 14-block pool, the linear state in per-slot rows: a
    prefix hit installs the final unit's row snapshot, two streams
    outgrow the pool and one is preempted (its rows carried by the swap,
    or replayed); tokens equal the live JAX model's."""
    jm, tm = hybrid
    want = [jm.generate(p, max_new_tokens=40, spec=False)[0]
            for p in PROMPTS]
    res, h = _serve(tm, PROMPTS, 40, prefix_cache_mb=8, kv_blocks=14,
                    kv_block_tokens=BT, preempt_mode=preempt_mode)
    assert [r["tokens"] for r in res] == want
    assert res[1]["stats"]["prefix_hit_tokens"] == 32
    pre = h["kv_pool"]["preemptions"]
    assert (h["kv_pool"]["swaps"] >= 1 if preempt_mode == "swap"
            else pre.get("recompute", 0) >= 1), h["kv_pool"]


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_hybrid_ngram_spec_equals_plain(hybrid, mode):
    """Speculation on a hybrid: drafts accepted (the commit installs the
    linear state after the accepted ones) and rejected, greedy tokens
    equal to the plain engine's and the JAX model's."""
    jm, tm = hybrid
    plans = [REP, PROMPTS[2]]
    want = [jm.generate(p, max_new_tokens=30, spec=False)[0] for p in plans]
    kw = dict(prefix_cache_mb=0, spec="ngram", spec_k=4)
    if mode == "paged":
        kw.update(kv_blocks=40, kv_block_tokens=BT)
    res, h = _serve(tm, plans, 30, **kw)
    assert [r["tokens"] for r in res] == want
    assert h["spec"]["accepted"] > 0 and h["spec"]["verify_replays"] > 0


class _Oracle:
    """Proposes the plain stream's next k tokens, shifted by `shift` (0:
    every draft right; else every draft wrong)."""
    name = "oracle"
    shareable = True

    def __init__(self, prompt, stream, shift=0):
        self.prompt, self.stream, self.shift = prompt, stream, shift

    def propose(self, ids, k):
        n = len(ids) - len(self.prompt)
        return [(t + self.shift) % 256 for t in self.stream[n:n + k]]

    def reset(self):
        pass


@pytest.mark.parametrize("shift", [0, 7])
def test_hybrid_generate_spec_equals_plain(hybrid, shift):
    """generate's verify loop with drafts all right (multi-token commits)
    or all wrong (the linear state rolled back to one token each step):
    the plain greedy stream either way."""
    _, tm = hybrid
    plain, _ = tm.generate(REP, max_new_tokens=24, spec=False)
    got, stats = tm.generate(REP, max_new_tokens=24,
                             spec=_Oracle(REP, plain, shift), spec_k=4)
    assert got == plain
    assert stats["spec_accept_rate"] == (1.0 if shift == 0 else 0.0)


def test_linear_draft_model_and_truncate_refused(hybrid):
    _, tm = hybrid
    with pytest.raises(ValueError, match="linear-attention"):
        DraftModelDrafter(tm)
    with pytest.raises(ValueError, match="linear-attention"):
        truncate_cache(tm.cfg, tm.new_cache(), 3)
