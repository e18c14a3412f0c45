"""The port's plain ops against their JAX counterparts: the same numpy
inputs (float32) through cake_tpu.ops and cake_tpu_torch.ops, atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu import ops as jops
from cake_tpu.ops import sampling as jsampling
from cake_tpu_torch import ops as tops
from cake_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_rms_norm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(tops.rms_norm(_t(x), _t(w), 1e-6),
           jops.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("scaling", [None, "llama3"])
@pytest.mark.parametrize("rotary_dim", [32, 16])
def test_rope(rng, scaling, rotary_dim):
    sc_t = sc_j = None
    if scaling:
        kw = dict(factor=8.0, high_freq_factor=4.0, low_freq_factor=1.0,
                  original_max_position_embeddings=64, rope_type="llama3")
        sc_t, sc_j = tops.RopeScaling(**kw), jops.RopeScaling(**kw)
    np.testing.assert_array_equal(
        tops.inv_frequencies(rotary_dim, 5e5, sc_t),
        jops.inv_frequencies(rotary_dim, 5e5, sc_j))
    cos_t, sin_t = tops.rope_tables(128, rotary_dim, 5e5, sc_t)
    cos_j, sin_j = jops.rope_tables(128, rotary_dim, 5e5, sc_j)
    _close(cos_t, cos_j, 0)
    _close(sin_t, sin_j, 0)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 128, (2, 7)).astype(np.int32)
    _close(tops.apply_rope(_t(x), cos_t, sin_t, _t(pos).long(), rotary_dim),
           jops.apply_rope(jnp.asarray(x), cos_j, sin_j, jnp.asarray(pos),
                           rotary_dim))


def test_silu_mul_and_linear(rng):
    g = rng.standard_normal((3, 16)).astype(np.float32)
    u = rng.standard_normal((3, 16)).astype(np.float32)
    _close(tops.silu_mul(_t(g), _t(u)),
           jops.silu_mul(jnp.asarray(g), jnp.asarray(u)))
    w = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    _close(tops.linear(_t(g), _t(w), _t(b)),
           jops.linear(jnp.asarray(g), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("window", [None, 5])
def test_mask_and_multi_head_attention(rng, window):
    b, sq, skv, hq, hkv, d = 2, 6, 12, 4, 2, 16
    q_pos = np.broadcast_to(np.arange(6, 12, dtype=np.int32), (b, sq))
    kv_pos = np.where(rng.random((b, skv)) < 0.2, -1,
                      np.arange(skv)).astype(np.int32)
    mt = tops.make_attention_mask(_t(q_pos.copy()), _t(kv_pos), window)
    mj = jops.make_attention_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                  window)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    _close(tops.multi_head_attention(_t(q), _t(k), _t(v), mt),
           jops.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), mj))


def test_sample_traced_greedy_with_repeat_penalty(rng):
    """temperature 0: the penalized argmax, ties to the lowest id, for
    every row of a batch, equal to the JAX sample_traced row by row."""
    b, v = 4, 64
    logits = rng.standard_normal((b, v)).astype(np.float32)
    logits[1, 10] = logits[1, 20] = logits[1].max() + 1.0   # a tie
    recent = np.full((b, 8), -1, np.int32)
    recent[0, -3:] = np.argsort(-logits[0])[:3]             # penalize top 3
    recent[2, -2:] = np.argsort(logits[2])[:2]              # negatives
    pens = np.array([1.5, 1.0, 2.0, 1.3], np.float32)
    got = tsampling.sample_traced(
        _t(logits), None, torch.zeros(b), torch.full((b,), v,
                                                     dtype=torch.int32),
        torch.ones(b), _t(pens), _t(recent))
    import jax
    key = jax.random.PRNGKey(0)
    want = [int(jsampling.sample_traced(
        jnp.asarray(logits[i]), key, jnp.float32(0.0), jnp.int32(v),
        jnp.float32(1.0), jnp.float32(pens[i]), jnp.asarray(recent[i])))
        for i in range(b)]
    assert got.tolist() == want
    assert want[1] == 10


def test_sample_traced_top_k_one_is_argmax(rng):
    """A sampled row with top_k=1 is a point mass: exact whatever noise."""
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    got = tsampling.sample_traced(
        _t(logits), torch.Generator().manual_seed(0), torch.full((3,), 0.8),
        torch.ones(3, dtype=torch.int32), torch.ones(3), torch.ones(3),
        torch.full((3, 4), -1, dtype=torch.int32))
    assert got.tolist() == np.argmax(logits, axis=1).tolist()


def test_push_recent_token():
    r = np.array([-1, -1, 3, 4], np.int32)
    want = np.asarray(jsampling.push_recent_token(jnp.asarray(r),
                                                  jnp.int32(9)))
    np.testing.assert_array_equal(
        tsampling.push_recent_token(_t(r), torch.tensor(9)).numpy(), want)
    batch = tsampling.push_recent_token(_t(np.stack([r, r])),
                                        torch.tensor([9, 7]))
    assert batch.tolist() == [[-1, 3, 4, 9], [-1, 3, 4, 7]]


def test_causal_sdpa(rng):
    q = rng.standard_normal((1, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 9, 2, 16)).astype(np.float32)
    _close(tops.causal_sdpa(_t(q), _t(k), _t(v)),
           jops.causal_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
