"""The port's TextModel against the JAX TextModel on the same weights,
carried across with params_from_numpy: prefill logits through the flash
dispatch (the JAX kernel in interpret mode) within atol 1e-3, the golden
bar of tests/golden/make_golden.py; chunked prefill (fresh + append)
equal to monolithic prefill; 16 greedy tokens identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
GOLDEN_ATOL = 1e-3
ARCHS = ["qwen3", "llama"]


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    """Route the JAX prefill through its Pallas kernel in interpret mode,
    as tests/test_flash.py does."""
    import cake_tpu.ops.flash as fl
    orig = fl.flash_attention

    def interpret(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    monkeypatch.setattr(fl, "flash_enabled", lambda: True)
    monkeypatch.setattr(fl, "flash_attention", interpret)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jm = JaxTextModel(jax_tiny_config(arch, max_position_embeddings=512),
                      dtype=jnp.float32, seed=7)
    cfg = tiny_config(arch, max_position_embeddings=512)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   dtype=torch.float32, device="cpu")
    return jm, tm


def _prompt(n, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 256, n)]


def test_prefill_logits_match_jax(pair, jax_flash_interpret):
    jm, tm = pair
    ids = _prompt(300)
    want, _ = jm.prefill(jm.new_cache(), ids)
    got, _ = tm.prefill(tm.new_cache(), ids)
    assert jm.last_prefill_mode == tm.last_prefill_mode == "fresh"
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=GOLDEN_ATOL, rtol=0)


@pytest.mark.parametrize("n,flash_calls", [(300, {"fresh": 4}),
                                           (480, {"fresh": 4, "append": 4})])
def test_chunked_prefill_equals_monolithic(pair, monkeypatch, n,
                                           flash_calls):
    """256-token chunks: the first takes flash "fresh", a full second one
    flash "append" over the cache row, a short tail (bucket 64 < 256)
    the masked path."""
    from cake_tpu_torch.ops import flash
    _, tm = pair
    ids = _prompt(n, seed=1)
    mono, mono_cache = tm.prefill(tm.new_cache(), ids)
    calls = {}
    orig = flash.flash_attention

    def spy(*a, **k):
        mode = "append" if k.get("q_offset") else "fresh"
        calls[mode] = calls.get(mode, 0) + 1
        return orig(*a, **k)
    monkeypatch.setattr(flash, "flash_attention", spy)
    cache = tm.new_cache()
    for p0 in range(0, n, 256):
        logits, cache = tm.prefill(cache, ids[p0:p0 + 256], p0)
    assert calls == flash_calls
    np.testing.assert_allclose(logits.numpy(), mono.numpy(), atol=1e-4,
                               rtol=0)
    for a, b in zip(cache["layers"], mono_cache["layers"]):
        assert torch.equal(a["pos"], b["pos"])
        torch.testing.assert_close(a["k"], b["k"], atol=1e-5, rtol=0)
        torch.testing.assert_close(a["v"], b["v"], atol=1e-5, rtol=0)


def test_greedy_tokens_match_jax(pair, jax_flash_interpret):
    jm, tm = pair
    ids = _prompt(300, seed=2)
    want, _ = jm.generate(ids, max_new_tokens=16, spec=False)
    got, _ = tm.generate(ids, max_new_tokens=16)
    assert len(got) == 16
    assert got == want


def test_params_from_numpy_takes_bfloat16():
    """ml_dtypes.bfloat16 leaves (a bf16 JAX model) go through float32;
    the rope tables are dropped."""
    cfg = tiny_config("qwen3")
    jm = JaxTextModel(jax_tiny_config("qwen3"), dtype=jnp.bfloat16, seed=3)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    assert tree["embed_tokens"]["weight"].dtype.name == "bfloat16"
    p = params_from_numpy(cfg, tree, "cpu", torch.bfloat16)
    assert "rope" not in p and p["embed_tokens"]["weight"].dtype == \
        torch.bfloat16
    w = tree["layers"][1]["self_attn"]["q_proj"]["weight"]
    np.testing.assert_array_equal(
        p["layers"][1]["self_attn"]["q_proj"]["weight"].float().numpy(),
        w.astype(np.float32))
