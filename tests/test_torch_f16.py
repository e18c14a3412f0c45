"""float16 models in the port (module 16): `--dtype f16` against the JAX
package at f16 on the CPU.

  * parse_dtype takes f16, half and float16 (the reference's aliases);
  * the plain f16 path of TextModel against the live JAX TextModel at
    f16 on the same weights (params_from_numpy), for a dense family
    (qwen3) and a hybrid one (qwen3_5_moe: Gated DeltaNet and gated
    attention layers, routed and shared experts): prefill logits through
    the flash dispatch (the Pallas kernel in interpret mode), a decode
    step's logits, chunked prefill (fresh + append) logits, within
    F16_ATOL = 4e-3 (float16 keeps 11 significant bits: its spacing at
    the logits' magnitude of 2-8 is 2e-3 to 8e-3, and each package rounds
    its own activations to f16 between layers). 16 greedy tokens are
    equal wherever the JAX model's top-2 gap exceeds F16_ATOL; a stream
    that parts must part at a gap below it;
  * each kernel's plain version at f16 against its JAX counterpart: the
    flash kernel's (the Pallas kernel in interpret mode, atol 2e-3), the
    paged decode kernel's (the reference's paged gather plus
    multi_head_attention, atol 1e-3: one f16 spacing at 1), and the FP8
    dequant's, bit for bit;
  * an F16 checkpoint written by the port's writer keeps its bytes when
    loaded at --dtype f16 and is served by `cli run --dtype f16`;
  * both pools of the engine at f16 give generate's greedy tokens.
The kernels' f16 routes are held against these plain versions on the
card in tests/test_torch_f16_card.py."""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.models.common import cache as jcache
from cake_tpu.ops.attention import multi_head_attention as jax_mha
from cake_tpu.ops.flash import flash_attention as jax_flash
from cake_tpu.ops.fp8 import dequant_fp8_blockwise as jax_dequant
from cake_tpu.utils.dtypes import parse_dtype as jax_parse_dtype
from cake_tpu_torch.bench import synth_checkpoint as sc
from cake_tpu_torch.bench.paged_cases import case_args, paged_case
from cake_tpu_torch.device import parse_dtype
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops import flash, fp8, paged_attention
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.engine import ServeEngine
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
F16_ATOL = 4e-3
GREEDY = SamplingConfig(temperature=0.0)
ARCHS = ["qwen3", "qwen3_5_moe"]


@pytest.fixture(autouse=True)
def _collect_reference_engines():
    yield
    gc.collect()


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    """The JAX prefill through its Pallas kernel in interpret mode."""
    import cake_tpu.ops.flash as fl
    orig = fl.flash_attention

    def interpret(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    monkeypatch.setattr(fl, "flash_enabled", lambda: True)
    monkeypatch.setattr(fl, "flash_attention", interpret)


@pytest.mark.parametrize("name", ["f16", "half", "float16", "F16", "bf16",
                                  "f32", "float"])
def test_parse_dtype_takes_the_references_names(name):
    assert str(parse_dtype(name)).split(".")[1] == \
        jnp.dtype(jax_parse_dtype(name)).name


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jm = JaxTextModel(jax_tiny_config(arch, max_position_embeddings=512),
                      dtype=jnp.float16, seed=7)
    cfg = tiny_config(arch, max_position_embeddings=512)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float16),
                   dtype=torch.float16, device="cpu")
    return jm, tm


def _prompt(n, vocab, seed=0):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=F16_ATOL, rtol=0)


def test_prefill_and_decode_logits_match_jax(pair, jax_flash_interpret):
    jm, tm = pair
    ids = _prompt(300, tm.cfg.vocab_size)
    jl, jc = jm.prefill(jm.new_cache(), ids)
    tl, tc = tm.prefill(tm.new_cache(), ids)
    assert jm.last_prefill_mode == tm.last_prefill_mode == "fresh"
    assert tm.params["embed_tokens"]["weight"].dtype == torch.float16
    _close(tl, jl)
    assert torch.isfinite(tl).all()
    tok = int(np.argmax(np.asarray(jl)[0]))
    jd, _ = jm.decode_logits(jc, tok)
    td, _ = tm.decode_logits(tc, tok)
    _close(td, jd)


def test_chunked_prefill_logits_match_jax(pair, jax_flash_interpret):
    """256-token chunks: fresh, then append over the cache row."""
    jm, tm = pair
    ids = _prompt(480, tm.cfg.vocab_size, seed=1)
    jc, tc = jm.new_cache(), tm.new_cache()
    for p0 in range(0, len(ids), 256):
        jl, jc = jm.prefill(jc, ids[p0:p0 + 256], p0)
        tl, tc = tm.prefill(tc, ids[p0:p0 + 256], p0)
        assert jm.last_prefill_mode == tm.last_prefill_mode
    _close(tl, jl)


def test_greedy_tokens_match_jax_where_the_gap_allows(pair,
                                                      jax_flash_interpret):
    jm, tm = pair
    ids = _prompt(300, tm.cfg.vocab_size, seed=2)
    want, _ = jm.generate(ids, max_new_tokens=16, spec=False)
    got, _ = tm.generate(ids, max_new_tokens=16)
    assert len(got) == len(want) == 16
    if got != want:
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        logits, _ = jm.prefill(jm.new_cache(), ids + want[:i])
        top = np.sort(np.asarray(logits, np.float32)[0])[-2:]
        assert top[1] - top[0] < F16_ATOL, (i, got, want)


# -- each kernel's plain version -----------------------------------------------

FLASH_CASES = [("fresh_gqa", 1, 256, 256, 4, 2, 64, {}),
               ("append", 1, 64, 256, 4, 2, 64,
                dict(valid_len=64, q_offset=70)),
               ("window_d128", 1, 256, 256, 2, 1, 128, dict(window=96))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_pallas_interpret_at_f16(case):
    name, b, sq, skv, hq, hkv, d, kw = case
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float16)
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), interpret=True, block_q=64,
                                block_k=64, **kw))
    got = flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw)
    assert got.dtype == torch.float16 and want.dtype == np.float16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=2e-3, rtol=0)


def test_paged_plain_matches_gather_and_attention_at_f16():
    case = paged_case([5, 37, 70], dtype=torch.float16, bt=16, hq=4, hkv=2,
                      d=64, ctx=128, null_rows=1, stale=True, shared=True)
    got = paged_attention.paged_decode_attention(*case_args(case))
    assert got.dtype == torch.float16
    pl = {n: jnp.asarray(case[n].numpy()) for n in ("k", "v", "pos")}
    for r in case["visible_rows"]:
        p = int(case["frontier"][r])
        view = jcache.paged_gather_layer(
            pl, jnp.asarray(case["tables"][r].numpy()), jnp.int32(p + 1))
        mask = (view["pos"] >= 0) & (view["pos"] <= p)
        want = jax_mha(jnp.asarray(case["q"][r:r + 1].numpy()),
                       view["k"][None], view["v"][None],
                       mask[None, None, :])
        np.testing.assert_allclose(got[r:r + 1].float().numpy(),
                                   np.asarray(want, np.float32), atol=1e-3,
                                   rtol=0)


@pytest.mark.parametrize("shape", [(256, 384), (200, 136), (128, 1000)])
def test_fp8_dequant_f16_bit_for_bit_with_jax(shape):
    g = torch.Generator().manual_seed(2)
    w = torch.randn(shape, generator=g) * 3
    q, s = fp8.quant_fp8_blockwise(w)
    got = fp8.dequant_fp8_blockwise(q, s, torch.float16)
    jq = jnp.asarray(q.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
    want = np.asarray(jax_dequant(jq, jnp.asarray(s.numpy()), jnp.float16))
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


# -- checkpoints and serving ---------------------------------------------------

TINY = dict(architectures=["Qwen3ForCausalLM"], vocab_size=256,
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            rms_norm_eps=1e-6, max_position_embeddings=512,
            tie_word_embeddings=True, eos_token_id=2)


def test_f16_checkpoint_keeps_its_bytes_and_runs(tmp_path, capsys):
    from cake_tpu_torch import cli
    from cake_tpu_torch.runtime import build_text_model
    from cake_tpu_torch.utils.safetensors_io import TensorStorage
    d = str(tmp_path / "f16")
    params = sc.model_params(TINY, 9, torch.float16, "cpu")
    sc.write_model(d, TINY, params)
    with TensorStorage.from_model_dir(d) as st:
        assert {st.records[n].dtype for n in st.names()} == {"F16"}
    model, _, _ = build_text_model(d, "f16", device="cpu")
    assert model.dtype == torch.float16
    w = params["layers"][1]["self_attn"]["q_proj"]["weight"]
    got = model.params["layers"][1]["self_attn"]["q_proj"]["weight"]
    assert got.dtype == torch.float16 and torch.equal(
        got.view(torch.int16), w.view(torch.int16))
    assert cli.main(["run", d, "3 17 42 99", "--cpu", "--dtype", "f16",
                     "--raw", "--temperature", "0", "--max-tokens", "4"]) == 0
    out = capsys.readouterr()
    assert "tokens" in out.err


@pytest.mark.parametrize("kv_blocks", [0, 64], ids=["contiguous", "paged"])
def test_engine_pools_at_f16_give_generates_tokens(kv_blocks):
    cfg = tiny_config("qwen3", max_position_embeddings=512)
    model = TextModel(cfg, dtype=torch.float16, device="cpu", seed=4)
    prompts = [_prompt(n, cfg.vocab_size, seed=n) for n in (40, 90)]
    want = [model.generate(p, max_new_tokens=8)[0] for p in prompts]
    eng = ServeEngine(model, slots=2, max_queue=8, ctx_len=256,
                      prefill_chunk=128, kv_blocks=kv_blocks,
                      kv_block_tokens=16, prefix_cache_mb=0)
    try:
        reqs = [eng.submit(p, max_new_tokens=8, sampling=GREEDY)
                for p in prompts]
        for r in reqs:
            eng.wait(r)
        assert [r.result["tokens"] for r in reqs] == want
    finally:
        eng.close()
