"""Expert offload in the port (module 10b: utils/safetensors_io.py
read, models/common/expert_provider.py, the loader's `_provider`
leaf, models/common/offload_model.py, runtime.build_text_model's
expert_offload) against the JAX package on the same seeded checkpoints,
written by the JAX exporter (`save_safetensors`, as
tests/test_expert_provider.py writes them) or by the port's seeded
writers in the published FP8, AutoGPTQ and GGUF layouts:

  * `TensorStorage.read` gives the JAX `read_many`'s bits, across
    shards, adjacent or not;
  * `DiskExpertProvider.get(e)` gives the JAX provider's arrays bit for
    bit for an unquantized checkpoint (float32 and bfloat16), FP8
    dequantized at load, GPTQ 4-bit (with and without act-order) and a
    GGUF file's banks (one expert's slice read alone);
  * `moe_ffn_offloaded`, for decode rows and for a prefill chunk, equals
    the JAX `moe_ffn_offloaded` and the port's resident `moe_ffn` at f32
    atol 1e-5, and over a resident provider the gathered route bit for
    bit;
  * the LRU evicts the least recently used expert, counts hits, misses,
    reads and bytes, and a prefetch warms it on a background thread;
  * `OffloadedTextModel` on tiny_config("qwen3_moe") and on
    tiny_config("qwen3_5_moe") with a shared expert (linear and full
    layers, routed and shared experts), its LRU smaller than a layer's
    experts: greedy tokens identical to the JAX OffloadedTextModel's and
    to the port's resident TextModel's, prefill logits within 1e-3 of
    the JAX model's in f32; the GGUF-only and FP8 branches of
    build_text_model the same against the JAX loader's offloaded model;
  * the runtime's two refusals (a model with no experts; --fp8-native
    with offload), in the reference's words;
  * the eager-only guard: inside a CUDA-graph capture (mocked on the
    CPU) a provider's read and the offloaded routing raise."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny
from cake_tpu.models.common import expert_provider as jep
from cake_tpu.models.common.layers import init_params as jax_init
from cake_tpu.models.common.offload_model import \
    OffloadedTextModel as JaxOffloaded
from cake_tpu.ops.sampling import SamplingConfig as JaxSampling
from cake_tpu.utils import quant as jquant
from cake_tpu.utils.export import params_to_hf_tensors as jax_export
from cake_tpu.utils.gguf import GgufStorage as JaxGguf
from cake_tpu.utils.loaders import ParamLoader as JaxLoader
from cake_tpu.utils.loaders import load_model_params as jax_load
from cake_tpu.utils.safetensors_io import TensorStorage as JaxStorage
from cake_tpu.utils.safetensors_io import save_safetensors as jax_save
from cake_tpu_torch.bench import synth_checkpoint as sc
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common import expert_provider as ep
from cake_tpu_torch.models.common.offload_model import OffloadedTextModel
from cake_tpu_torch.ops.moe import moe_ffn
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.runtime import build_text_model
from cake_tpu_torch.utils import params_from_numpy
from cake_tpu_torch.utils import quant
from cake_tpu_torch.utils.gguf import GgufStorage
from cake_tpu_torch.utils.loaders import load_model_params
from cake_tpu_torch.utils.safetensors_io import (TensorStorage,
                                                 save_safetensors)

torch.set_num_threads(1)
ATOL = 1e-3
GREEDY = SamplingConfig(temperature=0.0)
PROMPT = [3, 17, 42, 99, 7, 11, 5, 8, 60, 3, 200, 13]
# the tiny MoE of tests/test_torch_quant.py: widths not multiples of 128
# (FP8's edge blocks cropped), in-features multiples of 64 for GPTQ
TINY_MOE = dict(architectures=["Qwen3MoeForCausalLM"], vocab_size=256,
                hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                rms_norm_eps=1e-6, max_position_embeddings=256,
                tie_word_embeddings=False, eos_token_id=2, num_experts=4,
                num_experts_per_tok=2, moe_intermediate_size=64)


def _jax_checkpoint(d, jcfg, seed: int):
    """The JAX init_params of jcfg exported and saved as d/model.safetensors
    (with an empty config.json); returns the JAX parameter tree."""
    params = jax_init(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    os.makedirs(d, exist_ok=True)
    jax_save(os.path.join(d, "model.safetensors"), jax_export(jcfg, params))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({}, f)
    return params


def _bits(t) -> np.ndarray:
    a = np.asarray(t.float() if torch.is_tensor(t) else
                   jnp.asarray(t, jnp.float32))
    return a.view(np.int32)


# -- the storage read the provider takes --------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
def test_read_equals_jax_read_many(tmp_path, dtype):
    """Two shards; in each, a run of adjacent tensors and one apart: the
    port's `read` (the map, which the provider reads an unquantized
    expert through) gives the bits of the reference's batched
    `read_many`, in any order asked, and cast to float32 the same
    values."""
    gen = torch.Generator().manual_seed(1)
    for shard in range(2):
        ts = {f"s{shard}.t{i}": torch.randn(3 + i, 5, generator=gen)
              .to(dtype) for i in range(4)}
        save_safetensors(str(tmp_path / f"m{shard}.safetensors"), ts)
    ask = ["s1.t2", "s0.t0", "s0.t1", "s0.t3", "s1.t0", "s1.t1"]
    want = JaxStorage.from_model_dir(str(tmp_path)).read_many(ask)
    with TensorStorage.from_model_dir(str(tmp_path)) as st:
        for n, w in zip(ask, want):
            t = st.read(n)
            assert tuple(t.shape) == w.shape
            assert np.array_equal(t.view(torch.uint8).numpy(),
                                  np.ascontiguousarray(w).view(np.uint8))
            if dtype != torch.float8_e4m3fn:
                np.testing.assert_array_equal(
                    st.read(n, "cpu", torch.float32).numpy(),
                    np.asarray(w, np.float32))


# -- the provider against the JAX provider ---------------------------------------


def _quant_checkpoint(kind: str, d: str) -> dict:
    config = dict(TINY_MOE)
    params = sc.model_params(config, 4, torch.float32, randomize_norms=True)
    if kind in ("none", "none_bf16"):
        sc.write_model(d, config, params)
    elif kind == "fp8":
        sc.write_fp8_model(d, config, params)
    else:
        sc.write_gptq_model(d, config, params, seed=6, group_size=64,
                            desc_act=kind == "gptq_act")
    return config


@pytest.mark.parametrize("kind", ["none", "none_bf16", "fp8", "gptq",
                                  "gptq_act", "gguf"])
def test_provider_experts_equal_jax_provider(tmp_path, kind):
    d = str(tmp_path / "ckpt")
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if kind == "none_bf16"
                else (torch.float32, jnp.float32))
    if kind == "gguf":
        sc.write_gguf_model(d, dict(TINY_MOE), seed=3)
        path = os.path.join(d, "model.gguf")
        st, jst = GgufStorage(path), JaxGguf(path)
        q, jq = quant.NoQuantization(), jquant.NoQuantization()
    else:
        _quant_checkpoint(kind, d)
        raw = json.load(open(os.path.join(d, "config.json")))
        st, jst = TensorStorage.from_model_dir(d), JaxStorage.from_model_dir(d)
        q, jq = quant.detect_quantization(raw), jquant.detect_quantization(raw)
        assert q.name == jq.name
    for layer in range(TINY_MOE["num_hidden_layers"]):
        lp = f"model.layers.{layer}.mlp"
        prov = ep.DiskExpertProvider(st, lp, 4, quant=q, dtype=tdt,
                                     lru_size=2,
                                     name_fmt="{lp}.experts.{e}.{proj}.weight")
        jprov = jep.DiskExpertProvider(
            jst, lp, 4, quant=jq, dtype=jdt, lru_size=2,
            name_fmt="{lp}.experts.{e}.{proj}.weight")
        for e in (3, 0, 2, 1, 3):
            got, want = prov.get(e), jprov.get(e)
            for p in ep.PROJS:
                assert got[p].dtype == tdt
                np.testing.assert_array_equal(_bits(got[p]),
                                              _bits(want[p]),
                                              err_msg=f"{lp} {e} {p}")
        assert prov.reads == 5 and prov.misses == 5 and prov.hits == 0
        assert prov.bytes_read == sum(
            st.nbytes(s) for e in (3, 0, 2, 1, 3) for n in prov.names(e)
            for s in q.sources(st, n))


# -- moe_ffn_offloaded -----------------------------------------------------------


@pytest.fixture(scope="module")
def moe_layer(tmp_path_factory):
    """A tiny qwen3_moe's first MoE layer: the JAX and port trees, a
    checkpoint of it, 6 tokens of input."""
    d = str(tmp_path_factory.mktemp("moe"))
    jcfg = jax_tiny("qwen3_moe")
    params = _jax_checkpoint(d, jcfg, seed=2)
    cfg = tiny_config("qwen3_moe")
    tree = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                             "cpu", torch.float32)
    x = np.random.default_rng(0).standard_normal((6, cfg.hidden_size)) \
        .astype(np.float32)
    return d, jcfg, cfg, params["layers"][0]["mlp"], tree["layers"][0]["mlp"], x


@pytest.mark.parametrize("rows", [True, False], ids=["rows", "chunk"])
def test_moe_ffn_offloaded_matches_jax_and_resident(moe_layer, rows):
    d, jcfg, cfg, jmlp, mlp, x = moe_layer
    k, norm = cfg.num_experts_per_tok, cfg.norm_topk_prob
    jprov = jep.DiskExpertProvider(JaxStorage.from_model_dir(d),
                                   "model.layers.0", cfg.num_experts,
                                   dtype=jnp.float32, lru_size=3)
    want = np.asarray(jep.moe_ffn_offloaded(jnp.asarray(x),
                                            jmlp["gate"]["weight"], jprov,
                                            k, norm))
    with TensorStorage.from_model_dir(d) as st:
        prov = ep.DiskExpertProvider(st, "model.layers.0", cfg.num_experts,
                                     dtype=torch.float32, lru_size=3)
        got = ep.moe_ffn_offloaded(torch.from_numpy(x),
                                   mlp["gate"]["weight"], prov, k, norm,
                                   rows=rows)
    e = mlp["experts"]
    resident = moe_ffn(torch.from_numpy(x), mlp["gate"]["weight"],
                       e["gate_proj"], e["up_proj"], e["down_proj"], k, norm,
                       route="gathered" if rows else "dense")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), resident.numpy(), atol=1e-5,
                               rtol=0)
    if rows:
        # over the resident banks, stacked or one host dict per expert,
        # the rows take the gathered route's bits
        singles = [{p: e[p][i].clone() for p in ep.PROJS}
                   for i in range(cfg.num_experts)]
        for prov in (ep.ResidentExpertProvider(e),
                     ep.IndividualResidentProvider(singles)):
            assert prov.num_experts() == cfg.num_experts
            res = ep.moe_ffn_offloaded(torch.from_numpy(x),
                                       mlp["gate"]["weight"], prov, k, norm,
                                       rows=True)
            assert torch.equal(res, resident)


# -- the LRU and the prefetch ------------------------------------------------------


def test_lru_evicts_least_recent_and_counts(moe_layer):
    d, _, cfg, _, mlp, _ = moe_layer
    with TensorStorage.from_model_dir(d) as st:
        prov = ep.DiskExpertProvider(st, "model.layers.0", cfg.num_experts,
                                     dtype=torch.float32, lru_size=3)
        for e in (0, 1, 2):
            prov.get(e)
        prov.get(0)                     # a hit: 0 becomes the most recent
        prov.get(3)                     # evicts 1, the least recent
        assert list(prov._lru) == [2, 0, 3]
        prov.get(1)                     # read again, evicts 2
        assert list(prov._lru) == [0, 3, 1]
        s = prov.stats()
        assert (s["hits"], s["misses"], s["reads"], s["resident"]) == \
            (1, 5, 5, 3)
        one = sum(st.nbytes(n) for n in prov.names(0))
        assert s["bytes_read"] == 5 * one
        assert torch.equal(prov.get(3)["down_proj"],
                           mlp["experts"]["down_proj"][3])


def test_prefetch_warms_lru(moe_layer):
    d, _, cfg, _, _, _ = moe_layer
    with TensorStorage.from_model_dir(d) as st:
        prov = ep.DiskExpertProvider(st, "model.layers.0", cfg.num_experts,
                                     dtype=torch.float32, lru_size=8)
        prov.get(1)
        prov.prefetch([0, 1, 2])
        prov._prefetcher.join(timeout=30)
        assert not prov._prefetcher.is_alive()
        assert set(prov._lru) == {0, 1, 2}
        assert (prov.reads, prov.hits, prov.misses) == (3, 0, 1)
        prov.get(2)
        assert prov.hits == 1 and prov.reads == 3


# -- the eager-only guard ------------------------------------------------------------


def test_capture_refuses_offloaded_experts(moe_layer, monkeypatch):
    """Inside a CUDA-graph capture (mocked: the CPU has none) the provider's
    read and the offloaded routing raise instead of fetching to the host;
    outside it they run."""
    d, _, cfg, _, mlp, x = moe_layer
    with TensorStorage.from_model_dir(d) as st:
        prov = ep.DiskExpertProvider(st, "model.layers.0", cfg.num_experts,
                                     dtype=torch.float32)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        with pytest.raises(RuntimeError, match="cannot be captured"):
            prov.get(0)
        with pytest.raises(RuntimeError, match="cannot be captured"):
            ep.moe_ffn_offloaded(torch.from_numpy(x), mlp["gate"]["weight"],
                                 prov, cfg.num_experts_per_tok,
                                 cfg.norm_topk_prob)
        assert prov.reads == 0
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
        assert prov.get(0)["gate_proj"].shape == (32, cfg.hidden_size)


# -- the offloaded model ---------------------------------------------------------------

MODELS = {"qwen3_moe": {},
          "qwen3_5_moe": {"shared_expert_intermediate_size": 24}}


@pytest.mark.parametrize("fam", sorted(MODELS))
def test_offloaded_model_matches_jax_and_resident(tmp_path, fam):
    over = MODELS[fam]
    jcfg, cfg = jax_tiny(fam, **over), tiny_config(fam, **over)
    d = str(tmp_path / fam)
    params = _jax_checkpoint(d, jcfg, seed=5)
    if fam == "qwen3_5_moe":
        kinds = [s.kind for s in cfg.layer_specs()]
        assert "linear" in kinds and "full" in kinds
        assert cfg.shared_expert_intermediate_size == 24
    n = 16
    jm = JaxOffloaded(jcfg, jax_load(jcfg, d, jnp.float32,
                                     expert_offload=True, expert_lru_size=3),
                      dtype=jnp.float32, max_cache_len=128)
    jtoks, _ = jm.generate(PROMPT, max_new_tokens=n,
                           sampling=JaxSampling(temperature=0.0))
    om = OffloadedTextModel(cfg, load_model_params(
        cfg, d, torch.float32, "cpu", expert_offload=True, expert_lru_size=3),
        dtype=torch.float32, device="cpu", max_cache_len=128)
    toks, stats = om.generate(PROMPT, max_new_tokens=n, sampling=GREEDY)
    resident = TextModel(cfg, params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params), "cpu",
        torch.float32), dtype=torch.float32, device="cpu", max_cache_len=128)
    rtoks, _ = resident.generate(PROMPT, max_new_tokens=n, sampling=GREEDY,
                                 spec=False)
    assert toks == jtoks == rtoks
    assert stats["expert_offload"] is True
    assert stats["expert_reads"] == stats["expert_misses"] > 0
    assert stats["expert_bytes_read"] > 0
    # every MoE layer holds a provider, none a bank, the LRU bounded
    for lp in om.params["layers"]:
        assert "experts" not in lp["mlp"]
        assert len(lp["mlp"]["_provider"]._lru) <= 3
    jr = JaxTextModel(jcfg, params=params, dtype=jnp.float32,
                      max_cache_len=128)
    jl, _ = jr.prefill(jr.new_cache(), PROMPT)
    tl = om.prefill(om.new_cache(1, 128), PROMPT)[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("kind", ["gguf", "fp8"])
def test_runtime_offload_branches_match_jax(tmp_path, kind):
    """build_text_model(expert_offload=True) over a GGUF-only directory and
    over an FP8 checkpoint (experts dequantized on read): the JAX
    loader's offloaded model over the same file gives the same greedy
    tokens, and the port's offloaded model its resident model's."""
    d = str(tmp_path / kind)
    config = dict(TINY_MOE)
    if kind == "gguf":
        sc.write_gguf_model(d, config, seed=8)
    else:
        sc.write_fp8_model(d, config, sc.model_params(config, 9,
                                                      torch.float32))
    om, _, _ = build_text_model(d, dtype="f32", device="cpu",
                                max_cache_len=128, expert_offload=True)
    assert isinstance(om, OffloadedTextModel)
    rm, _, _ = build_text_model(d, dtype="f32", device="cpu",
                                max_cache_len=128)
    from cake_tpu.models.common.config import config_from_hf_dict
    if kind == "gguf":
        from cake_tpu.utils.gguf import GgufReader, gguf_config_dict
        path = os.path.join(d, "model.gguf")
        jcfg = config_from_hf_dict(gguf_config_dict(GgufReader(path)))
        jparams = JaxLoader(jcfg, JaxGguf(path, jcfg.model_prefix),
                            jnp.float32, jquant.NoQuantization(),
                            expert_offload=True, expert_lru_size=2).load()
    else:
        jcfg = config_from_hf_dict(config)
        jparams = jax_load(jcfg, d, jnp.float32, expert_offload=True,
                           expert_lru_size=2)
    jm = JaxOffloaded(jcfg, jparams, dtype=jnp.float32, max_cache_len=128)
    jtoks, _ = jm.generate(PROMPT, max_new_tokens=12,
                           sampling=JaxSampling(temperature=0.0))
    toks, stats = om.generate(PROMPT, max_new_tokens=12, sampling=GREEDY)
    rtoks, _ = rm.generate(PROMPT, max_new_tokens=12, sampling=GREEDY,
                           spec=False)
    assert toks == jtoks == rtoks
    assert stats["expert_reads"] > 0


# -- the runtime's refusals ------------------------------------------------------------


@pytest.mark.parametrize("case", ["no_experts", "fp8_native"])
def test_runtime_refuses_as_the_reference(tmp_path, case):
    d = str(tmp_path / case)
    if case == "no_experts":
        config = dict(TINY_MOE, architectures=["Qwen3ForCausalLM"])
        for k in ("num_experts", "num_experts_per_tok",
                  "moe_intermediate_size"):
            config.pop(k)
        sc.write_model(d, config, sc.model_params(config, 1, torch.float32))
        kw, match = {}, "--expert-offload needs an MoE model"
    else:
        sc.write_fp8_model(d, dict(TINY_MOE),
                           sc.model_params(dict(TINY_MOE), 1, torch.float32))
        kw = {"fp8_native": True}
        match = ("--expert-offload and --fp8-native cannot combine "
                 r"\(offloaded experts dequant on read\)")
    with pytest.raises(ValueError, match=match):
        build_text_model(d, dtype="f32", device="cpu", expert_offload=True,
                         **kw)
