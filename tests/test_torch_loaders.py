"""Checkpoint loading of the port (utils/loaders.py through
runtime.build_text_model) against the JAX package, for every dense family
the port adapts: a tiny config, the JAX `init_params` with every leaf
randomized (weights N(0, 0.05), norms 1 + N(0, 0.2), so identity norms
hide nothing), written by the JAX exporter (`params_to_hf_tensors`,
Phi-4 both fused and unfused) and `save_safetensors`. The port's model
built from that directory and the JAX TextModel over the JAX
`load_model_params` of the same directory agree: prefill logits within
the golden bar (atol 1e-3) and 16 greedy tokens identical. The port's
exporter then writes the port's own tree, which loads back bit for bit.

EXAONE4 runs with a window of 16 under a 40-token prompt, so its local
layers slide and its global layers skip RoPE; Phi-4 with a partial rotary
factor of 0.75; Gemma3 with a window of 16, every second layer global,
its local layers on their own RoPE table, and its checkpoint storing each
norm as w for a 1 + w norm (its norms drawn within 1 +- 0.48, where the
float32 w - 1 and + 1 of the export and the load are exact, so the
port's own round trip stays bit for bit). Every family's tensors, loaded
by both loaders in float32 and in bfloat16, are bit-identical."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models.common.config import config_from_hf_dict as jax_config
from cake_tpu.models.common.layers import init_params as jax_init_params
from cake_tpu.utils.export import params_to_hf_tensors as jax_export
from cake_tpu.utils.loaders import load_model_params as jax_load
from cake_tpu.utils.safetensors_io import save_safetensors as jax_save
from cake_tpu_torch.runtime import build_text_model
from cake_tpu_torch.utils.export import params_to_hf_tensors, write_checkpoint
from cake_tpu_torch.utils.loaders import load_model_params

torch.set_num_threads(1)
ATOL = 1e-3
ARCHS = {"llama": "LlamaForCausalLM", "qwen2": "Qwen2ForCausalLM",
         "qwen3": "Qwen3ForCausalLM", "mistral": "MistralForCausalLM",
         "falcon3": "FalconForCausalLM", "olmo2": "Olmo2ForCausalLM",
         "exaone4": "Exaone4ForCausalLM", "phi4": "Phi3ForCausalLM",
         "gemma3": "Gemma3ForCausalLM"}
EXTRA = {"exaone4": dict(sliding_window=16, sliding_window_pattern="LLLG"),
         "phi4": dict(partial_rotary_factor=0.75),
         "mistral": dict(sliding_window=24),
         "gemma3": dict(sliding_window=16, sliding_window_pattern=2,
                        query_pre_attn_scalar=24, rope_theta=1e6,
                        rope_local_base_freq=1e4)}
CASES = [(fam, False) for fam in ARCHS] + [("phi4", True)]


def tiny_hf_config(fam: str) -> dict:
    """The tiny_config dict (hidden 64, 4 layers, GQA 4/2) as config.json."""
    d = dict(architectures=[ARCHS[fam]], vocab_size=256, hidden_size=64,
             intermediate_size=128, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5,
             rope_theta=10000.0, max_position_embeddings=128,
             eos_token_id=[2, 7])
    d.update(EXTRA.get(fam, {}))
    return d


def randomize(params: dict, seed: int, clip_norms: bool = False) -> dict:
    """Every leaf drawn anew: weights N(0, 0.05), norms 1 + N(0, 0.2),
    with clip_norms cut to 1 +- 0.48."""
    rng = np.random.default_rng(seed)
    rope = params.pop("rope")

    def rand(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            z = rng.normal(0.0, 0.2, np.shape(leaf))
            arr = 1.0 + (np.clip(z, -0.48, 0.48) if clip_norms else z)
        else:
            arr = rng.normal(0.0, 0.05, np.shape(leaf))
        return jnp.asarray(arr.astype(np.float32))
    out = jax.tree_util.tree_map_with_path(rand, params)
    out["rope"] = rope
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("fam,fused", CASES)
def test_port_loads_jax_checkpoint(tmp_path, fam, fused):
    hf = tiny_hf_config(fam)
    jcfg = jax_config(hf)
    params = randomize(jax_init_params(jcfg, jax.random.PRNGKey(3),
                                       jnp.float32), seed=11,
                       clip_norms=jcfg.residual_rms_norm)
    d = tmp_path / "ckpt"
    d.mkdir()
    jax_save(str(d / "model.safetensors"),
             jax_export(jcfg, params, fuse_phi=fused))
    (d / "config.json").write_text(json.dumps(hf))
    if fused:
        names = json.dumps(sorted(jax_export(jcfg, params, fuse_phi=True)))
        assert "qkv_proj" in names and "gate_up_proj" in names
    jm = JaxTextModel(jcfg, params=jax_load(jcfg, str(d), jnp.float32),
                      dtype=jnp.float32, max_cache_len=128)
    tm, _, model_id = build_text_model(str(d), dtype="f32", device="cpu",
                                       max_cache_len=128)
    assert model_id == "ckpt"
    assert tm.cfg.eos_token_ids == (2, 7)
    assert [(s.kind, s.use_rope, s.window, s.norm_style)
            for s in tm.cfg.layer_specs()] == \
        [(s.kind, s.use_rope, s.window, s.norm_style)
         for s in jcfg.layer_specs()]
    ids = [int(t) for t in np.random.default_rng(5).integers(8, 256, 40)]
    want, _ = jm.prefill(jm.new_cache(), ids)
    got, _ = tm.prefill(tm.new_cache(), ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    jtoks, _ = jm.generate(ids, max_new_tokens=16, spec=False)
    ttoks, _ = tm.generate(ids, max_new_tokens=16)
    assert ttoks == jtoks

    # the port's exporter round-trips the port's own tree bit for bit
    out = tmp_path / "again"
    write_checkpoint(str(out), hf,
                     params_to_hf_tensors(
                         tm.params, fuse_phi=fused,
                         residual_norms=tm.cfg.residual_rms_norm),
                     shards=2)
    again = load_model_params(tm.cfg, str(out), torch.float32, "cpu")
    a, b = dict(_flat(tm.params)), dict(_flat(again))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _jax_tree_bits(tree, prefix=""):
    """{path: numpy array} of a JAX tree, bfloat16 as its int16 bits."""
    for path, leaf in _flat(tree, prefix):
        a = np.asarray(leaf)
        yield path, (a.view(np.int16) if a.dtype.itemsize == 2 else a)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fam", sorted(ARCHS))
def test_both_loaders_give_the_same_bits(tmp_path, fam, dtype):
    """The JAX package's load_model_params and the port's, on one
    checkpoint written by the JAX exporter: every tensor bit-identical,
    the (1+w) norms of Gemma3 included."""
    hf = tiny_hf_config(fam)
    jcfg = jax_config(hf)
    params = randomize(jax_init_params(jcfg, jax.random.PRNGKey(4),
                                       jnp.float32), seed=12)
    jax_save(str(tmp_path / "model.safetensors"), jax_export(jcfg, params))
    (tmp_path / "config.json").write_text(json.dumps(hf))
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jax_load(jcfg, str(tmp_path), jdt)
    want.pop("rope", None)
    tm, _, _ = build_text_model(str(tmp_path), dtype=dtype, device="cpu",
                                max_cache_len=128)
    got = {k: (v.view(torch.int16) if v.element_size() == 2 else v).numpy()
           for k, v in _flat(tm.params)}
    want = dict(_jax_tree_bits(want))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if jcfg.residual_rms_norm:
        w = tm.params["layers"][0]["pre_feedforward_layernorm"]["weight"]
        assert 0.5 < w.float().mean().item() < 1.5     # 1 + w, not w


def test_missing_tensor_names_itself(tmp_path):
    hf = tiny_hf_config("olmo2")
    jcfg = jax_config(hf)
    tensors = jax_export(jcfg, jax_init_params(jcfg, jax.random.PRNGKey(0),
                                               jnp.float32))
    del tensors["model.layers.2.post_feedforward_layernorm.weight"]
    jax_save(str(tmp_path / "model.safetensors"), tensors)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(KeyError,
                       match="model.layers.2.post_feedforward_layernorm"):
        build_text_model(str(tmp_path), dtype="f32", device="cpu")


# -- module 10: MoE experts and Gated DeltaNet layers ---------------------------

_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
             max_position_embeddings=128, eos_token_id=2, num_experts=8,
             num_experts_per_tok=2, moe_intermediate_size=32)
MODULE10 = {
    "qwen3_next": dict(
        _TINY, architectures=["Qwen3NextForCausalLM"],
        layer_types=["linear_attention"] * 3 + ["full_attention"],
        linear_num_key_heads=2, linear_key_head_dim=16,
        linear_num_value_heads=4, linear_value_head_dim=16,
        shared_expert_intermediate_size=24, partial_rotary_factor=0.25),
    "qwen3_moe": dict(_TINY, architectures=["Qwen3MoeForCausalLM"]),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fam", sorted(MODULE10))
def test_module10_checkpoint_loads_as_jax_loads_it(tmp_path, fam, dtype):
    """A tiny Qwen3-Next (in HF's layout: in_proj_qkvz / in_proj_ba, one
    tensor per expert, the shared expert and its gate, (1+w) norms stored
    as w) and a tiny Qwen3-MoE, written by the port's exporter from the
    JAX tree carried across with params_from_numpy: the JAX ParamLoader's
    tree, the carried tree and the port's load are the same bits, A_log
    and dt_bias float32 in all three."""
    from cake_tpu_torch.models.common.config import config_from_hf_dict
    from cake_tpu_torch.utils import params_from_numpy
    hf = MODULE10[fam]
    jcfg, cfg = jax_config(hf), config_from_hf_dict(hf)
    params = randomize(jax_init_params(jcfg, jax.random.PRNGKey(6),
                                       jnp.float32), seed=13,
                       clip_norms=jcfg.residual_rms_norm)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tensors = params_to_hf_tensors(
        params_from_numpy(cfg, tree, "cpu", torch.float32),
        residual_norms=cfg.residual_rms_norm, cfg=cfg)
    names = " ".join(tensors)
    assert "model.layers.0.mlp.experts.7.down_proj.weight" in names
    if fam == "qwen3_next":
        assert "in_proj_qkvz" in names and "in_proj_ba" in names
        assert "mlp.shared_expert_gate.weight" in names
    write_checkpoint(str(tmp_path), hf, tensors)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jax_load(jcfg, str(tmp_path), jdt)
    want.pop("rope", None)
    got = load_model_params(cfg, str(tmp_path), tdt, "cpu")
    carried = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, want), "cpu", tdt)
    want = dict(_jax_tree_bits(want))
    for tree_ in (got, carried):
        bits = {k: (v.view(torch.int16) if v.element_size() == 2
                    else v).numpy() for k, v in _flat(tree_)}
        assert bits.keys() == want.keys()
        for k in bits:
            np.testing.assert_array_equal(bits[k], want[k], err_msg=k)
    if fam == "qwen3_next":
        gdn = got["layers"][0]["linear_attn"]
        assert gdn["A_log"].dtype == gdn["dt_bias"].dtype == torch.float32
        assert got["layers"][0]["mlp"]["experts"]["gate_proj"].shape == \
            (8, 32, 64)
