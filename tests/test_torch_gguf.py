"""GGUF checkpoints in the port (utils/gguf.py, runtime.build_text_model)
against the JAX package on the same seeded inputs:

* every block dequantizer (F32, F16, BF16, Q4_0, Q5_0, Q5_1, Q8_0, Q2_K,
  Q3_K, Q4_K, Q6_K) on seeded raw blocks, bit for bit against
  cake_tpu.utils.gguf; Q5_K, which the reference names without defining
  (its read of a Q5_K tensor raises NameError), against a scalar
  transcription of ggml's dequantize_row_q5_K;
* names (llama.cpp's tables, the gemma3 and olmo2 overrides, qwen3moe's
  expert banks as virtual per-expert names) and gguf_config_dict equal
  to the JAX package's; an unknown architecture and a file that is not
  GGUF raise as they do there;
* a GgufStorage read equal to the reference's for every tensor
  (gemma's baked norm offset undone);
* end to end, tiny qwen3 checkpoints written by the port's writer (Q8_0,
  and a Q4_K_M-style mix of Q4_K and Q6_K at hidden 256) loaded by both
  packages: the same parameter bits in f32 and bf16, prefill logits
  within the golden bar (atol 1e-3), greedy tokens identical."""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.runtime import load_config_and_quant as jax_config_and_quant
from cake_tpu.utils import gguf as jgguf
from cake_tpu.utils.loaders import ParamLoader as JaxParamLoader
from cake_tpu_torch.bench import synth_checkpoint as sc
from cake_tpu_torch.runtime import build_text_model, load_config_and_quant
from cake_tpu_torch.utils import gguf

torch.set_num_threads(1)
ATOL = 1e-3

QUANTIZED = ("Q4_0", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q6_K")


def _raw_blocks(name: str, n: int, seed: int) -> bytes:
    """Seeded raw blocks of ggml type `name`: random bytes with every f16
    field (d, dmin) set to a finite value."""
    t = getattr(gguf, f"GGML_{name}")
    per, nbytes = gguf.BLOCKS[t]
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, (n // per, nbytes), dtype=np.uint8)
    halves = {"Q4_0": (0,), "Q5_0": (0,), "Q5_1": (0, 2), "Q8_0": (0,),
              "Q2_K": (80, 82), "Q3_K": (108,), "Q4_K": (0, 2),
              "Q5_K": (0, 2), "Q6_K": (208,)}[name]
    for at in halves:
        d = rng.uniform(-0.1, 0.1, len(b)).astype(np.float16)
        b[:, at:at + 2] = d.view(np.uint8).reshape(-1, 2)
    return b.tobytes()


def _tensor(raw: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8)


@pytest.mark.parametrize("name", QUANTIZED)
def test_block_dequantizer_matches_jax(name):
    n = 4 * 256
    raw = _raw_blocks(name, n, seed=len(name) + ord(name[1]))
    fn = f"dequant_{name.lower()}"
    got = getattr(gguf, fn)(_tensor(raw), n).numpy()
    want = getattr(jgguf, fn)(raw, n)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _scalar_q5k(block: bytes) -> np.ndarray:
    """ggml's dequantize_row_q5_K, one super-block, written as its C loop."""
    d = np.frombuffer(block[0:2], np.float16)[0].astype(np.float32)
    dmin = np.frombuffer(block[2:4], np.float16)[0].astype(np.float32)
    scales, qh, ql = block[4:16], block[16:48], block[48:176]

    def scale_min(j):
        if j < 4:
            return scales[j] & 63, scales[j + 4] & 63
        return ((scales[j + 4] & 0xF) | ((scales[j - 4] >> 6) << 4),
                (scales[j + 4] >> 4) | ((scales[j] >> 6) << 4))
    y = np.zeros(256, np.float32)
    is_, q, u1, u2 = 0, 0, 1, 2
    for j in range(0, 256, 64):
        sc, m = scale_min(is_)
        d1, m1 = d * np.float32(sc), dmin * np.float32(m)
        sc, m = scale_min(is_ + 1)
        d2, m2 = d * np.float32(sc), dmin * np.float32(m)
        for lane in range(32):
            hi1 = 16 if qh[lane] & u1 else 0
            hi2 = 16 if qh[lane] & u2 else 0
            y[j + lane] = d1 * np.float32((ql[q + lane] & 0xF) + hi1) - m1
            y[j + 32 + lane] = d2 * np.float32((ql[q + lane] >> 4) + hi2) \
                - m2
        q, is_, u1, u2 = q + 32, is_ + 2, u1 << 2, u2 << 2
    return y


def test_q5_k_matches_the_ggml_loop_where_the_reference_has_none():
    raw = _raw_blocks("Q5_K", 3 * 256, seed=9)
    got = gguf.dequant_q5_k(_tensor(raw), 3 * 256).numpy()
    want = np.concatenate([_scalar_q5k(raw[k * 176:(k + 1) * 176])
                           for k in range(3)])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not hasattr(jgguf, "dequant_q5_k")


def _w_tensor(name, dims, ttype, offset) -> bytes:
    return (sc._gguf_str(name) + struct.pack("<I", len(dims))
            + struct.pack(f"<{len(dims)}Q", *dims)
            + struct.pack("<IQ", ttype, offset))


def _write_gguf(path, tensors: dict, arch: str = "qwen3",
                meta: dict | None = None) -> None:
    """tensors: name -> (ggml type, torch-layout shape, raw bytes)."""
    kvs = {"general.architecture": arch, "general.alignment": 32,
           f"{arch}.embedding_length": 64, f"{arch}.block_count": 1,
           f"{arch}.attention.head_count": 4,
           f"{arch}.attention.head_count_kv": 2,
           f"{arch}.feed_forward_length": 128,
           f"{arch}.context_length": 512,
           f"{arch}.rope.freq_base": 1e6,
           f"{arch}.attention.layer_norm_rms_epsilon": 1e-6,
           "tokenizer.ggml.eos_token_id": 2,
           "tokenizer.ggml.bos_token_id": 1}
    kvs.update(meta or {})
    infos, data = [], b""
    for name, (ttype, shape, raw) in tensors.items():
        infos.append(_w_tensor(name, tuple(reversed(shape)), ttype,
                               len(data)))
        data += raw + b"\0" * ((-len(raw)) % 32)
    body = struct.pack("<IIQQ", gguf.GGUF_MAGIC, 3, len(infos), len(kvs)) \
        + b"".join(sc._gguf_kv(k, v) for k, v in kvs.items()) \
        + b"".join(infos)
    with open(path, "wb") as f:
        f.write(body + b"\0" * ((-len(body)) % 32) + data)


def _every_type_file(path, arch: str) -> dict:
    """One tensor of each of the twelve types (Q5_K excepted: the
    reference cannot read it) plus norms, a router and an expert bank."""
    rng = np.random.default_rng(4)
    tensors = {}
    for k, name in enumerate(("F32", "F16", "BF16") + QUANTIZED):
        t = getattr(gguf, f"GGML_{name}")
        shape = (8, 256)
        if name == "F32":
            raw = rng.standard_normal(shape).astype(np.float32).tobytes()
        elif name in ("F16", "BF16"):
            raw = rng.standard_normal(shape).astype(np.float16).tobytes()
        else:
            raw = _raw_blocks(name, 8 * 256, seed=k)
        stem = ["attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                "ffn_up", "ffn_down", "token_embd", "output", "attn_q_norm",
                "ffn_gate_inp"][k]
        full = stem + ".weight" if stem in ("token_embd", "output") \
            else f"blk.0.{stem}.weight"
        tensors[full] = (t, shape, raw)
    for stem in ("attn_norm", "ffn_norm", "post_attention_norm",
                 "post_ffw_norm"):
        w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
        tensors[f"blk.0.{stem}.weight"] = (gguf.GGML_F32, (64,),
                                           w.tobytes())
    bank = _raw_blocks("Q8_0", 4 * 16 * 64, seed=11)
    tensors["blk.0.ffn_up_exps.weight"] = (gguf.GGML_Q8_0, (4, 16, 64), bank)
    _write_gguf(path, tensors, arch)
    return tensors


@pytest.mark.parametrize("arch", ["qwen3", "qwen3moe", "gemma3", "olmo2",
                                  "llama"])
def test_storage_reads_as_the_reference_reads(tmp_path, arch):
    path = str(tmp_path / "m.gguf")
    _every_type_file(path, arch)
    jst = jgguf.GgufStorage(path)
    st = gguf.GgufStorage(path)
    assert sorted(st.names()) == sorted(jst.names())
    for name in jst.names():
        want = np.asarray(jst.read(name))
        got = st.read(name)
        if want.dtype.kind == "V":                 # ml_dtypes bfloat16
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16), err_msg=name)
            continue
        assert str(got.dtype).endswith(str(want.dtype)), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    if arch == "gemma3":
        w = st.read("model.layers.0.input_layernorm.weight")
        assert abs(w.mean().item()) < 0.5              # the +1 undone
    if arch == "qwen3moe":
        assert "model.layers.0.mlp.experts.3.up_proj.weight" in st
        assert "model.layers.0.mlp.gate.weight" in st


NAMES = ["token_embd.weight", "output_norm.weight", "output.weight",
         "rope_freqs.weight", "blk.3.attn_q.weight", "blk.3.attn_k.bias",
         "blk.0.attn_norm.weight", "blk.0.ffn_norm.weight",
         "blk.0.post_attention_norm.weight", "blk.0.post_ffw_norm.weight",
         "blk.1.attn_q_norm.weight", "blk.2.ffn_gate_inp.weight",
         "blk.2.ffn_gate_exps.weight", "blk.5.ffn_down.weight"]


@pytest.mark.parametrize("arch", ["llama", "qwen3", "qwen3moe", "gemma3",
                                  "olmo2"])
def test_names_map_as_the_reference_maps_them(arch):
    for name in NAMES:
        for prefix in ("model", "model.language_model"):
            assert gguf.gguf_to_hf_name(name, prefix, arch) == \
                jgguf.gguf_to_hf_name(name, prefix, arch), (name, arch)
    assert gguf.GGUF_NAME_OVERRIDES == jgguf.GGUF_NAME_OVERRIDES
    assert gguf.MOE_BANK_STEMS == jgguf.MOE_BANK_STEMS
    assert gguf.GGUF_ARCH_TO_HF == jgguf.GGUF_ARCH_TO_HF


@pytest.mark.parametrize("arch,meta", [
    ("qwen3", {"qwen3.attention.key_length": 16}),
    ("qwen3moe", {"qwen3moe.expert_count": 8,
                  "qwen3moe.expert_used_count": 2,
                  "qwen3moe.expert_feed_forward_length": 32}),
    ("gemma3", {"gemma3.attention.sliding_window": 16}),
    ("llama", {"llama.vocab_size": 300}),
], ids=["qwen3", "qwen3moe", "gemma3", "llama"])
def test_config_dict_matches_jax(tmp_path, arch, meta):
    path = str(tmp_path / "m.gguf")
    emb = np.zeros((256, 64), np.float32).tobytes()
    _write_gguf(path, {"token_embd.weight": (gguf.GGML_F32, (256, 64),
                                             emb)}, arch, meta)
    got = gguf.gguf_config_dict(gguf.GgufReader(path))
    assert got == jgguf.gguf_config_dict(jgguf.GgufReader(path))
    cfg, q, raw = load_config_and_quant(str(tmp_path))
    jcfg, _, jraw = jax_config_and_quant(str(tmp_path))
    assert raw == jraw and q.name == "none"
    assert (cfg.arch, cfg.head_dim, cfg.vocab_size) == \
        (jcfg.arch, jcfg.head_dim, jcfg.vocab_size)


def test_unknown_arch_and_bad_file_raise_as_jax(tmp_path):
    path = str(tmp_path / "m.gguf")
    _write_gguf(path, {}, "qwen3next")
    for mod in (gguf, jgguf):
        with pytest.raises(NotImplementedError, match="qwen3next"):
            mod.gguf_config_dict(mod.GgufReader(path))
    bad = tmp_path / "bad.gguf"
    bad.write_bytes(b"NOPE" + bytes(20))
    for mod in (gguf, jgguf):
        with pytest.raises(ValueError, match="not a GGUF file"):
            mod.GgufReader(str(bad))


# -- end to end -------------------------------------------------------------------

TINY = dict(architectures=["Qwen3ForCausalLM"], vocab_size=512,
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=32,
            rms_norm_eps=1e-6, max_position_embeddings=256,
            tie_word_embeddings=True, eos_token_id=2)
# K-quants need rows of whole 256-value super-blocks
TINY_K = dict(TINY, hidden_size=256, intermediate_size=512, head_dim=64,
              tie_word_embeddings=False)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mix", ["q8_0", "q4_k_m"])
def test_gguf_checkpoint_loads_as_jax_loads_it(tmp_path, mix, dtype):
    config = TINY if mix == "q8_0" else TINY_K
    d = tmp_path / "gguf"
    sc.write_gguf_model(str(d), config, seed=3, mix=mix)
    reader = gguf.GgufReader(str(d / "model.gguf"))
    types = {t.ggml_type for t in reader.tensors.values()}
    assert types == ({gguf.GGML_F32, gguf.GGML_Q8_0} if mix == "q8_0" else
                     {gguf.GGML_F32, gguf.GGML_Q4_K, gguf.GGML_Q6_K})
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    jcfg, _, _ = jax_config_and_quant(str(d))
    assert jcfg.head_dim == config["head_dim"]       # from key_length
    want = JaxParamLoader(jcfg, jgguf.GgufStorage(str(d / "model.gguf")),
                          jdt).load()
    want.pop("rope")
    tm, _, model_id = build_text_model(str(d), dtype=dtype, device="cpu",
                                       max_cache_len=256)
    assert model_id == "gguf" and tm.cfg.head_dim == config["head_dim"]
    got = dict(_flat(tm.params))
    wbits = dict(_flat(want))
    assert got.keys() == wbits.keys()
    for k, v in got.items():
        w = np.asarray(wbits[k])
        a = v.view(torch.int16).numpy() if v.element_size() == 2 \
            else v.numpy()
        np.testing.assert_array_equal(
            a, w.view(np.int16) if w.dtype.itemsize == 2 else w, err_msg=k)
    if dtype == "bf16":
        return
    jm = JaxTextModel(jcfg, params=JaxParamLoader(
        jcfg, jgguf.GgufStorage(str(d / "model.gguf")), jnp.float32).load(),
        dtype=jnp.float32, max_cache_len=256)
    ids = [int(t) for t in np.random.default_rng(5).integers(8, 500, 40)]
    jl, _ = jm.prefill(jm.new_cache(), ids)
    tl, _ = tm.prefill(tm.new_cache(), ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    jtoks, _ = jm.generate(ids, max_new_tokens=12, spec=False)
    assert tm.generate(ids, max_new_tokens=12)[0] == jtoks
