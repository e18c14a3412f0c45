"""Checkpoint directories written from seeded weights, for the smoke and
the tests: the repository holds no published checkpoint and no published
tokenizer, and nothing may be downloaded.

* `FAMILIES`: config.json dicts at the widths of six published models
  (the source of each beside it, the fields assumed listed above it);
  `family_config` cuts the depth only.
* `model_params(config, seed, ...)`: seeded weights (`init_params`, with
  the norms drawn around 1 when `randomize_norms`, so identity norms hide
  nothing); `write_model(dir, config, params, shards)` writes them
  through the port's exporter as safetensors shards, Phi-4 with its fused
  `qkv_proj` / `gate_up_proj` names.
* `write_tokenizer(dir, specials, ...)`: a byte-level BPE tokenizer.json
  (the 256 byte tokens, then merges learned by `learn_merges`, a small
  deterministic learner, from `CORPUS`, a fixed multilingual text) with
  the given special tokens at the given ids, and a tokenizer_config.json
  with a ChatML template.
* Quantized checkpoints in the published layouts: `write_fp8_model`
  (Qwen's FP8 block-wise layout: each projection as float8_e4m3fn with a
  float32 `weight_scale_inv` per 128 x 128 block, through
  `quant_fp8_blockwise`, the rest bf16, Qwen's `quantization_config`),
  `write_gptq_model` (AutoGPTQ 4-bit: seeded nibbles in int32 `qweight`
  and `qzeros`, float16 `scales`, optionally a permuted `g_idx` with
  desc_act) and `write_gguf_model` (GGUF v3, arch `qwen3`: seeded raw
  Q8_0, or a Q4_K_M-style mix of Q4_K and Q6_K blocks, with finite f16
  d / dmin, F32 norms and `qwen3.*` metadata). `QWEN3_8B` is
  Qwen/Qwen3-8B's widths (every field assumed), the shape of
  Qwen/Qwen3-8B-FP8.
* `write_gemma_tokenizer(dir, ...)`: a tokenizer.json in the style of
  Gemma's (converted from SentencePiece): Gemma's special tokens at
  Gemma's ids, the 256 `<0xNN>` byte tokens, the characters of `CORPUS`
  with " " written "▁", merges learned from it as one text, fillers up to
  a full vocabulary, byte fallback, a Replace normalizer, no
  pre-tokenizer, a BOS added by TemplateProcessing, and a Gemma-style
  chat template.
"""
from __future__ import annotations

import collections
import json
import os
import re
import struct

import numpy as np
import torch

from ..models.common.config import FLAGSHIP_QWEN3_0_6B, config_from_hf_dict
from ..models.common.layers import init_params
from ..ops.fp8 import quant_fp8_blockwise
from ..utils import gguf
from ..utils.bpe import GPT2_PATTERN, bytes_to_unicode, translate_regex
from ..utils.export import params_to_hf_tensors, write_checkpoint

# The widths of three published models, as config.json dicts, with the
# repository each is taken from beside it. None of these fields has been
# checked against the repository's own config.json: they follow the
# model cards' tables, not a copy of the files, and fields the port does
# not read are left out. Assumed beyond the widths: EOS and BOS ids, OLMo2's
# rope_theta, EXAONE4's rope_theta, its llama3 rope_scaling and its
# "LLLG" pattern with window 4096, and Phi-4's rope_theta. Every Gemma3
# field is written from memory of google/gemma-3-1b-it's config.json:
# widths, head_dim 256, query_pre_attn_scalar, window 512 with pattern 6,
# both RoPE bases and the EOS ids [1, 106] are all assumed. So is every
# field of the Qwen3-Next-80B-A3B and Qwen3-30B-A3B entries (widths, head
# counts, expert counts and sizes, the linear-attention heads, RoPE, EOS
# ids); Qwen3-Next's every-4th-layer full attention is written as an
# explicit layer_types list, which is what both packages read. The EXAONE4
# entry is EXAONE-4.0-1.2B's widths with an assumed LLLG pattern: the
# card names the 3:1 local/global hybrid for the 32B, and the 1.2B may
# ship full attention in every layer. Confirm an entry only once that
# model's config.json is in the repository.
FAMILIES = {
    # allenai/OLMo-2-0425-1B widths
    "olmo2": dict(
        architectures=["Olmo2ForCausalLM"], vocab_size=100352,
        hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=4096, rms_norm_eps=1e-6,
        rope_theta=500000.0, tie_word_embeddings=False,
        eos_token_id=100257, pad_token_id=100277),
    # LGAI-EXAONE/EXAONE-4.0-1.2B widths; LLLG pattern and window assumed
    "exaone4": dict(
        architectures=["Exaone4ForCausalLM"], vocab_size=102400,
        hidden_size=2048, intermediate_size=4096, num_hidden_layers=30,
        num_attention_heads=32, num_key_value_heads=8, head_dim=64,
        max_position_embeddings=65536, rms_norm_eps=1e-5,
        rope_theta=1000000.0,
        rope_scaling=dict(rope_type="llama3", factor=16.0,
                          high_freq_factor=4.0, low_freq_factor=1.0,
                          original_max_position_embeddings=8192),
        sliding_window=4096, sliding_window_pattern="LLLG",
        tie_word_embeddings=True, bos_token_id=1, eos_token_id=361),
    # microsoft/Phi-4-mini-instruct widths (rope_scaling, a longrope
    # entry, left out: neither package implements it)
    "phi4": dict(
        architectures=["Phi3ForCausalLM"], vocab_size=200064,
        hidden_size=3072, intermediate_size=8192, num_hidden_layers=32,
        num_attention_heads=24, num_key_value_heads=8,
        max_position_embeddings=131072, partial_rotary_factor=0.75,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=True,
        bos_token_id=199999, eos_token_id=199999),
    # google/gemma-3-1b-it widths (every field assumed, see above)
    "gemma3": dict(
        architectures=["Gemma3ForCausalLM"], vocab_size=262144,
        hidden_size=1152, intermediate_size=6912, num_hidden_layers=26,
        num_attention_heads=4, num_key_value_heads=1, head_dim=256,
        query_pre_attn_scalar=256, sliding_window=512,
        sliding_window_pattern=6, rope_theta=1000000.0,
        rope_local_base_freq=10000.0, rope_scaling=None,
        rms_norm_eps=1e-6, max_position_embeddings=32768,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
        bos_token_id=2, eos_token_id=[1, 106], pad_token_id=0),
    # Qwen/Qwen3-Next-80B-A3B-Instruct widths (every field assumed)
    "qwen3_next": dict(
        architectures=["Qwen3NextForCausalLM"], vocab_size=151936,
        hidden_size=2048, intermediate_size=5120, num_hidden_layers=48,
        num_attention_heads=16, num_key_value_heads=2, head_dim=256,
        partial_rotary_factor=0.25, rope_theta=10000000.0,
        attn_output_gate=True,
        layer_types=["linear_attention" if (i + 1) % 4 else
                     "full_attention" for i in range(48)],
        linear_conv_kernel_dim=4, linear_num_key_heads=16,
        linear_key_head_dim=128, linear_num_value_heads=32,
        linear_value_head_dim=128, num_experts=512, num_experts_per_tok=10,
        moe_intermediate_size=512, shared_expert_intermediate_size=512,
        norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
        rms_norm_eps=1e-6, max_position_embeddings=262144,
        tie_word_embeddings=False, bos_token_id=151643,
        eos_token_id=151645),
    # Qwen/Qwen3-30B-A3B widths (every field assumed)
    "qwen3_moe": dict(
        architectures=["Qwen3MoeForCausalLM"], vocab_size=151936,
        hidden_size=2048, intermediate_size=6144, num_hidden_layers=48,
        num_attention_heads=32, num_key_value_heads=4, head_dim=128,
        num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
        norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
        rope_theta=1000000.0, rms_norm_eps=1e-6,
        max_position_embeddings=40960, tie_word_embeddings=False,
        bos_token_id=151643, eos_token_id=151645),
}

# Qwen/Qwen3-8B widths, the model of Qwen/Qwen3-8B-FP8 (every field
# assumed, from memory of its model card: hidden 4096, intermediate
# 12288, 36 layers, 32/8 heads of 128, vocab 151936, untied, RoPE 1e6)
QWEN3_8B = dict(
    architectures=["Qwen3ForCausalLM"], vocab_size=151936, hidden_size=4096,
    intermediate_size=12288, num_hidden_layers=36, num_attention_heads=32,
    num_key_value_heads=8, head_dim=128, rope_theta=1000000.0,
    rms_norm_eps=1e-6, max_position_embeddings=40960,
    tie_word_embeddings=False, bos_token_id=151643, eos_token_id=151645)

CHATML_TEMPLATE = (
    "{% for message in messages %}"
    "{{ '<|im_start|>' + message['role'] + '\\n' + message['content'] "
    "+ '<|im_end|>' + '\\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}"
    "{% endif %}")

# Qwen3's special tokens at Qwen3's ids
QWEN3_SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644,
                  "<|im_end|>": 151645}

CORPUS = (
    "The card serves chat requests from a paged cache of keys and values. "
    "Each request is prefilled in chunks of 256 tokens, then decoded one "
    "token at a time by a captured graph. "
    "Die Karte beantwortet Anfragen aus einem Seitenspeicher; jede Anfrage "
    "wird in Blöcken vorbereitet. "
    "La carte répond aux requêtes depuis un cache paginé, et chaque requête "
    "est décodée un jeton à la fois. "
    "El servidor responde en español con números como 42, 3.14 y 2026. "
    "显卡从分页缓存中提供聊天请求，每个请求分块预填充。"
    "カードはページ化されたキャッシュから応答します。"
    "카드는 페이지 캐시에서 채팅 요청을 처리합니다. "
    "Карта обслуживает запросы из страничного кэша. "
    "البطاقة تخدم طلبات الدردشة. "
    "Emoji and symbols: 🚀 ✓ → ½ ² Ⅻ.\n\n"
    "def serve(request):\n    return engine.submit(request.ids)\n")


def family_config(family: str, layers: int | None = None) -> dict:
    """The family's published config.json dict, its depth cut to `layers`
    (widths are never changed; a layer_types list keeps its first
    `layers` entries)."""
    cfg = dict(QWEN3_8B if family == "qwen3_8b" else FAMILIES[family])
    if layers:
        cfg["num_hidden_layers"] = layers
        if "layer_types" in cfg:
            cfg["layer_types"] = cfg["layer_types"][:layers]
    return cfg


def family_attention(family: str) -> dict:
    """hq, hkv, d and window of the family's attention layers at its
    published widths, read through the port's adapter: the shapes the
    kernels are held at on the card (window None: full attention only)."""
    cfg = config_from_hf_dict(FAMILIES[family])
    return dict(hq=cfg.num_attention_heads, hkv=cfg.num_key_value_heads,
                d=cfg.head_dim, window=cfg.sliding_window)


def flagship_config(layers: int | None = None) -> dict:
    cfg = dict(FLAGSHIP_QWEN3_0_6B)
    if layers:
        cfg["num_hidden_layers"] = layers
    return cfg


def _norms(params: dict):
    """Every norm's {"weight": ...} dict of a parameter tree (a linear
    layer's gated norm included)."""
    yield params["norm"]
    for layer in params["layers"]:
        for node in (layer, layer.get("self_attn", {}),
                     layer.get("linear_attn", {})):
            yield from (v for k, v in node.items() if k.endswith("norm"))


@torch.no_grad()
def model_params(config: dict, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16, device="cpu",
                 randomize_norms: bool = False, gen_device="cpu") -> dict:
    """init_params(seed, gen_device) of the config; with randomize_norms
    every norm
    weight is drawn as 1 + 0.2 * N(0, 1) from seed + 1. A (1+w) family's
    draw is cut to 1 +- 0.48: there the checkpoint stores w - 1, and
    within [0.5, 2] that difference and the loader's + 1 are exact, so
    the weights load back bit for bit."""
    cfg = config_from_hf_dict(config)
    params = init_params(cfg, seed, dtype, device, gen_device)
    if randomize_norms:
        gen = torch.Generator().manual_seed(seed + 1)
        for norm in _norms(params):
            w = norm["weight"]
            z = torch.randn(w.shape, generator=gen)
            if cfg.residual_rms_norm:
                z = z.clamp(-2.4, 2.4)
            norm["weight"] = (1 + 0.2 * z).to(device=device, dtype=dtype)
    return params


def _hf_tensors(config: dict, params: dict) -> dict:
    cfg = config_from_hf_dict(config)
    return params_to_hf_tensors(params, fuse_phi=cfg.fused_qkv,
                                residual_norms=cfg.residual_rms_norm,
                                cfg=cfg)


def write_model(model_dir: str, config: dict, params: dict,
                shards: int = 1) -> int:
    """config.json and the params as safetensors (Phi-4 with fused
    names). Returns the bytes of tensor data written."""
    return write_checkpoint(model_dir, config, _hf_tensors(config, params),
                            shards)


# -- quantized checkpoints -------------------------------------------------------

# Qwen's published FP8 quantization_config (Qwen/Qwen3-8B-FP8 and
# Qwen/Qwen3-0.6B-FP8)
FP8_CONFIG = {"quant_method": "fp8", "fmt": "e4m3",
              "activation_scheme": "dynamic",
              "weight_block_size": [128, 128]}


def _quantized(name: str, t: torch.Tensor) -> bool:
    """A projection: what the published FP8 and GPTQ checkpoints quantize
    (q/k/v/o, gate/up/down, experts', out_proj), never the embeddings,
    norms, head or router."""
    return name.endswith("_proj.weight") and t.dim() == 2


def write_fp8_model(model_dir: str, config: dict, params: dict,
                    shards: int = 1) -> int:
    """The params in Qwen's FP8 block-wise layout: each projection as
    float8_e4m3fn with its float32 `weight_scale_inv`, quantized where it
    lies (on the card for a large model), the rest as given. Returns the
    bytes of tensor data written."""
    out = {}
    for name, t in _hf_tensors(config, params).items():
        if _quantized(name, t):
            w, s = quant_fp8_blockwise(t)
            out[name] = w
            out[name + "_scale_inv"] = s
        else:
            out[name] = t
    return write_checkpoint(model_dir, dict(config, quantization_config=dict(
        FP8_CONFIG)), out, shards)


def write_gptq_model(model_dir: str, config: dict, params: dict,
                     seed: int = 0, group_size: int = 128,
                     desc_act: bool = False, shards: int = 1) -> int:
    """An AutoGPTQ 4-bit checkpoint: each projection [O, I] as seeded
    nibbles, int32 `qweight` [I/8, O] and `qzeros` [I/group, O/8], float16
    `scales` [I/group, O] in [0.002, 0.004) (weights about the init's
    0.02 spread), and with desc_act a `g_idx` [I] that permutes the
    groups; the other tensors from `params` in float16."""
    gen = torch.Generator().manual_seed(seed)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32)
    out = {}
    for name, t in _hf_tensors(config, params).items():
        if not _quantized(name, t):
            out[name] = t.to(torch.float16)
            continue
        o, i = t.shape
        if i % group_size or o % 8:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit groups "
                             f"of {group_size} and 8 nibbles a word")
        groups = i // group_size
        stem = name[:-len(".weight")]
        out[f"{stem}.qweight"] = words(i // 8, o)
        out[f"{stem}.qzeros"] = words(groups, o // 8)
        out[f"{stem}.scales"] = (0.002 + 0.002 * torch.rand(
            (groups, o), generator=gen)).to(torch.float16)
        if desc_act:
            seq = torch.arange(i, dtype=torch.int32) // group_size
            out[f"{stem}.g_idx"] = seq[torch.randperm(i, generator=gen)]
    qc = {"quant_method": "gptq", "bits": 4, "group_size": group_size,
          "desc_act": desc_act, "sym": False, "true_sequential": True}
    return write_checkpoint(model_dir, dict(config, quantization_config=qc),
                            out, shards)


# ggml types of a Q4_K_M-style mix: Q4_K, with Q6_K for these stems
Q4_K_M_HIGH = ("attn_v", "ffn_down", "token_embd", "output")
# per quantized type: the spread of its f16 d (and dmin) that gives
# weights about the init's 0.02 spread from uniform random quants
_GGUF_D = {gguf.GGML_Q8_0: (2.7e-4, 0.0), gguf.GGML_Q4_K: (1e-4, 7.5e-4),
           gguf.GGML_Q6_K: (1.5e-5, 0.0)}


def _gguf_blocks(ggml_type: int, n: int, rng) -> bytes:
    """n values of seeded raw blocks of a quantized type: random quants
    and scales, each block's d (and dmin) a finite f16 around _GGUF_D."""
    per, nbytes = gguf.BLOCKS[ggml_type]
    nb = n // per
    b = rng.integers(0, 256, (nb, nbytes), dtype=np.uint8)
    d0, m0 = _GGUF_D[ggml_type]
    d = (d0 * rng.uniform(0.5, 1.5, nb)).astype(np.float16).view(np.uint8)
    d = d.reshape(nb, 2)
    if ggml_type == gguf.GGML_Q6_K:
        b[:, 208:210] = d
    else:
        b[:, 0:2] = d
    if m0:
        b[:, 2:4] = (m0 * rng.uniform(0.5, 1.5, nb)).astype(
            np.float16).view(np.uint8).reshape(nb, 2)
    return b.tobytes()


def _gguf_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _gguf_kv(key: str, value) -> bytes:
    if isinstance(value, str):
        return _gguf_str(key) + struct.pack("<I", 8) + _gguf_str(value)
    if isinstance(value, float):
        return _gguf_str(key) + struct.pack("<If", 6, value)
    return _gguf_str(key) + struct.pack("<II", 4, int(value))


def _gguf_tensor_names(config: dict) -> dict[str, tuple[int, ...]]:
    """llama.cpp's qwen3 (qwen3moe) tensor names -> torch-layout shapes
    [out, in]; an expert bank [n_expert, out, in]."""
    c = config_from_hf_dict(config)
    h, i, v = c.hidden_size, c.intermediate_size, c.vocab_size
    names = {"token_embd.weight": (v, h), "output_norm.weight": (h,)}
    if not c.tie_word_embeddings:
        names["output.weight"] = (v, h)
    for n in range(c.num_hidden_layers):
        if c.layer_spec(n).is_moe:
            e, im = c.num_experts, c.moe_intermediate_size
            ffn = (("ffn_gate_inp", (e, h)), ("ffn_gate_exps", (e, im, h)),
                   ("ffn_up_exps", (e, im, h)),
                   ("ffn_down_exps", (e, h, im)))
        else:
            ffn = (("ffn_gate", (i, h)), ("ffn_up", (i, h)),
                   ("ffn_down", (h, i)))
        for stem, shape in (("attn_norm", (h,)), ("attn_q", (c.size_q, h)),
                            ("attn_k", (c.size_kv, h)),
                            ("attn_v", (c.size_kv, h)),
                            ("attn_output", (h, c.size_q)),
                            ("attn_q_norm", (c.head_dim,)),
                            ("attn_k_norm", (c.head_dim,)),
                            ("ffn_norm", (h,))) + ffn:
            names[f"blk.{n}.{stem}.weight"] = shape
    return names


def write_gguf_model(model_dir: str, config: dict, seed: int = 0,
                     mix: str = "q8_0") -> int:
    """A GGUF v3 file (arch `qwen3`, or `qwen3moe` for a config with
    experts; alignment 32) at the config's widths: every matrix (each
    expert bank too) as seeded raw blocks of Q8_0 (mix "q8_0") or of
    Q4_K, with Q6_K for Q4_K_M_HIGH (mix "q4_k_m"); the norms and the
    routers F32 (norms around 1); the metadata llama.cpp writes for qwen3
    (head_dim as key_length, no vocab_size: the embedding's shape gives
    it; the expert counts and width for qwen3moe). The tokenizer.json is
    the caller's (write_tokenizer). Returns the file's bytes."""
    c = config_from_hf_dict(config)
    rng = np.random.default_rng(seed)
    arch = "qwen3moe" if c.num_experts else "qwen3"
    meta = {"general.architecture": arch, "general.alignment": 32,
            f"{arch}.block_count": c.num_hidden_layers,
            f"{arch}.context_length": c.max_seq_len,
            f"{arch}.embedding_length": c.hidden_size,
            f"{arch}.feed_forward_length": c.intermediate_size,
            f"{arch}.attention.head_count": c.num_attention_heads,
            f"{arch}.attention.head_count_kv": c.num_key_value_heads,
            f"{arch}.attention.key_length": c.head_dim,
            f"{arch}.attention.value_length": c.head_dim,
            f"{arch}.attention.layer_norm_rms_epsilon":
                float(c.rms_norm_eps),
            f"{arch}.rope.freq_base": float(c.rope_theta)}
    if c.num_experts:
        meta.update({f"{arch}.expert_count": c.num_experts,
                     f"{arch}.expert_used_count": c.num_experts_per_tok,
                     f"{arch}.expert_feed_forward_length":
                         c.moe_intermediate_size})
    if c.eos_token_ids:
        meta["tokenizer.ggml.eos_token_id"] = c.eos_token_ids[0]
    infos, blobs, offset = [], [], 0
    for name, shape in _gguf_tensor_names(config).items():
        n = int(np.prod(shape))
        if len(shape) == 1:
            ttype = gguf.GGML_F32
            data = (1.0 + 0.2 * rng.standard_normal(n)).astype(
                np.float32).tobytes()
        elif name.endswith("ffn_gate_inp.weight"):
            ttype = gguf.GGML_F32
            data = (0.02 * rng.standard_normal(n)).astype(
                np.float32).tobytes()
        else:
            stem = name.split(".")[-2]
            ttype = gguf.GGML_Q8_0 if mix == "q8_0" else (
                gguf.GGML_Q6_K if stem in Q4_K_M_HIGH else gguf.GGML_Q4_K)
            data = _gguf_blocks(ttype, n, rng)
        dims = tuple(reversed(shape))
        infos.append(_gguf_str(name) + struct.pack("<I", len(dims))
                     + struct.pack(f"<{len(dims)}Q", *dims)
                     + struct.pack("<IQ", ttype, offset))
        pad = b"\0" * ((-len(data)) % 32)
        blobs += [data, pad]
        offset += len(data) + len(pad)
    kvs = [_gguf_kv(k, v) for k, v in meta.items()]
    head = struct.pack("<IIQQ", gguf.GGUF_MAGIC, 3, len(infos), len(kvs))
    body = head + b"".join(kvs) + b"".join(infos)
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "model.gguf")
    with open(path, "wb") as f:
        f.write(body + b"\0" * ((-len(body)) % 32))
        for blob in blobs:
            f.write(blob)
    return os.path.getsize(path)


def learn_merges(words: dict[tuple[str, ...], int],
                 n_merges: int) -> list[tuple[str, str]]:
    """BPE merges learned from `words` ({symbol tuple: count}): each pass
    merges the most frequent adjacent pair (ties to the smaller pair),
    left to right in every word, until n_merges or no pair occurs
    twice."""
    merges: list[tuple[str, str]] = []
    while len(merges) < n_merges:
        pairs: collections.Counter = collections.Counter()
        for w, c in words.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        if pairs[best] < 2:
            break
        merges.append(best)
        merged: dict[tuple[str, ...], int] = {}
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + c
        words = merged
    return merges


def byte_level_words(text: str) -> dict[tuple[str, ...], int]:
    """`text` split by the GPT-2 pattern, each word as its byte-level
    symbols, counted."""
    b2u = bytes_to_unicode()
    rx = re.compile(translate_regex(GPT2_PATTERN))
    return dict(collections.Counter(
        tuple(b2u[b] for b in w.encode("utf-8")) for w in rx.findall(text)))


def tokenizer_json(specials: dict[str, int], n_merges: int = 400,
                   text: str = CORPUS) -> dict:
    """A byte-level BPE tokenizer.json: ids 0-255 the byte tokens, then
    the learned merges' tokens, then `<|reserved_i|>` fillers up to the
    first special id (added tokens take the ids right after the vocab),
    and `specials` ({content: id}, consecutive ids) as special added
    tokens."""
    vocab = {c: i for i, c in enumerate(
        bytes_to_unicode()[b] for b in range(256))}
    merges = learn_merges(byte_level_words(text), n_merges)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    ids = sorted(specials.values())
    if ids != list(range(ids[0], ids[0] + len(ids))) or ids[0] < len(vocab):
        raise ValueError(f"special ids {ids} must be consecutive and past "
                         f"the {len(vocab)} byte and merged tokens")
    for i in range(len(vocab), ids[0]):
        vocab[f"<|reserved_{i}|>"] = i
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": False, "use_regex": True}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for t, i in sorted(specials.items(), key=lambda x: x[1])],
        "normalizer": None, "pre_tokenizer": byte_level,
        "post_processor": byte_level, "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [[a, b] for a, b in merges]},
    }


def write_tokenizer(model_dir: str, specials: dict[str, int],
                    eos_token: str = "<|im_end|>",
                    chat_template: str = CHATML_TEMPLATE,
                    n_merges: int = 400) -> None:
    """tokenizer.json (tokenizer_json) and a tokenizer_config.json with
    the chat template and the EOS token."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(tokenizer_json(specials, n_merges), f, ensure_ascii=False)
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w",
              encoding="utf-8") as f:
        json.dump({"chat_template": chat_template, "eos_token": eos_token,
                   "bos_token": None}, f, ensure_ascii=False, indent=1)


# -- Gemma's tokenizer style ---------------------------------------------------

# Gemma's special tokens at Gemma's ids; the ids between them are fillers
GEMMA_SPECIALS = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "<unk>": 3,
                  "<start_of_turn>": 105, "<end_of_turn>": 106}
GEMMA_SPACE = "\u2581"   # "▁", SentencePiece's word boundary

# Gemma's chat template in its shape: the BOS written by the template, a
# system message folded into the first user turn, the assistant's turns
# as "model", alternation enforced
GEMMA_TEMPLATE = (
    "{{ bos_token }}"
    "{%- if messages[0]['role'] == 'system' -%}"
    "{%- set first_user_prefix = messages[0]['content'] + '\\n\\n' -%}"
    "{%- set loop_messages = messages[1:] -%}"
    "{%- else -%}"
    "{%- set first_user_prefix = '' -%}"
    "{%- set loop_messages = messages -%}"
    "{%- endif -%}"
    "{%- for message in loop_messages -%}"
    "{%- if (message['role'] == 'user') != (loop.index0 % 2 == 0) -%}"
    "{{ raise_exception('Conversation roles must alternate "
    "user/assistant/user/assistant/...') }}"
    "{%- endif -%}"
    "{%- if message['role'] == 'assistant' -%}"
    "{%- set role = 'model' -%}"
    "{%- else -%}"
    "{%- set role = message['role'] -%}"
    "{%- endif -%}"
    "{{ '<start_of_turn>' + role + '\\n' + (first_user_prefix if loop.first "
    "else '') }}"
    "{{ message['content'] | trim }}"
    "{{ '<end_of_turn>\\n' }}"
    "{%- endfor -%}"
    "{%- if add_generation_prompt -%}"
    "{{ '<start_of_turn>model\\n' }}"
    "{%- endif -%}")


def gemma_tokenizer_json(vocab_size: int = 262144, n_merges: int = 400,
                         text: str = CORPUS) -> dict:
    """A tokenizer.json in Gemma's style: GEMMA_SPECIALS (in the vocab and
    as special added tokens), `<unused_i>` fillers between them, the 256
    byte tokens <0x00>..<0xFF>, the text's characters (spaces as "▁"),
    the learned merges' tokens, then fillers up to vocab_size."""
    top = max(GEMMA_SPECIALS.values())
    by_id = {i: t for t, i in GEMMA_SPECIALS.items()}
    vocab = {by_id.get(i, f"<unused{i}>"): i for i in range(top + 1)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    norm = text.replace(" ", GEMMA_SPACE)
    for ch in sorted(set(norm)):
        vocab.setdefault(ch, len(vocab))
    # no pre-tokenizer: the whole text is one word
    merges = learn_merges({tuple(norm): 1}, n_merges)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    if len(vocab) > vocab_size:
        raise ValueError(f"{len(vocab)} pieces exceed vocab_size "
                         f"{vocab_size}")
    for i in range(len(vocab), vocab_size):
        vocab[f"<unused{i}>"] = i
    bos = GEMMA_SPECIALS["<bos>"]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for t, i in sorted(GEMMA_SPECIALS.items(), key=lambda x: x[1])],
        "normalizer": {"type": "Replace", "pattern": {"String": " "},
                       "content": GEMMA_SPACE},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<bos>": {"id": "<bos>", "ids": [bos],
                                         "tokens": ["<bos>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": GEMMA_SPACE},
             "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [[a, b] for a, b in merges]},
    }


def write_gemma_tokenizer(model_dir: str, vocab_size: int = 262144,
                          n_merges: int = 400) -> None:
    """tokenizer.json (gemma_tokenizer_json) and a tokenizer_config.json
    with GEMMA_TEMPLATE, <bos> and <eos>."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(gemma_tokenizer_json(vocab_size, n_merges), f,
                  ensure_ascii=False)
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w",
              encoding="utf-8") as f:
        json.dump({"chat_template": GEMMA_TEMPLATE, "bos_token": "<bos>",
                   "eos_token": "<eos>", "pad_token": "<pad>",
                   "unk_token": "<unk>",
                   "tokenizer_class": "PreTrainedTokenizerFast"},
                  f, ensure_ascii=False, indent=1)
