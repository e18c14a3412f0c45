"""GGUF (llama.cpp) checkpoints (counterpart of cake_tpu/utils/gguf.py:
GgufReader, the twelve block dequantizers, gguf_to_hf_name,
GGUF_NAME_OVERRIDES, MOE_BANK_STEMS, GGUF_ARCH_TO_HF, gguf_config_dict,
GgufStorage).

A GGUF file (v2 or v3) is a header, metadata key/values, tensor infos
and the tensor data at `general.alignment`. Supported tensor types:
F32, F16, BF16, Q4_0, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K,
which cover the llama.cpp quant mixes of common uploads (Q4_K_M, Q5_K_M,
Q3_K_M, Q2_K, the Q5_0/Q5_1 legacy). Each dequantizer follows ggml's
public block layout (ggml-common.h / dequantize_row_*), vectorized over
blocks in torch on the device the weight loads to, the reference's numpy
arithmetic step for step (the tests hold every one to the reference bit
for bit; the smoke holds a card's load to the CPU's).

`GgufStorage` is a storage the loader reads as it reads safetensors:
HF names in, tensors out (`read(name, device, dtype)`: the raw bytes
copied to the device, dequantized there to float32, or kept as stored
for F32 / F16 / BF16, then cast to dtype). It undoes the (1 + w) offset that llama.cpp's
gemma converter bakes into every norm, and exposes a stacked MoE bank
(`blk.N.ffn_*_exps`) as one virtual tensor per expert. Names follow
llama.cpp's tensor tables; `attn_q` / `attn_k` are read as stored (the
reference does not undo the converter's RoPE permutation of llama-arch
checkpoints, and the port keeps its behaviour: ROADMAP section 3).
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import torch

GGUF_MAGIC = 0x46554747   # "GGUF" little-endian

# metadata value type tags
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, \
    _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

# tensor dtype tags (ggml_type)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q5_0, GGML_Q5_1, GGML_Q8_0 = 2, 6, 7, 8
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 10, 11, 12, 13, 14
GGML_BF16 = 30

QK_K = 256

# ggml type -> (values per block, bytes per block)
BLOCKS = {GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
          GGML_Q4_0: (32, 18), GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24),
          GGML_Q8_0: (32, 34), GGML_Q2_K: (QK_K, 84),
          GGML_Q3_K: (QK_K, 110), GGML_Q4_K: (QK_K, 144),
          GGML_Q5_K: (QK_K, 176), GGML_Q6_K: (QK_K, 210)}


@dataclass(frozen=True)
class GgufTensor:
    name: str
    dims: tuple[int, ...]    # ggml order: dims[0] is innermost (in_features)
    ggml_type: int
    offset: int              # relative to data section


class GgufReader:
    def __init__(self, path: str):
        self.path = path
        self.metadata: dict = {}
        self.tensors: dict[str, GgufTensor] = {}
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8 or struct.unpack("<I", head[:4])[0] \
                    != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            version = struct.unpack("<I", head[4:])[0]
            if version < 2:
                raise ValueError(f"GGUF version {version} unsupported")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = self._read_str(f)
                vtype = struct.unpack("<I", f.read(4))[0]
                self.metadata[key] = self._read_value(f, vtype)
            for _ in range(n_tensors):
                name = self._read_str(f)
                n_dims = struct.unpack("<I", f.read(4))[0]
                dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                ttype, offset = struct.unpack("<IQ", f.read(12))
                self.tensors[name] = GgufTensor(name, dims, ttype, offset)
            align = self.metadata.get("general.alignment", 32)
            pos = f.tell()
            self.data_start = (pos + align - 1) // align * align

    @staticmethod
    def _read_str(f) -> str:
        n = struct.unpack("<Q", f.read(8))[0]
        return f.read(n).decode("utf-8", errors="replace")

    def _read_value(self, f, vtype):
        scalars = {_T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
                   _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
                   _T_I64: "<q", _T_F64: "<d"}
        if vtype in scalars:
            fmt = scalars[vtype]
            return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
        if vtype == _T_BOOL:
            return bool(f.read(1)[0])
        if vtype == _T_STR:
            return self._read_str(f)
        if vtype == _T_ARR:
            etype, n = struct.unpack("<IQ", f.read(12))
            return [self._read_value(f, etype) for _ in range(n)]
        raise ValueError(f"unknown GGUF metadata type {vtype}")

    # -- tensor data ------------------------------------------------------

    def _raw(self, t: GgufTensor, nbytes: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(self.data_start + t.offset)
            raw = f.read(nbytes)
        if len(raw) != nbytes:
            raise ValueError(f"{self.path}: truncated: tensor {t.name} "
                             f"has {len(raw)} of {nbytes} bytes")
        return raw

    def read_tensor(self, name: str, device="cpu") -> torch.Tensor:
        """The tensor in torch layout [out, in] on `device`: float32 for
        a quantized type, as stored for F32, F16 and BF16. The raw bytes
        are copied to the device and dequantized there."""
        t = self.tensors[name]
        n = math.prod(t.dims)
        if t.ggml_type not in BLOCKS:
            raise NotImplementedError(f"ggml type {t.ggml_type} for {name}")
        per, nbytes = BLOCKS[t.ggml_type]
        raw = torch.frombuffer(bytearray(self._raw(t, n // per * nbytes)),
                               dtype=torch.uint8).to(device)
        stored = {GGML_F32: torch.float32, GGML_F16: torch.float16,
                  GGML_BF16: torch.bfloat16}.get(t.ggml_type)
        data = raw.view(stored) if stored is not None else \
            DEQUANT[t.ggml_type](raw, n)
        return data.reshape(tuple(reversed(t.dims)))


# -- block dequantizers (vectorized over blocks, on the load's device) ------
#
# Each takes the raw blocks as a uint8 tensor [n_blocks * block bytes] on
# the device where the weight is wanted and returns float32 [n]: the
# reference's numpy arithmetic op for op (every product and difference
# rounded on its own, in its order), so the same bits on the CPU and on a
# card.


def _blocks(raw: torch.Tensor, nbytes: int) -> torch.Tensor:
    return raw.reshape(-1, nbytes)


def _f16(b: torch.Tensor) -> torch.Tensor:
    """Two bytes per row as a float16, to float32: [nb, 1]."""
    return b.contiguous().view(torch.float16).float()


def _i32(b: torch.Tensor) -> torch.Tensor:
    """Bytes as little-endian 32-bit words (int32: an arithmetic shift
    keeps every masked bit)."""
    return b.contiguous().view(torch.int32)


def _nibble_halves(qs: torch.Tensor, qh: torch.Tensor) -> tuple:
    """Q5_0 / Q5_1: element j takes qh bit j, element j+16 bit j+16."""
    j = torch.arange(16, dtype=torch.int32, device=qs.device)
    hlo = ((qh >> j) & 1) << 4                                  # [nb,16]
    hhi = ((qh >> (j + 16)) & 1) << 4
    q = qs.int()
    return (q & 0xF) | hlo, (q >> 4) | hhi


def dequant_q4_0(raw: torch.Tensor, n: int) -> torch.Tensor:
    """Block = f16 scale + 32x4bit; w = d*(q-8)."""
    b = _blocks(raw, 18)
    d = _f16(b[:, :2])
    qs = b[:, 2:]
    q = torch.cat([qs & 0xF, qs >> 4], dim=1).float() - 8.0
    return (q * d).reshape(-1)


def dequant_q5_0(raw: torch.Tensor, n: int) -> torch.Tensor:
    """Block = f16 scale + u32 high-bit mask + 32x4bit; w = d*(q5-16)."""
    b = _blocks(raw, 22)
    d = _f16(b[:, :2])
    lo, hi = _nibble_halves(b[:, 6:], _i32(b[:, 2:6]))
    q = torch.cat([lo, hi], dim=1).float() - 16.0
    return (q * d).reshape(-1)


def dequant_q5_1(raw: torch.Tensor, n: int) -> torch.Tensor:
    """Block = f16 scale + f16 min + u32 high bits + 32x4bit; w = d*q5 + m."""
    b = _blocks(raw, 24)
    d, m = _f16(b[:, 0:2]), _f16(b[:, 2:4])
    lo, hi = _nibble_halves(b[:, 8:], _i32(b[:, 4:8]))
    q = torch.cat([lo, hi], dim=1).float()
    return (q * d + m).reshape(-1)


def dequant_q8_0(raw: torch.Tensor, n: int) -> torch.Tensor:
    b = _blocks(raw, 34)
    d = _f16(b[:, :2])
    q = b[:, 2:].view(torch.int8).float()
    return (q * d).reshape(-1)


def _shifts(k: int, device) -> torch.Tensor:
    return (torch.arange(k, dtype=torch.int32, device=device) * 2
            )[None, None, :, None]


def _pairs(scales: torch.Tensor, nb: int) -> torch.Tensor:
    """16 per-16 scales as [nb, 2, 4, 32]: element l of step (h, s) takes
    scale 8h + 2s + l // 16."""
    idx = torch.arange(32, device=scales.device) // 16
    return scales.reshape(nb, 2, 4, 2)[..., idx]


def dequant_q2_k(raw: torch.Tensor, n: int) -> torch.Tensor:
    """Super-block 256 = 16B scales (4-bit sc|min) + 64B 2-bit qs + d +
    dmin; w = d*(sc&0xF)*q - dmin*(sc>>4), 16 groups of 16: two 128-halves,
    4 shift steps of 2 bits, two 16-groups per step."""
    b = _blocks(raw, 84)
    nb = b.shape[0]
    qs = b[:, 16:80].int().reshape(nb, 2, 1, 32)
    d, dmin = _f16(b[:, 80:82]), _f16(b[:, 82:84])
    q = ((qs >> _shifts(4, b.device)) & 3).float()               # [nb,2,4,32]
    sel = _pairs(b[:, :16], nb)
    dl = d[:, :, None, None] * (sel & 0xF).float()
    ml = dmin[:, :, None, None] * (sel >> 4).float()
    return (dl * q - ml).reshape(-1)


def dequant_q3_k(raw: torch.Tensor, n: int) -> torch.Tensor:
    """Super-block 256 = 32B hmask + 64B 2-bit qs + 12B 6-bit scales + d;
    w = d*(sc-32)*(q2 - (hmask bit ? 0 : 4)), the scales unpacked by the
    kmask1/kmask2 word shuffle of ggml's dequantize_row_q3_K."""
    b = _blocks(raw, 110)
    nb = b.shape[0]
    hm = b[:, :32].int()
    qs = b[:, 32:96].int().reshape(nb, 2, 1, 32)
    a = _i32(b[:, 96:108])                                        # [nb,3]
    d = _f16(b[:, 108:110])
    k1, k2 = 0x03030303, 0x0F0F0F0F
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    words = torch.stack([
        (a0 & k2) | (((a2 >> 0) & k1) << 4),
        (a1 & k2) | (((a2 >> 2) & k1) << 4),
        ((a0 >> 4) & k2) | (((a2 >> 4) & k1) << 4),
        ((a1 >> 4) & k2) | (((a2 >> 6) & k1) << 4)], dim=1)     # [nb,4]
    sc = words.contiguous().view(torch.int8).float() - 32.0      # [nb,16]
    q2 = ((qs >> _shifts(4, b.device)) & 3).float()              # [nb,2,4,32]
    dev = b.device
    mbit = (torch.arange(2, device=dev)[:, None] * 4
            + torch.arange(4, device=dev)[None, :]).int()
    hbit = (hm[:, None, None, :] >> mbit[None, :, :, None]) & 1  # [nb,2,4,32]
    q = q2 - 4.0 * (1 - hbit).float()
    sel = _pairs(sc, nb)
    return (d[:, :, None, None] * sel * q).reshape(-1)


def _k4_scale_min(s: torch.Tensor):
    """Unpack the 12-byte 6-bit (scale, min) table of Q4_K / Q5_K ->
    sc, m float32 [nb, 8]."""
    s = s.int()
    sc = torch.cat([s[:, 0:4] & 63,
                    (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    m = torch.cat([s[:, 4:8] & 63,
                   (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    return sc.float(), m.float()


def dequant_q4_k(raw: torch.Tensor, n: int) -> torch.Tensor:
    """Super-block 256 = d f16 + dmin f16 + 12B scales + 128B qs;
    w = d*sc*q - dmin*m, 8 groups of 32 (low nibbles then high per 64)."""
    b = _blocks(raw, 144)
    nb = b.shape[0]
    d, dmin = _f16(b[:, 0:2]), _f16(b[:, 2:4])
    sc, mins = _k4_scale_min(b[:, 4:16])                          # [nb,8]
    qs4 = b[:, 16:].reshape(nb, 4, 32)
    q = torch.stack([(qs4 & 0xF).float(), (qs4 >> 4).float()],
                    dim=2).reshape(nb, 8, 32)
    scale = (d * sc)[:, :, None]
    minv = (dmin * mins)[:, :, None]
    return (scale * q - minv).reshape(-1)


def dequant_q5_k(raw: torch.Tensor, n: int) -> torch.Tensor:
    """Super-block 256 = d f16 + dmin f16 + 12B scales + 32B qh + 128B
    qs; w = d*sc*(q4 + 16*hbit) - dmin*m, 8 groups of 32 (low nibbles
    then high per 64, group g taking qh bit g). The reference's module
    names this dequantizer without defining it (ROADMAP section 3)."""
    b = _blocks(raw, 176)
    nb = b.shape[0]
    d, dmin = _f16(b[:, 0:2]), _f16(b[:, 2:4])
    sc, mins = _k4_scale_min(b[:, 4:16])                          # [nb,8]
    qh = b[:, 16:48].int()[:, None, :]                            # [nb,1,32]
    qs4 = b[:, 48:176].int().reshape(nb, 4, 32)
    bit = (torch.arange(4, dtype=torch.int32, device=b.device) * 2
           )[None, :, None]
    lo = (qs4 & 0xF) | (((qh >> bit) & 1) << 4)               # groups 0,2,4,6
    hi = (qs4 >> 4) | (((qh >> (bit + 1)) & 1) << 4)          # groups 1,3,5,7
    q = torch.stack([lo, hi], dim=2).reshape(nb, 8, 32).float()
    scale = (d * sc)[:, :, None]
    minv = (dmin * mins)[:, :, None]
    return (scale * q - minv).reshape(-1)


def dequant_q6_k(raw: torch.Tensor, n: int) -> torch.Tensor:
    """Super-block 256 = 128B ql + 64B qh + 16B scales (i8) + d f16;
    w = d * sc * (q - 32) with ggml's half-block interleave."""
    b = _blocks(raw, 210)
    nb = b.shape[0]
    ql = b[:, 0:128].int().reshape(nb, 2, 64)
    qh = b[:, 128:192].int().reshape(nb, 2, 32)
    sc = b[:, 192:208].view(torch.int8).float().reshape(nb, 2, 8)
    d = _f16(b[:, 208:210])
    l0, l32 = ql[:, :, 0:32], ql[:, :, 32:64]
    q1 = (l0 & 0xF) | (((qh >> 0) & 3) << 4)
    q2 = (l32 & 0xF) | (((qh >> 2) & 3) << 4)
    q3 = (l0 >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (l32 >> 4) | (((qh >> 6) & 3) << 4)
    # y[l+0]:sc[l/16], y[l+32]:sc[2+l/16], y[l+64]:sc[4+l/16], y[l+96]:sc[6+l/16]
    q = torch.stack([q1, q2, q3, q4], dim=2).float() - 32.0       # [nb,2,4,32]
    idx = torch.arange(32, device=b.device) // 16
    sel = torch.stack([sc[:, :, 0 + idx], sc[:, :, 2 + idx],
                       sc[:, :, 4 + idx], sc[:, :, 6 + idx]], dim=2)
    return (d[:, :, None, None] * sel * q).reshape(-1)


# -- name + config mapping --------------------------------------------------

GGUF_NAME_MAP = {
    "attn_q": "self_attn.q_proj", "attn_k": "self_attn.k_proj",
    "attn_v": "self_attn.v_proj", "attn_output": "self_attn.o_proj",
    "attn_q_norm": "self_attn.q_norm", "attn_k_norm": "self_attn.k_norm",
    "ffn_gate": "mlp.gate_proj", "ffn_up": "mlp.up_proj",
    "ffn_down": "mlp.down_proj",
    "attn_norm": "input_layernorm", "ffn_norm": "post_attention_layernorm",
    "ffn_gate_inp": "mlp.gate",               # MoE router
}

# per-architecture llama.cpp tensor-name overrides: gemma-family sandwich
# norms repurpose ffn_norm as the PRE-feedforward norm, olmo2 is post-norm
# only (llama.cpp LLM_ARCH_GEMMA3 / LLM_ARCH_OLMO2 tensor tables)
_GEMMA_NORMS = {
    "ffn_norm": "pre_feedforward_layernorm",
    "post_attention_norm": "post_attention_layernorm",
    "post_ffw_norm": "post_feedforward_layernorm",
}
GGUF_NAME_OVERRIDES: dict[str, dict[str, str]] = {
    "gemma2": _GEMMA_NORMS,
    "gemma3": _GEMMA_NORMS,
    "olmo2": {"post_attention_norm": "post_attention_layernorm",
              "post_ffw_norm": "post_feedforward_layernorm"},
}

# expert banks: blk.N.ffn_gate_exps.weight holds [n_expert, inter, hidden]
MOE_BANK_STEMS = {
    "ffn_gate_exps": "gate_proj", "ffn_up_exps": "up_proj",
    "ffn_down_exps": "down_proj",
}


def gguf_to_hf_name(name: str, prefix: str = "model",
                    arch: str = "llama") -> str | None:
    """blk.N.attn_q.weight -> model.layers.N.self_attn.q_proj.weight
    (ref: gguf.rs name mapping, plus arch-aware norm/MoE extensions)."""
    if name == "token_embd.weight":
        return f"{prefix}.embed_tokens.weight"
    if name == "output_norm.weight":
        return f"{prefix}.norm.weight"
    if name == "output.weight":
        return "lm_head.weight"
    if name.startswith("blk."):
        _, layer, rest = name.split(".", 2)
        stem, suffix = rest.rsplit(".", 1)
        mapped = GGUF_NAME_OVERRIDES.get(arch, {}).get(stem) \
            or GGUF_NAME_MAP.get(stem)
        if mapped:
            return f"{prefix}.layers.{layer}.{mapped}.{suffix}"
    return None


# Architectures whose tensor set the name maps cover. Qwen3.5 GDN hybrids
# would need linear-attention mappings: rejected with a clear error
# instead of mis-wiring.
GGUF_ARCH_TO_HF = {
    "llama": "LlamaForCausalLM", "qwen2": "Qwen2ForCausalLM",
    "qwen3": "Qwen3ForCausalLM", "qwen3moe": "Qwen3MoeForCausalLM",
    "phi3": "Phi3ForCausalLM", "mistral": "MistralForCausalLM",
    "falcon": "FalconForCausalLM",
    # gemma2 deliberately absent: no QK norms, 1:1 interleave, logit
    # softcapping — the gemma3 adapter would mis-model it
    "gemma3": "Gemma3ForCausalLM",
    "olmo2": "Olmo2ForCausalLM",
}


def gguf_config_dict(reader: GgufReader) -> dict:
    """Build an HF-style config dict from GGUF metadata
    (ref: gguf.rs arch/config extraction)."""
    md = reader.metadata
    arch = md.get("general.architecture", "llama")
    if arch not in GGUF_ARCH_TO_HF:
        raise NotImplementedError(
            f"GGUF architecture {arch!r} not yet supported (needs name-map "
            f"entries beyond the llama layout)")

    def g(key, default=None):
        return md.get(f"{arch}.{key}", default)

    heads = int(g("attention.head_count", 32))
    hidden = int(g("embedding_length", 4096))
    vocab = int(g("vocab_size", 0))
    if not vocab and "token_embd.weight" in reader.tensors:
        vocab = reader.tensors["token_embd.weight"].dims[1]
    d = {
        "architectures": [GGUF_ARCH_TO_HF.get(arch, "LlamaForCausalLM")],
        "hidden_size": hidden,
        "intermediate_size": int(g("feed_forward_length", 11008)),
        "num_hidden_layers": int(g("block_count", 32)),
        "num_attention_heads": heads,
        "num_key_value_heads": int(g("attention.head_count_kv", heads)),
        "vocab_size": int(vocab),
        "rms_norm_eps": float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        "rope_theta": float(g("rope.freq_base", 10000.0)),
        "max_position_embeddings": int(g("context_length", 4096)),
        "tie_word_embeddings": "output.weight" not in reader.tensors,
    }
    if g("attention.key_length"):
        d["head_dim"] = int(g("attention.key_length"))
    if g("attention.sliding_window"):
        d["sliding_window"] = int(g("attention.sliding_window"))
    if arch == "qwen3moe":
        d["num_experts"] = int(g("expert_count", 128))
        d["num_experts_per_tok"] = int(g("expert_used_count", 8))
        d["moe_intermediate_size"] = int(g("expert_feed_forward_length",
                                           d["intermediate_size"]))
        d["norm_topk_prob"] = True
    if arch in ("gemma2", "gemma3"):
        # llama.cpp hardcodes the 5-local:1-global interleave; the adapter's
        # sliding_window_pattern=6 default reproduces it
        d.setdefault("sliding_window", int(g("attention.sliding_window",
                                             1024)))
    eos = md.get("tokenizer.ggml.eos_token_id")
    if eos is not None:
        d["eos_token_id"] = int(eos)
    bos = md.get("tokenizer.ggml.bos_token_id")
    if bos is not None:
        d["bos_token_id"] = int(bos)
    return d


# the dequantizer of each quantized ggml type
DEQUANT = {GGML_Q4_0: dequant_q4_0, GGML_Q5_0: dequant_q5_0,
           GGML_Q5_1: dequant_q5_1, GGML_Q8_0: dequant_q8_0,
           GGML_Q2_K: dequant_q2_k, GGML_Q3_K: dequant_q3_k,
           GGML_Q4_K: dequant_q4_k, GGML_Q5_K: dequant_q5_k,
           GGML_Q6_K: dequant_q6_k}


class GgufStorage:
    """A storage over a GGUF file for the loader: HF names in, tensors
    out. MoE expert banks (blk.N.ffn_*_exps, [n_expert, inter, hidden])
    are exposed as virtual per-expert names; a small cache keeps the
    current layer's banks while the loader walks its experts."""

    def __init__(self, path: str, prefix: str = "model"):
        self.reader = GgufReader(path)
        arch = self.reader.metadata.get("general.architecture", "llama")
        # llama.cpp's gemma converter bakes the (1+w) offset into every
        # *norm.weight; the loader applies (1+w) itself for
        # residual_rms_norm configs, so the offset is undone here
        self._norm_offset = -1.0 if arch.startswith("gemma") else 0.0
        self._map: dict[str, str] = {}
        self._experts: dict[str, tuple[str, int]] = {}
        self._bank_cache: dict[tuple, torch.Tensor] = {}
        for gname, t in self.reader.tensors.items():
            hf = gguf_to_hf_name(gname, prefix, arch)
            if hf:
                self._map[hf] = gname
                continue
            if gname.startswith("blk."):
                _, layer, rest = gname.split(".", 2)
                stem, suffix = rest.rsplit(".", 1)
                proj = MOE_BANK_STEMS.get(stem)
                if proj and suffix == "weight":
                    for e in range(t.dims[-1]):     # outermost ggml dim
                        self._experts[
                            f"{prefix}.layers.{layer}.mlp.experts.{e}."
                            f"{proj}.weight"] = (gname, e)

    def __enter__(self) -> "GgufStorage":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def names(self):
        return list(self._map) + list(self._experts)

    def __contains__(self, name) -> bool:
        return name in self._map or name in self._experts

    def _bank(self, gname: str, device) -> torch.Tensor:
        key = (gname, str(device))
        if key not in self._bank_cache:
            if len(self._bank_cache) >= 3:   # gate/up/down of one layer
                self._bank_cache.pop(next(iter(self._bank_cache)))
            self._bank_cache[key] = self.reader.read_tensor(gname, device)
        return self._bank_cache[key]

    def read(self, name: str, device="cpu",
             dtype: torch.dtype | None = None) -> torch.Tensor:
        """One tensor on `device`, dequantized there, then cast to `dtype`
        when given."""
        if name in self._experts:
            gname, e = self._experts[name]
            t = self._bank(gname, device)[e].clone()
        elif name in self._map:
            t = self.reader.read_tensor(self._map[name], device)
            if self._norm_offset and name.endswith("norm.weight"):
                t = t + self._norm_offset
        else:
            raise KeyError(f"tensor {name} is not in the GGUF file")
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        return t

    def close(self) -> None:
        self._bank_cache.clear()
