"""Text-model configuration (the port's own copy of
cake_tpu/models/common/config.py, dense families only).

`config_from_hf_dict` normalizes an HF config.json dict through a family
adapter into one `ModelConfig`; per-layer behaviour is resolved into
`LayerSpec`s so the decoder block is one generic function driven by data.
The families here are the dense ones: pre-norm (llama, qwen2, qwen3,
mistral, falcon3, phi4 with its pre-fused projections and partial RoPE),
post-norm (olmo2 with QK-norm before the head split, exaone4 with
local/global layers and NoPE global layers) and sandwich-norm (gemma3:
four (1+w) norms per block, GELU-tanh, embeddings scaled by sqrt(hidden),
local layers on their own RoPE table). The MoE and the GDN-hybrid
families raise, naming the ROADMAP item that ports them; an unknown
architecture raises too.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any

from ...ops.rope import RopeScaling

log = logging.getLogger(__name__)

# The repo's flagship shape (Qwen3-0.6B), equal to FLAGSHIP in the JAX
# package's __graft_entry__.py. Served with seeded random weights.
FLAGSHIP_QWEN3_0_6B = dict(
    architectures=["Qwen3ForCausalLM"], vocab_size=151936, hidden_size=1024,
    intermediate_size=3072, num_hidden_layers=28, num_attention_heads=16,
    num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-6,
    rope_theta=1000000.0, max_position_embeddings=4096,
    tie_word_embeddings=True, eos_token_id=151645,
)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Resolved per-layer behaviour, consumed by the generic block."""
    kind: str = "full"            # 'full' | 'swa'
    use_rope: bool = True         # False: EXAONE4's global layers (NoPE)
    local_rope_table: bool = False  # Gemma3's local layers: the tables
                                    # at rope_local_base_freq
    window: int | None = None     # sliding-window size when kind == 'swa'
    norm_style: str = "pre"       # 'pre' | 'post' (OLMo2, EXAONE4) |
                                  # 'sandwich' (Gemma3)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling | None = None
    partial_rotary_factor: float = 1.0
    max_seq_len: int = 4096
    bos_token_id: int | None = None
    eos_token_ids: tuple[int, ...] = ()
    tie_word_embeddings: bool = False
    qkv_bias: bool = False
    fused_qkv: bool = False        # Phi-3/4 checkpoints: one qkv_proj
                                   # and one gate_up_proj
    qk_norm: bool = False
    qk_norm_pre_reshape: bool = False  # OLMo2: norm full q/k before heads
    residual_rms_norm: bool = False    # checkpoints store norms as w, the
                                       # model uses 1 + w (Gemma3)
    norm_style: str = "pre"
    sliding_window: int | None = None
    # the reference's per-layer pattern: True = full attention, False =
    # sliding window (layers past the tuple are full); empty = every layer
    # windowed when sliding_window is set
    global_layers: tuple[bool, ...] = ()
    global_rope: bool = True       # False: global layers skip RoPE (EXAONE4)
    # Gemma3's local layers apply RoPE at rope_local_base_freq, never
    # scaled; its global layers use rope_theta and rope_scaling (the
    # reference follows HF here)
    local_rope_theta: float | None = None
    hidden_act: str = "silu"       # 'silu' | 'gelu_tanh' (Gemma3)
    embed_scale: float | None = None   # Gemma3: sqrt(hidden_size)
    attn_scale: float | None = None    # None: head_dim ** -0.5

    def layer_spec(self, i: int) -> LayerSpec:
        """The reference's rules (its linear and MoE kinds aside)."""
        if self.global_layers:
            if i >= len(self.global_layers) or self.global_layers[i]:
                return LayerSpec(kind="full", use_rope=self.global_rope,
                                 norm_style=self.norm_style)
            return LayerSpec(
                kind="swa", window=self.sliding_window,
                local_rope_table=self.local_rope_theta is not None,
                norm_style=self.norm_style)
        if self.sliding_window is not None:
            return LayerSpec(kind="swa", window=self.sliding_window,
                             norm_style=self.norm_style)
        return LayerSpec(kind="full", norm_style=self.norm_style)

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        return tuple(self.layer_spec(i) for i in range(self.num_hidden_layers))

    @property
    def size_q(self) -> int:
        return self.head_dim * self.num_attention_heads

    @property
    def size_kv(self) -> int:
        return self.head_dim * self.num_key_value_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    def is_eos(self, token_id: int) -> bool:
        return token_id in self.eos_token_ids


def _eos_tuple(v) -> tuple[int, ...]:
    if v is None:
        return ()
    if isinstance(v, int):
        return (v,)
    return tuple(int(x) for x in v)


def _rope_scaling(d: dict | None) -> RopeScaling | None:
    if not d:
        return None
    return RopeScaling(
        factor=float(d.get("factor", 1.0)),
        high_freq_factor=float(d.get("high_freq_factor", 4.0)),
        low_freq_factor=float(d.get("low_freq_factor", 1.0)),
        original_max_position_embeddings=int(
            d.get("original_max_position_embeddings", 8192)),
        rope_type=d.get("rope_type") or d.get("type"),
    )


def _base(d: dict, arch: str, **over) -> dict:
    heads = int(d["num_attention_heads"])
    hidden = int(d["hidden_size"])
    out = dict(
        arch=arch,
        vocab_size=int(d["vocab_size"]),
        hidden_size=hidden,
        intermediate_size=int(d["intermediate_size"]),
        num_hidden_layers=int(d["num_hidden_layers"]),
        num_attention_heads=heads,
        num_key_value_heads=int(d.get("num_key_value_heads") or heads),
        head_dim=int(d.get("head_dim") or hidden // heads),
        rms_norm_eps=float(d.get("rms_norm_eps", 1e-5)),
        rope_theta=float(d.get("rope_theta", 10000.0)),
        rope_scaling=_rope_scaling(d.get("rope_scaling")),
        max_seq_len=int(d.get("max_position_embeddings", 4096)),
        bos_token_id=d.get("bos_token_id"),
        eos_token_ids=_eos_tuple(d.get("eos_token_id")),
        tie_word_embeddings=bool(d.get("tie_word_embeddings", False)),
    )
    out.update(over)
    return out


def _llama(d):
    return ModelConfig(**_base(d, "llama"))


def _qwen2(d):
    return ModelConfig(**_base(d, "qwen2", qkv_bias=True))


def _qwen3(d):
    return ModelConfig(**_base(d, "qwen3", qk_norm=True))


def _mistral(d):
    return ModelConfig(**_base(d, "mistral",
                               sliding_window=d.get("sliding_window")))


def _falcon3(d):
    return ModelConfig(**_base(d, "falcon3"))


def _phi4(d):
    rs = d.get("rope_scaling") or {}
    if (rs.get("rope_type") or rs.get("type")) == "longrope":
        # the reference reads no `factor` from a longrope entry and so
        # builds unscaled tables; the port does the same and says so
        log.warning("rope_type 'longrope' not implemented; using unscaled "
                    "RoPE")
    return ModelConfig(**_base(
        d, "phi4", fused_qkv=True,
        partial_rotary_factor=float(d.get("partial_rotary_factor", 1.0)),
    ))


def _gemma3(d):
    """Gemma3: local (sliding window) and global layers, every
    `sliding_window_pattern`-th global, or as the explicit
    `sliding_window_attention_schedule` says; sandwich norms with (1+w)
    weights, QK-norm, GELU-tanh, embeddings scaled by sqrt(hidden), tied
    head, attention scale from query_pre_attn_scalar."""
    n = int(d["num_hidden_layers"])
    pattern = int(d.get("sliding_window_pattern", 6))
    sched = d.get("sliding_window_attention_schedule") or []
    if sched:
        global_layers = tuple(bool(x) for x in sched[:n])
    else:
        global_layers = tuple((i + 1) % pattern == 0 for i in range(n))
    return ModelConfig(**_base(
        d, "gemma3",
        rope_theta=float(d.get("rope_theta", 10000.0)),
        qk_norm=True, residual_rms_norm=True, norm_style="sandwich",
        sliding_window=int(d.get("sliding_window", 1024)),
        global_layers=global_layers,
        local_rope_theta=float(d.get("rope_local_base_freq", 10000.0)),
        hidden_act="gelu_tanh",
        embed_scale=float(d["hidden_size"]) ** 0.5,
        tie_word_embeddings=True,
        attn_scale=(float(d["query_pre_attn_scalar"]) ** -0.5
                    if d.get("query_pre_attn_scalar") else None),
    ))


def _olmo2(d):
    return ModelConfig(**_base(
        d, "olmo2", qk_norm=True, qk_norm_pre_reshape=True,
        norm_style="post"))


def _exaone4(d):
    """EXAONE 4.0: local (sliding window, RoPE) and global (full, NoPE)
    layers, QK-norm, post-norm. The pattern is an int period or HF's
    string form ("LLLG": L local, G global)."""
    n = int(d["num_hidden_layers"])
    pattern = (d.get("sliding_window_pattern")
               or d.get("global_layer_period") or 4)
    if isinstance(pattern, str):
        global_layers = tuple(pattern[i % len(pattern)].upper() == "G"
                              for i in range(n))
    else:
        global_layers = tuple((i + 1) % int(pattern) == 0 for i in range(n))
    return ModelConfig(**_base(
        d, "exaone4", qk_norm=True, norm_style="post",
        sliding_window=int(d.get("sliding_window", 4096)),
        global_layers=global_layers, global_rope=False))


ARCH_ADAPTERS = {
    "LlamaForCausalLM": _llama,
    "Qwen2ForCausalLM": _qwen2,
    "Qwen3ForCausalLM": _qwen3,
    "MistralForCausalLM": _mistral,
    "FalconForCausalLM": _falcon3,
    "Phi3ForCausalLM": _phi4,
    "Phi4ForCausalLM": _phi4,
    "OLMo2ForCausalLM": _olmo2,
    "Olmo2ForCausalLM": _olmo2,
    "ExaoneForCausalLM": _exaone4,
    "Exaone4ForCausalLM": _exaone4,
    "Gemma3ForCausalLM": _gemma3,
}

FAMILY_ADAPTERS = {
    "llama": _llama, "llama3": _llama, "qwen2": _qwen2, "qwen3": _qwen3,
    "mistral": _mistral, "falcon3": _falcon3, "phi4": _phi4, "phi3": _phi4,
    "olmo2": _olmo2, "exaone4": _exaone4, "gemma3": _gemma3,
}

# families of the reference the port has not taken over yet -> the ROADMAP
# item that brings them
NOT_PORTED = {
    # Gemma3 4B and larger: a vision tower around the text model, which
    # neither package adapts; its text tower waits for a real config
    "Gemma3ForConditionalGeneration": "module 6 (Gemma3's multimodal "
                                      "checkpoints)",
    "Qwen3MoeForCausalLM": "module 10 (MoE)", "qwen3_moe": "module 10 (MoE)",
    "Qwen3_5ForConditionalGeneration": "module 10 (GDN)",
    "qwen3_5": "module 10 (GDN)",
    "Qwen3_5MoeForConditionalGeneration": "module 10 (GDN and MoE)",
    "qwen3_5_moe": "module 10 (GDN and MoE)",
    "Qwen3NextForCausalLM": "module 10 (GDN and MoE)",
}


def detect_arch(config: dict) -> str:
    """The first `architectures` entry of an HF config dict."""
    archs = config.get("architectures") or []
    return archs[0] if archs else ""


def config_from_hf_dict(d: dict, arch: str | None = None) -> ModelConfig:
    """Unlike the reference, an unknown architecture raises: the families
    the port has not taken over yet must not silently run as llama."""
    name = arch or detect_arch(d)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet: ROADMAP "
            f"{NOT_PORTED[name]}")
    adapter = ARCH_ADAPTERS.get(name) or FAMILY_ADAPTERS.get(name)
    if adapter is None:
        raise ValueError(f"architecture {name!r} is not ported yet")
    return adapter(d)


def tiny_config(arch: str = "llama", **over) -> ModelConfig:
    """Tiny synthetic config for tests (hidden 64, 4 layers, GQA 4/2),
    the same dict the reference's tiny_config builds."""
    d: dict[str, Any] = dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=128,
        eos_token_id=2,
    )
    d.update(over)
    return FAMILY_ADAPTERS[arch](d)
