"""Text-model configuration (the port's own copy of
cake_tpu/models/common/config.py, dense families only).

`config_from_hf_dict` normalizes an HF config.json dict through a family
adapter into one `ModelConfig`; per-layer behaviour is resolved into
`LayerSpec`s so the decoder block is one generic function driven by data.
The families here are the dense pre-norm SiLU ones (llama, qwen2, qwen3,
mistral, falcon3); MoE, GDN-hybrid, post/sandwich-norm, GELU and
interleaved-SWA families are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ...ops.rope import RopeScaling

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
    window: int | None = None     # sliding-window size when kind == 'swa'


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
    qk_norm: bool = False
    sliding_window: int | None = None
    # the reference's per-layer pattern: True = full attention, False =
    # sliding window (layers past the tuple are full); empty = every layer
    # windowed when sliding_window is set
    global_layers: tuple[bool, ...] = ()

    def layer_spec(self, i: int) -> LayerSpec:
        if self.global_layers:
            if i >= len(self.global_layers) or self.global_layers[i]:
                return LayerSpec(kind="full")
            return LayerSpec(kind="swa", window=self.sliding_window)
        if self.sliding_window is not None:
            return LayerSpec(kind="swa", window=self.sliding_window)
        return LayerSpec(kind="full")

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


ARCH_ADAPTERS = {
    "LlamaForCausalLM": _llama,
    "Qwen2ForCausalLM": _qwen2,
    "Qwen3ForCausalLM": _qwen3,
    "MistralForCausalLM": _mistral,
    "FalconForCausalLM": _falcon3,
}

FAMILY_ADAPTERS = {
    "llama": _llama, "llama3": _llama, "qwen2": _qwen2, "qwen3": _qwen3,
    "mistral": _mistral, "falcon3": _falcon3,
}


def config_from_hf_dict(d: dict, arch: str | None = None) -> ModelConfig:
    """Unlike the reference, an unknown architecture raises: the families
    the port has not taken over yet must not silently run as llama."""
    archs = d.get("architectures") or []
    name = arch or (archs[0] if archs else "")
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
