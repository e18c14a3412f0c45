"""Text-model configuration (the port's own copy of
cake_tpu/models/common/config.py).

`config_from_hf_dict` normalizes an HF config.json dict through a family
adapter into one `ModelConfig`; per-layer behaviour is resolved into
`LayerSpec`s so the decoder block is one generic function driven by data.
The families here are the dense ones: pre-norm (llama, qwen2, qwen3,
mistral, falcon3, phi4 with its pre-fused projections and partial RoPE),
post-norm (olmo2 with QK-norm before the head split, exaone4 with
local/global layers and NoPE global layers) and sandwich-norm (gemma3:
four (1+w) norms per block, GELU-tanh, embeddings scaled by sqrt(hidden),
local layers on their own RoPE table), the Mixture-of-Experts family
(qwen3_moe: top-k routed experts, softmax router) and the Gated DeltaNet
hybrids (qwen3_5, qwen3_5_moe, Qwen3-Next: linear-attention layers as
`layer_types` lists them, full-attention layers with a sigmoid output
gate, (1+w) norms, and for the MoE forms a sigmoid-gated shared expert).
Gemma3's multimodal checkpoints raise, naming the ROADMAP item that ports
them; an unknown architecture raises too.
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
class LinearAttnConfig:
    """Gated DeltaNet hyperparameters (the reference's LinearAttnConfig)."""
    layer_types: tuple[str, ...] = ()
    conv_kernel_dim: int = 4
    num_key_heads: int = 16
    key_head_dim: int = 128
    num_value_heads: int = 16
    value_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Resolved per-layer behaviour, consumed by the generic block."""
    kind: str = "full"            # 'full' | 'swa' | 'linear'
    use_rope: bool = True         # False: EXAONE4's global layers (NoPE)
    local_rope_table: bool = False  # Gemma3's local layers: the tables
                                    # at rope_local_base_freq
    window: int | None = None     # sliding-window size when kind == 'swa'
    is_moe: bool = False          # routed experts in place of the MLP
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
                                       # model uses 1 + w (Gemma3, Qwen3.5)
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
    model_prefix: str = "model"        # checkpoint tensor-name prefix
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int | None = None
    norm_topk_prob: bool = False
    shared_expert_intermediate_size: int | None = None
    moe_gate_act: str = "softmax"  # the router's gate: 'softmax' | 'sigmoid'
    decoder_sparse_step: int = 1
    mlp_only_layers: tuple[int, ...] = ()
    # Gated DeltaNet linear attention (None: no linear layer)
    linear_attn: LinearAttnConfig | None = None
    attn_output_gate: bool = False  # full-attention layers: q_proj emits a
                                    # per-head [q, gate], sigmoid on output

    def layer_spec(self, i: int) -> LayerSpec:
        """The reference's rules, layer by layer."""
        moe = self._layer_is_moe(i)
        if self.linear_attn is not None and i < len(
                self.linear_attn.layer_types):
            if self.linear_attn.layer_types[i] == "linear_attention":
                return LayerSpec(kind="linear", use_rope=False, is_moe=moe,
                                 norm_style=self.norm_style)
        if self.global_layers:
            if i >= len(self.global_layers) or self.global_layers[i]:
                return LayerSpec(kind="full", use_rope=self.global_rope,
                                 is_moe=moe, norm_style=self.norm_style)
            return LayerSpec(
                kind="swa", window=self.sliding_window,
                local_rope_table=self.local_rope_theta is not None,
                is_moe=moe, norm_style=self.norm_style)
        if self.sliding_window is not None:
            return LayerSpec(kind="swa", window=self.sliding_window,
                             is_moe=moe, norm_style=self.norm_style)
        return LayerSpec(kind="full", is_moe=moe, norm_style=self.norm_style)

    def _layer_is_moe(self, i: int) -> bool:
        if self.num_experts == 0 or i in self.mlp_only_layers:
            return False
        return (i + 1) % max(self.decoder_sparse_step, 1) == 0

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


def _qwen3_moe(d):
    return ModelConfig(**_base(
        d, "qwen3_moe", qk_norm=True,
        num_experts=int(d.get("num_experts", 128)),
        num_experts_per_tok=int(d.get("num_experts_per_tok", 8)),
        moe_intermediate_size=int(d["moe_intermediate_size"]),
        norm_topk_prob=bool(d.get("norm_topk_prob", True)),
        decoder_sparse_step=int(d.get("decoder_sparse_step", 1)),
        mlp_only_layers=tuple(d.get("mlp_only_layers", ()))))


def _qwen3_5_common(d, arch, **over):
    """Qwen3.5 wraps the text fields in text_config (Qwen3-Next does not);
    the linear layers come from an explicit `layer_types` only. As in the
    reference, a config without it has no linear layer: transformers'
    `full_attention_interval` is not read (the port logs it, as it logs
    Phi-4's longrope)."""
    tc = d.get("text_config", d)
    rp = tc.get("rope_parameters") or {}
    rope_theta = float(rp.get("rope_theta", tc.get("rope_theta", 10000.0)))
    partial_rotary = float(rp.get(
        "partial_rotary_factor", tc.get("partial_rotary_factor", 0.25)))
    layer_types = tuple(tc.get("layer_types", ()))
    linear = None
    if layer_types:
        linear = LinearAttnConfig(
            layer_types=layer_types,
            conv_kernel_dim=int(tc.get("linear_conv_kernel_dim", 4)),
            num_key_heads=int(tc.get("linear_num_key_heads", 16)),
            key_head_dim=int(tc.get("linear_key_head_dim", 128)),
            num_value_heads=int(tc.get("linear_num_value_heads", 16)),
            value_head_dim=int(tc.get("linear_value_head_dim", 128)))
    elif tc.get("full_attention_interval"):
        log.warning("full_attention_interval is not read: without "
                    "layer_types every layer is full attention, as the "
                    "reference reads this config")
    base = _base(
        tc, arch, rope_theta=rope_theta,
        partial_rotary_factor=partial_rotary, residual_rms_norm=True,
        model_prefix="model.language_model", linear_attn=linear,
        qk_norm=True,
        attn_output_gate=bool(tc.get("attn_output_gate", True)),
        tie_word_embeddings=bool(d.get("tie_word_embeddings", False)
                                 or tc.get("tie_word_embeddings", False)))
    base.update(over)
    return ModelConfig(**base)


def _qwen3_5(d):
    return _qwen3_5_common(d, "qwen3_5")


def _qwen3_5_moe(d):
    """The router is a softmax, as Qwen3-MoE's; a sigmoid gates only the
    shared expert."""
    tc = d.get("text_config", d)
    return _qwen3_5_common(
        d, "qwen3_5_moe",
        num_experts=int(tc.get("num_experts", 256)),
        num_experts_per_tok=int(tc.get("num_experts_per_tok", 8)),
        moe_intermediate_size=int(tc["moe_intermediate_size"]),
        norm_topk_prob=bool(tc.get("norm_topk_prob", True)),
        shared_expert_intermediate_size=tc.get(
            "shared_expert_intermediate_size"),
        moe_gate_act="softmax",
        decoder_sparse_step=int(tc.get("decoder_sparse_step", 1)),
        mlp_only_layers=tuple(tc.get("mlp_only_layers", ())))


def _qwen3_next(d):
    """Qwen3-Next: Qwen3.5's compute from a flat config, MoE when
    num_experts > 0, its tensors under `model.` where Qwen3.5's are under
    `model.language_model.`."""
    cfg = (_qwen3_5_moe(d) if int(d.get("num_experts") or 0) > 0
           else _qwen3_5(d))
    return dataclasses.replace(cfg, model_prefix="model")


ARCH_ADAPTERS = {
    "LlamaForCausalLM": _llama,
    "Qwen2ForCausalLM": _qwen2,
    "Qwen3ForCausalLM": _qwen3,
    "Qwen3MoeForCausalLM": _qwen3_moe,
    "Qwen3_5ForConditionalGeneration": _qwen3_5,
    "Qwen3_5MoeForConditionalGeneration": _qwen3_5_moe,
    "Qwen3NextForCausalLM": _qwen3_next,
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
    "qwen3_moe": _qwen3_moe, "qwen3_5": _qwen3_5,
    "qwen3_5_moe": _qwen3_5_moe, "mistral": _mistral, "falcon3": _falcon3, "phi4": _phi4, "phi3": _phi4,
    "olmo2": _olmo2, "exaone4": _exaone4, "gemma3": _gemma3,
}

# families of the reference the port has not taken over yet -> the ROADMAP
# item that brings them
NOT_PORTED = {
    # Gemma3 4B and larger: a vision tower around the text model, which
    # neither package adapts; its text tower waits for a real config
    "Gemma3ForConditionalGeneration": "module 6 (Gemma3's multimodal "
                                      "checkpoints)",
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
    if arch in ("qwen3_moe", "qwen3_5_moe"):
        d.update(num_experts=8, num_experts_per_tok=2,
                 moe_intermediate_size=32)
    d.update(over)
    if arch in ("qwen3_5", "qwen3_5_moe"):
        d["text_config"] = dict(d)
        n = d["num_hidden_layers"]
        d["text_config"]["layer_types"] = [
            "linear_attention" if (i + 1) % 4 else "full_attention"
            for i in range(n)]
        d["text_config"].update(
            head_dim=16, linear_conv_kernel_dim=4, linear_num_key_heads=4,
            linear_key_head_dim=16, linear_num_value_heads=4,
            linear_value_head_dim=16)
        d["text_config"].update(over)
    return FAMILY_ADAPTERS[arch](d)
