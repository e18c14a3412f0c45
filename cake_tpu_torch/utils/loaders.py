"""Checkpoint directory -> the port's parameter tree (counterpart of
cake_tpu/utils/loaders.py: ParamLoader and load_model_params).

The tree is the one `init_params` builds: HF names without the model
prefix (`model`, or Qwen3.5's `model.language_model`), separate q/k/v and
gate/up projections. MoE experts (`mlp.experts.{e}.{proj}.weight`) are
stacked on the device into [E, I, H] (gate, up) and [E, H, I] (down)
banks beside the router `mlp.gate.weight`, the shared expert and its
gate; with `expert_offload` each MoE layer holds a `_provider` leaf
(models/common/expert_provider.py: DiskExpertProvider, an LRU of
`expert_lru_size` experts) in place of the banks, and its experts stay
in the storage, as the reference's loader does. A Gated DeltaNet layer
loads through qwen3_5.load_gdn_params. Phi-4's pre-fused
`qkv_proj` is split at size_q / size_kv and its `gate_up_proj` in halves,
on the device. Each tensor is read from the file's map, copied to the
device and cast there, one at a time. A tensor the config needs and the
checkpoint lacks raises KeyError with its name; tensors the checkpoint
has and the model does not read are logged, as the reference's
`mapping.coverage_report` does.

A quantization strategy (utils/quant.py, from
`runtime.load_config_and_quant`) intercepts every read by name, as the
reference's `_get` hook does: FP8 (dequantized at load, or kept native
as {"fp8", "scale_inv"}), AutoGPTQ 4-bit, or none; a GGUF file plugs in
as the storage (utils/gguf.py: GgufStorage). Tensors that are sliced,
stacked, concatenated or consumed outside `linear` (fused qkv / gate_up
splits, the MoE router and expert banks, the embeddings, every Gated
DeltaNet tensor) load through `_get_dense`, which dequantizes a native
FP8 pair (on a card, through the dequant kernel) and warns once, as the
reference's does; the shared expert's gate and the head go through
`_get` and may stay native.

Gemma3 and Qwen3.5 checkpoints store each RMS-norm weight as w for a norm
that multiplies by 1 + w (`residual_rms_norm`): the loader adds 1 in
float32 after the cast to the model dtype and casts back, in the
reference's order (`load_rms_norm_weight`), so both loaders give the same
bits. The Gated DeltaNet's gated norm is not such a norm: its weight
loads as stored.
"""
from __future__ import annotations

import json
import logging
import os

import torch

from ..models.common.config import ModelConfig
from ..models.common.expert_provider import DiskExpertProvider
from ..models.common.layers import NORM_NAMES
from ..models.qwen3_5 import load_gdn_params
from ..ops.fp8 import dequant_fp8_blockwise, is_fp8
from .quant import NoQuantization, detect_quantization
from .safetensors_io import TensorStorage

log = logging.getLogger(__name__)


class ParamLoader:
    _warned_dense = False

    def __init__(self, cfg: ModelConfig, storage, dtype: torch.dtype =
                 torch.bfloat16, device="cpu", quant=None,
                 expert_offload: bool = False, expert_lru_size: int = 32):
        self.cfg = cfg
        self.st = storage
        self.dtype = dtype
        self.device = device
        self.quant = quant or NoQuantization()
        self.expert_offload = expert_offload
        self.expert_lru_size = expert_lru_size
        self.used: set[str] = set()

    def _has(self, name: str) -> bool:
        return self.quant.has(self.st, name)

    def _get(self, name: str, dtype: torch.dtype | None = None):
        """The tensor through the quantization strategy: a tensor, or a
        native FP8 pair."""
        if not self._has(name):
            raise KeyError(f"checkpoint tensor {name} is missing "
                           f"(arch {self.cfg.arch})")
        self.used.update(self.quant.sources(self.st, name))
        return self.quant.load(self.st, name, self.device,
                               dtype or self.dtype)

    def _get_dense(self, name: str, dtype: torch.dtype | None = None
                   ) -> torch.Tensor:
        """Like _get, but a native FP8 pair is dequantized: its consumer
        slices, stacks or reads it outside linear()."""
        w = self._get(name, dtype)
        if not is_fp8(w):
            return w
        if not ParamLoader._warned_dense:
            log.warning("fp8-native: %s loads dense (sliced, stacked or "
                        "not a matmul's weight); 1 byte/param residency "
                        "applies to plain projections only", name)
            ParamLoader._warned_dense = True
        return dequant_fp8_blockwise(w["fp8"], w["scale_inv"],
                                     dtype or self.dtype)

    def _weight(self, name: str) -> dict:
        return {"weight": self._get(name)}

    def _norm(self, name: str) -> dict:
        return {"weight": load_rms_norm_weight(self._get(name),
                                               self.cfg.residual_rms_norm)}

    def _attention(self, lp: str) -> dict:
        cfg = self.cfg
        sq, skv = cfg.size_q, cfg.size_kv
        fused = f"{lp}.self_attn.qkv_proj.weight"
        p: dict = {}
        if cfg.fused_qkv and self._has(fused):
            w = self._get_dense(fused)
            if w.shape[0] != sq + 2 * skv:
                raise ValueError(f"{fused}: {w.shape[0]} rows, expected "
                                 f"{sq} + 2 x {skv}")
            p["q_proj"] = {"weight": w[:sq].clone()}
            p["k_proj"] = {"weight": w[sq:sq + skv].clone()}
            p["v_proj"] = {"weight": w[sq + skv:].clone()}
        else:
            for proj in ("q_proj", "k_proj", "v_proj"):
                p[proj] = self._weight(f"{lp}.self_attn.{proj}.weight")
                bias = f"{lp}.self_attn.{proj}.bias"
                if cfg.qkv_bias and self._has(bias):
                    p[proj]["bias"] = self._get(bias)
        p["o_proj"] = self._weight(f"{lp}.self_attn.o_proj.weight")
        if cfg.qk_norm:
            for qk in ("q_norm", "k_norm"):
                p[qk] = self._norm(f"{lp}.self_attn.{qk}.weight")
        return p

    def _mlp(self, mp: str) -> dict:
        fused = f"{mp}.gate_up_proj.weight"
        if self.cfg.fused_qkv and self._has(fused):
            w = self._get_dense(fused)
            i = w.shape[0] // 2
            return {"gate_proj": {"weight": w[:i].clone()},
                    "up_proj": {"weight": w[i:].clone()},
                    "down_proj": self._weight(f"{mp}.down_proj.weight")}
        return {proj: self._weight(f"{mp}.{proj}.weight")
                for proj in ("gate_proj", "up_proj", "down_proj")}

    def _moe(self, mp: str) -> dict:
        """The router, the experts stacked into banks (each expert's
        tensor copied into its row on the device) or, offloaded, a
        `_provider` that reads them from the storage on demand, and the
        shared expert."""
        cfg = self.cfg
        p: dict = {"gate": {"weight": self._get_dense(f"{mp}.gate.weight")}}
        if self.expert_offload:
            prov = DiskExpertProvider(
                self.st, mp, cfg.num_experts, quant=self.quant,
                dtype=self.dtype, device=self.device,
                lru_size=self.expert_lru_size,
                name_fmt="{lp}.experts.{e}.{proj}.weight")
            for e in range(cfg.num_experts):
                for name in prov.names(e):
                    if not self._has(name):
                        raise KeyError(f"checkpoint tensor {name} is "
                                       f"missing (arch {cfg.arch})")
                    self.used.update(self.quant.sources(self.st, name))
            p["_provider"] = prov
            return self._shared_expert(mp, p)
        banks = {}
        for proj in ("gate_proj", "up_proj", "down_proj"):
            bank = None
            for e in range(cfg.num_experts):
                w = self._get_dense(f"{mp}.experts.{e}.{proj}.weight")
                if bank is None:
                    bank = torch.empty((cfg.num_experts, *w.shape),
                                       dtype=w.dtype, device=w.device)
                bank[e].copy_(w)
            banks[proj] = bank
        p["experts"] = banks
        return self._shared_expert(mp, p)

    def _shared_expert(self, mp: str, p: dict) -> dict:
        if self.cfg.shared_expert_intermediate_size:
            p["shared_expert"] = self._mlp(f"{mp}.shared_expert")
            p["shared_expert_gate"] = self._weight(
                f"{mp}.shared_expert_gate.weight")
        return p

    def _layer(self, i: int) -> dict:
        spec = self.cfg.layer_spec(i)
        if spec.norm_style not in NORM_NAMES:
            raise NotImplementedError(
                f"norm style {spec.norm_style!r} is not ported")
        lp = f"{self.cfg.model_prefix}.layers.{i}"
        p = ({"linear_attn": load_gdn_params(self, lp)}
             if spec.kind == "linear"
             else {"self_attn": self._attention(lp)})
        p["mlp"] = (self._moe(f"{lp}.mlp") if spec.is_moe
                    else self._mlp(f"{lp}.mlp"))
        for n in NORM_NAMES[spec.norm_style]:
            p[n] = self._norm(f"{lp}.{n}.weight")
        return p

    def load(self, layer_range: tuple[int, int] | None = None,
             include_embed: bool | None = None,
             include_head: bool | None = None) -> dict:
        """The tree of every layer, or of `layer_range` [lo, hi) only (a
        cluster stage's: params["layers"] holds that range), with the
        embeddings when include_embed (default: lo == 0) and the final
        norm and head when include_head (default: hi == the depth); a
        tied head brings the embeddings along, as in the reference."""
        cfg, pre = self.cfg, self.cfg.model_prefix
        lo, hi = layer_range or (0, cfg.num_hidden_layers)
        if include_embed is None:
            include_embed = lo == 0
        if include_head is None:
            include_head = hi == cfg.num_hidden_layers
        if include_head and cfg.tie_word_embeddings:
            include_embed = True
        params: dict = {"layers": [self._layer(i) for i in range(lo, hi)]}
        if include_embed:
            params["embed_tokens"] = {"weight": self._get_dense(
                f"{pre}.embed_tokens.weight")}
        if include_head:
            params["norm"] = self._norm(f"{pre}.norm.weight")
            if not cfg.tie_word_embeddings:
                head = ("lm_head.weight" if self._has("lm_head.weight")
                        else f"{pre}.lm_head.weight")
                params["lm_head"] = self._weight(head)
        whole = (lo, hi) == (0, cfg.num_hidden_layers) and include_embed \
            and include_head
        unused = sorted(set(self.st.names()) - self.used) if whole else []
        if unused:
            log.warning("checkpoint tensors not consumed: %s%s", unused[:6],
                        f" (+{len(unused) - 6} more)" if len(unused) > 6
                        else "")
        return params


def load_rms_norm_weight(weight: torch.Tensor,
                         residual: bool) -> torch.Tensor:
    """The weight a norm multiplies by: as stored, or (residual) 1 + w
    computed in float32 and cast back to the weight's dtype."""
    if not residual:
        return weight
    return (weight.float() + 1.0).to(weight.dtype)


def load_model_params(cfg: ModelConfig, model_dir: str,
                      dtype: torch.dtype = torch.bfloat16,
                      device="cpu", quant=None,
                      expert_offload: bool = False,
                      expert_lru_size: int = 32,
                      layer_range: tuple[int, int] | None = None,
                      include_embed: bool | None = None,
                      include_head: bool | None = None) -> dict:
    """The parameter tree of a safetensors checkpoint directory, through
    `quant` (default: the strategy its config.json names). With
    expert_offload the storage stays open: the MoE layers' providers read
    from it for as long as the model lives. layer_range, include_embed
    and include_head cut the tree to a cluster stage's part
    (ParamLoader.load)."""
    if quant is None:
        with open(os.path.join(model_dir, "config.json")) as f:
            quant = detect_quantization(json.load(f))
    storage = TensorStorage.from_model_dir(model_dir)
    try:
        return ParamLoader(cfg, storage, dtype, device, quant,
                           expert_offload, expert_lru_size).load(
                               layer_range, include_embed, include_head)
    finally:
        if not expert_offload:
            storage.close()
