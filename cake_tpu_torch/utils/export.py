"""The port's parameter tree -> HF-named tensors and a checkpoint
directory (counterpart of cake_tpu/utils/export.py:
params_to_hf_tensors; the inverse of utils/loaders.py).

`write_checkpoint` writes a directory the loader reads back: config.json
and one model.safetensors, or `shards` files with a
model.safetensors.index.json. Tensors are written from the torch tensors
as they are, bfloat16 included; a (1+w) norm (`residual_rms_norm`,
Gemma3, Qwen3.5) is stored as w, computed in float32 and cast to its
dtype, the inverse of the loader's step, as the reference's exporter
stores it. Given the config, the names are under its prefix, MoE experts
are written one tensor per expert (`mlp.experts.{e}.{proj}.weight`) and a
Gated DeltaNet layer under HF Qwen3-Next's names (`in_proj_qkvz`,
`in_proj_ba`; qwen3_5.export_gdn_params).
"""
from __future__ import annotations

import json
import os

import torch

from ..models.qwen3_5 import export_gdn_params
from .safetensors_io import save_safetensors

NORMS = ("input_layernorm", "post_attention_layernorm",
         "pre_feedforward_layernorm", "post_feedforward_layernorm")


def params_to_hf_tensors(params: dict, fuse_phi: bool = False,
                         residual_norms: bool = False, cfg=None
                         ) -> dict[str, torch.Tensor]:
    """fuse_phi: write Phi-style fused qkv_proj / gate_up_proj names;
    residual_norms: store every norm weight as w - 1 (Gemma3, Qwen3.5);
    cfg: the model's config, needed for its prefix and for a linear
    layer (default prefix `model`)."""
    pre = "model" if cfg is None else cfg.model_prefix

    def norm(w):
        return (w.float() - 1.0).to(w.dtype) if residual_norms else w
    out = {f"{pre}.embed_tokens.weight": params["embed_tokens"]["weight"],
           f"{pre}.norm.weight": norm(params["norm"]["weight"])}
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"]["weight"]
    for i, layer in enumerate(params["layers"]):
        lp = f"{pre}.layers.{i}"
        for name in NORMS:
            if name in layer:
                out[f"{lp}.{name}.weight"] = norm(layer[name]["weight"])
        if "linear_attn" in layer:
            out.update(export_gdn_params(cfg, layer["linear_attn"], lp))
            out.update(_mlp_tensors(layer["mlp"], f"{lp}.mlp", fuse_phi))
            continue
        a = layer["self_attn"]
        if fuse_phi:
            out[f"{lp}.self_attn.qkv_proj.weight"] = torch.cat(
                [a[p]["weight"] for p in ("q_proj", "k_proj", "v_proj")])
        else:
            for proj in ("q_proj", "k_proj", "v_proj"):
                out[f"{lp}.self_attn.{proj}.weight"] = a[proj]["weight"]
                if "bias" in a[proj]:
                    out[f"{lp}.self_attn.{proj}.bias"] = a[proj]["bias"]
        out[f"{lp}.self_attn.o_proj.weight"] = a["o_proj"]["weight"]
        for qk in ("q_norm", "k_norm"):
            if qk in a:
                out[f"{lp}.self_attn.{qk}.weight"] = norm(a[qk]["weight"])
        out.update(_mlp_tensors(layer["mlp"], f"{lp}.mlp", fuse_phi))
    return out


def _mlp_tensors(mlp: dict, mp: str, fuse_phi: bool) -> dict:
    """An MLP's tensors, or an MoE block's: router, one tensor per expert
    and projection, shared expert and its gate."""
    out = {}
    if "experts" in mlp:
        out[f"{mp}.gate.weight"] = mlp["gate"]["weight"]
        for proj, bank in mlp["experts"].items():
            for e in range(bank.shape[0]):
                out[f"{mp}.experts.{e}.{proj}.weight"] = bank[e]
        if "shared_expert" in mlp:
            out.update(_mlp_tensors(mlp["shared_expert"],
                                    f"{mp}.shared_expert", False))
            out[f"{mp}.shared_expert_gate.weight"] = \
                mlp["shared_expert_gate"]["weight"]
    elif fuse_phi:
        out[f"{mp}.gate_up_proj.weight"] = torch.cat(
            [mlp["gate_proj"]["weight"], mlp["up_proj"]["weight"]])
        out[f"{mp}.down_proj.weight"] = mlp["down_proj"]["weight"]
    else:
        for proj in ("gate_proj", "up_proj", "down_proj"):
            out[f"{mp}.{proj}.weight"] = mlp[proj]["weight"]
    return out


def write_checkpoint(model_dir: str, config: dict,
                     tensors: dict[str, torch.Tensor],
                     shards: int = 1) -> int:
    """Write config.json and the tensors as `shards` safetensors files
    (an index beside them when there is more than one), splitting the
    names in order into runs of about equal bytes. Returns the bytes of
    tensor data written."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    if shards <= 1:
        return save_safetensors(os.path.join(model_dir, "model.safetensors"),
                                tensors, {"format": "pt"})
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    groups: list[dict] = [{} for _ in range(shards)]
    acc = 0
    for name, t in tensors.items():
        groups[min(acc * shards // max(total, 1), shards - 1)][name] = t
        acc += t.numel() * t.element_size()
    weight_map, written = {}, 0
    for k, group in enumerate(groups):
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        written += save_safetensors(os.path.join(model_dir, fname), group,
                                    {"format": "pt"})
        weight_map.update({name: fname for name in group})
    with open(os.path.join(model_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": written},
                   "weight_map": weight_map}, f, indent=1)
    return written
