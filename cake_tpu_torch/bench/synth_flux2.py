"""FLUX.2-klein diffusers directories written from a model's weights, with
the published tensor names, for the smoke and the tests: the repository
holds no FLUX.2 snapshot and no Qwen `tokenizer.json`, and nothing may be
downloaded.

    model = seeded_flux2(cfgs, torch.bfloat16, "cuda", seed=0)
    write_flux2_checkpoint(dir, model)

The layout (models/image/flux2_loader.py reads it):
    model_index.json            {"_class_name": "Flux2Pipeline"}
    transformer/diffusion_pytorch_model.safetensors   diffusers names
    vae/diffusion_pytorch_model.safetensors  decoder.*, post_quant_conv.*
                                (identity unless the model has one),
                                bn.running_mean / bn.running_var
    text_encoder/config.json + model.safetensors      Qwen3, HF names: the
                                layers the encoder holds and a final norm
                                of ones (the encoder never reads it)
    tokenizer/tokenizer.json    byte-level BPE with Qwen's special tokens
    flux_config.json            RoPE axes and capture layers
Written from memory, not from a published snapshot (assumed): the file
names `diffusion_pytorch_model.safetensors` and `model.safetensors`,
`model_index.json` holding only its class name, the Qwen special tokens
past <|im_end|> (QWEN_SPECIAL_NAMES) and their ids, the byte-level BPE's
merges (learned from synth_checkpoint.CORPUS, not Qwen's 151k), and a
`bn` with no `num_batches_tracked`.
"""
from __future__ import annotations

import functools
import json
import os

import torch

from ..models.image.flux2_loader import (flux2_transformer_mapping,
                                         flux2_vae_mapping)
from ..utils.export import params_to_hf_tensors
from ..utils.mapping import flatten_tree
from ..utils.safetensors_io import save_safetensors
from .synth_checkpoint import tokenizer_json

# Qwen2/Qwen3's added tokens in id order from <|endoftext|> (151643);
# the names past <|im_end|> are assumed
QWEN_SPECIAL_NAMES = (
    "<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
    "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>",
    "<|quad_end|>", "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
    "<|image_pad|>", "<|video_pad|>", "<tool_call>", "</tool_call>",
    "<|fim_prefix|>", "<|fim_middle|>", "<|fim_suffix|>", "<|fim_pad|>",
    "<|repo_name|>", "<|file_sep|>", "<tool_response>", "</tool_response>",
    "<think>", "</think>")
QWEN_FIRST_SPECIAL = 151643


@functools.lru_cache(maxsize=4)
def qwen_tokenizer(vocab_size: int = 151936, n_merges: int = 400) -> dict:
    """A byte-level BPE tokenizer.json dict with Qwen's special tokens at
    Qwen's ids (151643 ...), or, for a vocabulary too small for those,
    ending at its top (a tiny test encoder). Cached: do not modify it."""
    first = min(QWEN_FIRST_SPECIAL, vocab_size - len(QWEN_SPECIAL_NAMES))
    return tokenizer_json({name: first + i for i, name in
                           enumerate(QWEN_SPECIAL_NAMES)}, n_merges)


def encoder_hf_config(cfg, layers: int) -> dict:
    """The Qwen3 config.json of an encoder config cut to `layers`."""
    return dict(architectures=["Qwen3ForCausalLM"], model_type="qwen3",
                vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                intermediate_size=cfg.intermediate_size,
                num_hidden_layers=layers,
                num_attention_heads=cfg.num_attention_heads,
                num_key_value_heads=cfg.num_key_value_heads,
                head_dim=cfg.head_dim, rms_norm_eps=cfg.rms_norm_eps,
                rope_theta=cfg.rope_theta,
                max_position_embeddings=cfg.max_seq_len,
                tie_word_embeddings=True,
                eos_token_id=list(cfg.eos_token_ids) or None)


def _vae_tensors(cfg, vae: dict) -> dict:
    vmap, transforms = flux2_vae_mapping(cfg)
    flat = flatten_tree(vae)
    lc = cfg.latent_channels
    flat.setdefault("post_quant_conv.weight", torch.eye(
        lc, device=flat["conv_in.weight"].device).reshape(lc, lc, 1, 1))
    flat.setdefault("post_quant_conv.bias", torch.zeros(
        lc, device=flat["conv_in.weight"].device))
    out = {}
    for path, name in vmap.items():
        t = flat[path]
        if path in transforms:               # 1x1 conv back to a linear
            t = t.reshape(t.shape[0], t.shape[1])
        out[name] = t.float()
    return out


def write_flux2_checkpoint(model_dir: str, model,
                           bn_stats=None) -> int:
    """Write a Flux2ImageModel with a Flux2TextEncoder as a diffusers
    directory; bn_stats: (running_mean, running_var) to write (default:
    the model's own). Returns the bytes of tensor data written."""
    cfg, enc = model.cfg, model.text_encoder
    for sub in ("transformer", "vae", "text_encoder", "tokenizer"):
        os.makedirs(os.path.join(model_dir, sub), exist_ok=True)
    flat = flatten_tree(model.params["transformer"])
    n = save_safetensors(
        os.path.join(model_dir, "transformer",
                     "diffusion_pytorch_model.safetensors"),
        {name: flat[path] for path, name in
         flux2_transformer_mapping(cfg.transformer).items()})
    vae = _vae_tensors(cfg.vae, model.params["vae"])
    if bn_stats is None:
        bn_stats = (model.bn_mean, model.bn_var)
    vae["bn.running_mean"] = torch.as_tensor(bn_stats[0]).float()
    vae["bn.running_var"] = torch.as_tensor(bn_stats[1]).float()
    n += save_safetensors(os.path.join(
        model_dir, "vae", "diffusion_pytorch_model.safetensors"), vae)
    layers = len(enc.params["layers"])
    emb = enc.params["embed_tokens"]["weight"]
    tree = {"layers": enc.params["layers"], "embed_tokens": {"weight": emb},
            "norm": {"weight": torch.ones(enc.cfg.hidden_size,
                                          dtype=emb.dtype,
                                          device=emb.device)}}
    n += save_safetensors(
        os.path.join(model_dir, "text_encoder", "model.safetensors"),
        params_to_hf_tensors(tree, cfg=enc.cfg))
    with open(os.path.join(model_dir, "text_encoder", "config.json"),
              "w") as f:
        json.dump(encoder_hf_config(enc.cfg, layers), f, indent=1)
    with open(os.path.join(model_dir, "tokenizer", "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(qwen_tokenizer(enc.cfg.vocab_size), f, ensure_ascii=False)
    with open(os.path.join(model_dir, "model_index.json"), "w") as f:
        json.dump({"_class_name": "Flux2Pipeline"}, f)
    with open(os.path.join(model_dir, "flux_config.json"), "w") as f:
        json.dump({"flux2": {"axes_dims": list(cfg.transformer.axes_dims)},
                   "encoder": {"output_layers": list(enc.output_layers)}},
                  f)
    return n
