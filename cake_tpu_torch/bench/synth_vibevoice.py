"""VibeVoice checkpoint directories written from a model's weights, with
the published tensor names, and voice-prompt files, for the smoke and the
tests: the repository holds no VibeVoice checkpoint, `config.json`,
tokenizer or voice prompt, and nothing may be downloaded.

    tts = VibeVoiceTTS(cfg, dtype=torch.bfloat16, seed=0, device="cuda")
    write_vibevoice_checkpoint(dir, tts)
    write_voice_prompt(path, tts.cfg, seq=12, seed=1)

The directory: config.json (hf_config: the release structure,
decoder_config / diffusion_head_config / acoustic_tokenizer_config /
tts_backbone_num_hidden_layers), model.safetensors (both LM stacks under
`model.language_model.` / `model.tts_language_model.` with Qwen2's names,
the head, connector, EOS classifier and VAE under the prefixes of
models/audio/vibevoice_loader.py, the type embeddings and the two
scalars), and tokenizer.json, a byte-level BPE with Qwen's special
tokens (bench/synth_flux2.qwen_tokenizer; the vocabulary must hold its
256 + 400 + 26 tokens). Assumed, not taken from a published
checkpoint: the single-file layout, the config fields beyond those the
loader reads, and the voice prompt's `neg_lm` entries (which no reader
uses).
"""
from __future__ import annotations

import json
import os

import torch

from ..models.audio.vibevoice import VibeVoiceConfig
from ..models.audio.vibevoice_loader import (connector_mapping, eos_mapping,
                                             head_mapping,
                                             vae_decoder_mapping,
                                             vae_encoder_mapping)
from ..utils.export import params_to_hf_tensors
from ..utils.mapping import flatten_tree
from ..utils.safetensors_io import save_safetensors
from .synth_flux2 import qwen_tokenizer


def hf_config(cfg: VibeVoiceConfig) -> dict:
    """The release config.json of a VibeVoiceConfig."""
    lm = cfg.lm_base
    ac = {"vae_dim": cfg.acoustic_dim,
          "encoder_n_filters": cfg.enc_n_filters or cfg.vae_n_filters,
          "decoder_n_filters": cfg.vae_n_filters,
          "encoder_ratios": list(cfg.vae_ratios),
          "decoder_ratios": list(cfg.vae_ratios),
          "decoder_depths": "-".join(str(d) for d in cfg.vae_depths),
          "layernorm": "RMSNorm", "layernorm_eps": cfg.vae_eps,
          "causal": True}
    if cfg.enc_depths:
        ac["encoder_depths"] = "-".join(str(d) for d in cfg.enc_depths)
    return {
        "acoustic_vae_dim": cfg.acoustic_dim,
        "tts_backbone_num_hidden_layers": cfg.lm_tts.num_hidden_layers,
        "decoder_config": {
            "hidden_size": lm.hidden_size,
            "intermediate_size": lm.intermediate_size,
            "num_attention_heads": lm.num_attention_heads,
            "num_hidden_layers": lm.num_hidden_layers,
            "num_key_value_heads": lm.num_key_value_heads,
            "rms_norm_eps": lm.rms_norm_eps, "rope_theta": lm.rope_theta,
            "vocab_size": lm.vocab_size,
            "max_position_embeddings": lm.max_seq_len,
            "tie_word_embeddings": True},
        "diffusion_head_config": {
            "ddpm_num_inference_steps": cfg.solver_steps,
            "ddpm_num_steps": cfg.ddpm_num_steps,
            "head_layers": cfg.head_layers, "hidden_size": cfg.hidden,
            "latent_size": cfg.acoustic_dim,
            "head_ffn_ratio": cfg.head_ffn_ratio,
            "prediction_type": "v_prediction", "rms_norm_eps": cfg.head_eps},
        "acoustic_tokenizer_config": ac,
    }


def checkpoint_tensors(tts) -> dict:
    """Every tensor of a VibeVoiceTTS under its published name."""
    cfg, p = tts.cfg, tts.params
    out = {}
    for key, lm in (("base", cfg.lm_base), ("tts", cfg.lm_tts)):
        tree = {k: p[key][k] for k in ("layers", "embed_tokens", "norm")}
        out.update(params_to_hf_tensors(tree, cfg=lm))
    parts = [(p["head"], head_mapping(cfg)),
             (p["connector"], connector_mapping("bias" in p["connector"]
                                                ["fc1"])),
             (p["eos"], eos_mapping()), (p["vae"], vae_decoder_mapping(cfg))]
    if "vae_enc" in p:
        parts.append((p["vae_enc"], vae_encoder_mapping(cfg)))
    for tree, mapping in parts:
        flat = flatten_tree(tree)
        out.update({name: flat[path] for path, name in mapping.items()})
    out["model.tts_input_types.weight"] = p["input_types"]["weight"]
    out["model.speech_scaling_factor"] = p["speech_scaling_factor"].float()
    out["model.speech_bias_factor"] = p["speech_bias_factor"].float()
    return out


def write_vibevoice_checkpoint(model_dir: str, tts) -> int:
    """Write config.json, model.safetensors and tokenizer.json; returns
    the bytes of tensor data written."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_config(tts.cfg), f, indent=1)
    n = save_safetensors(os.path.join(model_dir, "model.safetensors"),
                         checkpoint_tensors(tts), {"format": "pt"})
    with open(os.path.join(model_dir, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(qwen_tokenizer(tts.cfg.lm_base.vocab_size), f,
                  ensure_ascii=False)
    return n


def write_voice_prompt(path: str, cfg: VibeVoiceConfig, seq: int = 8,
                       seed: int = 0) -> None:
    """A voice-prompt safetensors file of seeded N(0, 1) keys, values
    ([1, Hkv, seq, D] per layer) and last hidden states ([1, seq,
    hidden]) for lm, tts_lm, neg_lm and neg_tts_lm."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for pfx, lm in (("lm", cfg.lm_base), ("tts_lm", cfg.lm_tts),
                    ("neg_lm", cfg.lm_base), ("neg_tts_lm", cfg.lm_tts)):
        shape = (1, lm.num_key_value_heads, seq, lm.head_dim)
        for i in range(lm.num_hidden_layers):
            out[f"{pfx}.kv.{i}.key"] = torch.randn(shape, generator=gen)
            out[f"{pfx}.kv.{i}.value"] = torch.randn(shape, generator=gen)
        out[f"{pfx}.last_hidden_state"] = torch.randn(
            (1, seq, lm.hidden_size), generator=gen)
    save_safetensors(path, out)
