"""VibeVoice checkpoint loading (counterpart of
cake_tpu/models/audio/vibevoice_loader.py: head_mapping,
vae_decoder_mapping, vae_encoder_mapping, connector_mapping, eos_mapping,
detect_vibevoice_checkpoint, load_vibevoice), and the realtime 0.5B's
config for the full-width demo (`realtime_0_5b_config`).

An HF-style directory: config.json (decoder_config, diffusion_head_config,
acoustic_tokenizer_config, tts_backbone_num_hidden_layers) and safetensors
holding
    model.language_model.*              the base Qwen2 LM
    model.tts_language_model.*          the TTS Qwen2 LM
    model.tts_input_types.weight        [2, hidden] type embeddings
    model.prediction_head.*             the diffusion head
    model.acoustic_connector.*          latent -> hidden MLP
    model.acoustic_tokenizer.decoder.*  the sigma-VAE decoder
    model.acoustic_tokenizer.encoder.*  its encoder (optional: raw-wav
                                        cloning)
    model.speech_scaling_factor / model.speech_bias_factor   scalars
    tts_eos_classifier.*                the EOS head
and, optionally, tokenizer.json (read by utils/bpe.py, encoded as
`tokenizers.Tokenizer.encode(text)` does, special tokens added). The LMs
and heads load in the model dtype, the VAE in float32.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os

import torch

from ...device import resolve_device
from ...utils.bpe import JsonTokenizer
from ...utils.loaders import ParamLoader
from ...utils.mapping import coverage_report, load_mapped_params
from ...utils.quant import NoQuantization
from ...utils.safetensors_io import TensorStorage
from .vibevoice import (VibeVoiceConfig, VibeVoiceTTS, init_connector_params,
                        init_eos_params, init_head_params,
                        init_vae_decoder_params, init_vae_encoder_params,
                        vibevoice_config_from_hf)

log = logging.getLogger("cake_tpu_torch.vibevoice_loader")

HEAD_PREFIX = "model.prediction_head."
VAE_PREFIX = "model.acoustic_tokenizer.decoder."
ENC_PREFIX = "model.acoustic_tokenizer.encoder."
CONNECTOR_PREFIX = "model.acoustic_connector."
EOS_PREFIX = "tts_eos_classifier."

# microsoft/VibeVoice-Realtime-0.5B's config.json in the fields the loader
# reads, from memory: the decoder is Qwen2.5-0.5B's widths; the split of
# its layers between the base (4) and the TTS (20) stacks, the rope theta,
# the context length and the acoustic tokenizer's fields are assumed (the
# reference dataclass's defaults)
REALTIME_0_5B = {
    "acoustic_vae_dim": 64,
    "tts_backbone_num_hidden_layers": 20,
    "decoder_config": {
        "hidden_size": 896, "intermediate_size": 4864,
        "num_attention_heads": 14, "num_key_value_heads": 2,
        "num_hidden_layers": 4, "rms_norm_eps": 1e-6,
        "rope_theta": 1000000.0, "vocab_size": 151936,
        "max_position_embeddings": 8192, "tie_word_embeddings": True},
    "diffusion_head_config": {
        "ddpm_num_inference_steps": 10, "ddpm_num_steps": 1000,
        "head_layers": 4, "hidden_size": 896, "latent_size": 64,
        "head_ffn_ratio": 3.0, "prediction_type": "v_prediction",
        "rms_norm_eps": 1e-5},
    "acoustic_tokenizer_config": {
        "vae_dim": 64, "encoder_n_filters": 32, "decoder_n_filters": 32,
        "encoder_ratios": [8, 5, 5, 4, 2, 2],
        "decoder_ratios": [8, 5, 5, 4, 2, 2],
        "decoder_depths": "3-3-3-3-3-3-8", "layernorm": "RMSNorm",
        "layernorm_eps": 1e-6, "causal": True},
}


def _block_names(dst: str, src: str) -> dict[str, str]:
    m = {f"{dst}norm.weight": f"{src}norm.weight",
         f"{dst}gamma": f"{src}gamma",
         f"{dst}mixer.weight": f"{src}mixer.conv.conv.conv.weight",
         f"{dst}mixer.bias": f"{src}mixer.conv.conv.conv.bias",
         f"{dst}ffn_norm.weight": f"{src}ffn_norm.weight",
         f"{dst}ffn_gamma": f"{src}ffn_gamma"}
    for ours, theirs in (("ffn1", "linear1"), ("ffn2", "linear2")):
        for leaf in ("weight", "bias"):
            m[f"{dst}{ours}.{leaf}"] = f"{src}ffn.{theirs}.{leaf}"
    return m


def head_mapping(cfg: VibeVoiceConfig,
                 prefix: str = HEAD_PREFIX) -> dict[str, str]:
    m = {
        "t_mlp1.weight": f"{prefix}t_embedder.mlp.0.weight",
        "t_mlp2.weight": f"{prefix}t_embedder.mlp.2.weight",
        "noisy_proj.weight": f"{prefix}noisy_images_proj.weight",
        "cond_proj.weight": f"{prefix}cond_proj.weight",
        "final_ada.weight": f"{prefix}final_layer.adaLN_modulation.1.weight",
        "final_linear.weight": f"{prefix}final_layer.linear.weight",
    }
    for i in range(cfg.head_layers):
        src, dst = f"{prefix}layers.{i}.", f"layers.{i}."
        m[f"{dst}norm.weight"] = f"{src}norm.weight"
        m[f"{dst}ada.weight"] = f"{src}adaLN_modulation.1.weight"
        for proj in ("gate_proj", "up_proj", "down_proj"):
            m[f"{dst}{proj}.weight"] = f"{src}ffn.{proj}.weight"
    return m


def vae_decoder_mapping(cfg: VibeVoiceConfig,
                        prefix: str = VAE_PREFIX) -> dict[str, str]:
    m = {"up.0.weight": f"{prefix}upsample_layers.0.0.conv.conv.weight",
         "up.0.bias": f"{prefix}upsample_layers.0.0.conv.conv.bias",
         "head.weight": f"{prefix}head.conv.conv.weight",
         "head.bias": f"{prefix}head.conv.conv.bias"}
    for i in range(len(cfg.vae_ratios)):
        src = f"{prefix}upsample_layers.{i + 1}.0.convtr.convtr"
        m[f"up.{i + 1}.weight"] = f"{src}.weight"
        m[f"up.{i + 1}.bias"] = f"{src}.bias"
    for i, depth in enumerate(cfg.vae_depths):
        for j in range(depth):
            m.update(_block_names(f"stages.{i}.{j}.",
                                  f"{prefix}stages.{i}.{j}."))
    return m


def vae_encoder_mapping(cfg: VibeVoiceConfig,
                        prefix: str = ENC_PREFIX) -> dict[str, str]:
    m = {"down.0.weight": f"{prefix}downsample_layers.0.0.conv.conv.weight",
         "down.0.bias": f"{prefix}downsample_layers.0.0.conv.conv.bias",
         "head.weight": f"{prefix}head.conv.conv.weight",
         "head.bias": f"{prefix}head.conv.conv.bias"}
    for i in range(len(cfg.vae_ratios)):
        src = f"{prefix}downsample_layers.{i + 1}.0.conv.conv"
        m[f"down.{i + 1}.weight"] = f"{src}.weight"
        m[f"down.{i + 1}.bias"] = f"{src}.bias"
    for i, depth in enumerate(cfg.enc_depths_resolved):
        for j in range(depth):
            m.update(_block_names(f"stages.{i}.{j}.",
                                  f"{prefix}stages.{i}.{j}."))
    return m


def connector_mapping(with_bias: bool,
                      prefix: str = CONNECTOR_PREFIX) -> dict[str, str]:
    m = {"fc1.weight": f"{prefix}fc1.weight",
         "norm.weight": f"{prefix}norm.weight",
         "fc2.weight": f"{prefix}fc2.weight"}
    if with_bias:
        m["fc1.bias"] = f"{prefix}fc1.bias"
        m["fc2.bias"] = f"{prefix}fc2.bias"
    return m


def eos_mapping(prefix: str = EOS_PREFIX) -> dict[str, str]:
    return {f"{a}.{b}": f"{prefix}{a}.{b}"
            for a in ("fc1", "fc2") for b in ("weight", "bias")}


def detect_vibevoice_checkpoint(path: str) -> bool:
    cfg_path = os.path.join(path, "config.json")
    if not (os.path.isdir(path) and os.path.exists(cfg_path)):
        return False
    with open(cfg_path) as f:
        raw = json.load(f)
    return "diffusion_head_config" in raw and "decoder_config" in raw


def load_vibevoice(model_dir: str, dtype=torch.float32, tokenizer=None,
                   max_frames: int = 256, device=None) -> VibeVoiceTTS:
    """A VibeVoice directory as a ready VibeVoiceTTS on `device` (default
    `cuda`)."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = vibevoice_config_from_hf(json.load(f))
    st = TensorStorage.from_model_dir(model_dir)
    try:
        def lm_params(lm_cfg):
            # the stacks have a final norm and no head: read as tied, from
            # a view of the stack's own tensors (so the loader's report of
            # unread tensors is about the stack)
            lc = dataclasses.replace(lm_cfg, tie_word_embeddings=True)
            pre = lm_cfg.model_prefix + "."
            view = TensorStorage({n: r for n, r in st.records.items()
                                  if n.startswith(pre)})
            try:
                return ParamLoader(lc, view, dtype, dev,
                                   NoQuantization()).load(
                                       include_embed=True, include_head=True)
            finally:
                view.close()

        def mapped(mapping, expected, prefix, dt=dtype):
            out = load_mapped_params(st, mapping, expected, dt, dev)
            if prefix:
                coverage_report(st, mapping, prefix)
            return out

        params: dict = {
            "base": lm_params(cfg.lm_base), "tts": lm_params(cfg.lm_tts),
            "input_types": {"weight": st.read("model.tts_input_types.weight",
                                              dev).to(dtype)},
            "speech_scaling_factor": st.read("model.speech_scaling_factor",
                                             dev).float(),
            "speech_bias_factor": st.read("model.speech_bias_factor",
                                          dev).float(),
        }
        params["head"] = mapped(head_mapping(cfg), init_head_params(
            cfg, 0, dtype, "meta"), HEAD_PREFIX)
        with_bias = CONNECTOR_PREFIX + "fc1.bias" in st
        params["connector"] = mapped(
            connector_mapping(with_bias), init_connector_params(
                cfg, 0, dtype, "meta", bias=with_bias), CONNECTOR_PREFIX)
        inner = st.records[EOS_PREFIX + "fc1.weight"].shape[0]
        params["eos"] = mapped(eos_mapping(), init_eos_params(
            cfg, 0, dtype, "meta", inner=inner), None)
        params["vae"] = mapped(vae_decoder_mapping(cfg),
                               init_vae_decoder_params(cfg, 0, torch.float32,
                                                       "meta"),
                               VAE_PREFIX, torch.float32)
        # the acoustic encoder (raw-wav cloning): realtime-only dumps may
        # leave it out
        if ENC_PREFIX + "head.conv.conv.weight" in st:
            params["vae_enc"] = mapped(
                vae_encoder_mapping(cfg), init_vae_encoder_params(
                    cfg, 0, torch.float32, "meta"),
                ENC_PREFIX, torch.float32)
        else:
            log.warning("checkpoint has no acoustic encoder — raw-wav voice "
                        "cloning unavailable (precomputed voice prompts "
                        "still work)")
    finally:
        st.close()
    if tokenizer is None:
        tok_json = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(tok_json):
            tokenizer = JsonTokenizer.from_file(tok_json)
    log.info("loaded VibeVoice: base %d + tts %d layers, hidden %d, hop %d",
             cfg.lm_base.num_hidden_layers, cfg.lm_tts.num_hidden_layers,
             cfg.hidden, cfg.hop)
    return VibeVoiceTTS(cfg, params=params, tokenizer=tokenizer, dtype=dtype,
                        max_frames=max_frames, device=dev)


def realtime_0_5b_config(base_layers: int | None = None,
                         tts_layers: int | None = None) -> VibeVoiceConfig:
    """VibeVoice-Realtime-0.5B's config (REALTIME_0_5B), the LM stacks'
    depths optionally cut."""
    raw = json.loads(json.dumps(REALTIME_0_5B))
    if base_layers is not None:
        raw["decoder_config"]["num_hidden_layers"] = base_layers
    if tts_layers is not None:
        raw["tts_backbone_num_hidden_layers"] = tts_layers
    return vibevoice_config_from_hf(raw)

