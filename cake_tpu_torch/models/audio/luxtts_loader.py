"""LuxTTS checkpoint loading (counterpart of
cake_tpu/models/audio/luxtts_loader.py: luxtts_mapping, vocos_mapping,
detect_luxtts_checkpoint, load_luxtts, luxtts_vocos_dims).

A release directory:
    config.json            {"model": {...}, "feature": {...}}
    model.safetensors      embed.* + text_encoder.* + fm_decoder.*
    vocos.safetensors      backbone.* + head.*   (or inside model.safetensors)
    tokens.txt             the phoneme symbol table
    cmudict-0.7b-ipa.txt   optional word -> IPA dictionary

The expected shapes come from the config (the initializers on the "meta"
device), the Vocos widths and depth from its weights; the trunk loads in
the model dtype, the Vocos in float32.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os

import torch

from ...device import resolve_device
from ...utils.mapping import coverage_report, load_mapped_params
from ...utils.safetensors_io import TensorStorage, index_file
from .luxtts import (LuxTTS, LuxTTSConfig, Phonemizer, init_luxtts_params,
                     init_vocos_params, luxtts_config_from_hf)

log = logging.getLogger("cake_tpu_torch.luxtts_loader")

STACK_ENTRIES = ("stack_time_emb", "downsample", "out_combiner")


def _zip_layer_mapping(dst: str, src: str) -> dict[str, str]:
    m = {
        f"{dst}.norm.bias": f"{src}.norm.bias",
        f"{dst}.norm.log_scale": f"{src}.norm.log_scale",
        f"{dst}.self_attn_weights.in_proj.weight":
            f"{src}.self_attn_weights.in_proj.weight",
        f"{dst}.self_attn_weights.in_proj.bias":
            f"{src}.self_attn_weights.in_proj.bias",
        f"{dst}.self_attn_weights.linear_pos.weight":
            f"{src}.self_attn_weights.linear_pos.weight",
        f"{dst}.bypass.bypass_scale": f"{src}.bypass.bypass_scale",
        f"{dst}.bypass_mid.bypass_scale": f"{src}.bypass_mid.bypass_scale",
    }
    for comp in ("feed_forward1", "feed_forward2", "feed_forward3",
                 "self_attn1", "self_attn2", "nonlin_attention"):
        for pj in ("in_proj", "out_proj"):
            m[f"{dst}.{comp}.{pj}.weight"] = f"{src}.{comp}.{pj}.weight"
            m[f"{dst}.{comp}.{pj}.bias"] = f"{src}.{comp}.{pj}.bias"
    for comp in ("conv_module1", "conv_module2"):
        for pj in ("in_proj", "out_proj", "depthwise_conv"):
            m[f"{dst}.{comp}.{pj}.weight"] = f"{src}.{comp}.{pj}.weight"
            m[f"{dst}.{comp}.{pj}.bias"] = f"{src}.{comp}.{pj}.bias"
    return m


def luxtts_mapping(cfg: LuxTTSConfig) -> dict[str, str]:
    """Tree path -> model.safetensors tensor name."""
    m = {"embed.weight": "embed.weight"}
    for pj in ("in_proj", "out_proj"):
        m[f"text_encoder.{pj}.weight"] = f"text_encoder.{pj}.weight"
        m[f"text_encoder.{pj}.bias"] = f"text_encoder.{pj}.bias"
        m[f"fm_decoder.{pj}.weight"] = f"fm_decoder.{pj}.weight"
        m[f"fm_decoder.{pj}.bias"] = f"fm_decoder.{pj}.bias"
    for i in range(cfg.text_encoder_num_layers):
        m.update(_zip_layer_mapping(f"text_encoder.layers.{i}",
                                    f"text_encoder.layers.{i}"))
    for i in range(cfg.total_fm_layers):
        m.update(_zip_layer_mapping(f"fm_decoder.layers.{i}",
                                    f"fm_decoder.layers.{i}"))
    for idx in ("0", "2"):
        m[f"fm_decoder.time_embed_{idx}.weight"] = \
            f"fm_decoder.time_embed.{idx}.weight"
        m[f"fm_decoder.time_embed_{idx}.bias"] = \
            f"fm_decoder.time_embed.{idx}.bias"
    for s, ds in enumerate(cfg.fm_decoder_downsampling_factor):
        m[f"fm_decoder.stack_time_emb.{s}.weight"] = \
            f"fm_decoder.stack_time_emb.{s}.1.weight"
        m[f"fm_decoder.stack_time_emb.{s}.bias"] = \
            f"fm_decoder.stack_time_emb.{s}.1.bias"
        if ds > 1:
            m[f"fm_decoder.downsample.{s}.bias"] = \
                f"fm_decoder.downsample.{s}.bias"
            m[f"fm_decoder.out_combiner.{s}.bypass_scale"] = \
                f"fm_decoder.out_combiner.{s}.bypass_scale"
    return m


def vocos_mapping(cfg: LuxTTSConfig) -> dict[str, str]:
    """Vocos tree path -> vocos.safetensors tensor name."""
    m = {
        "embed.weight": "backbone.embed.weight",
        "embed.bias": "backbone.embed.bias",
        "norm.weight": "backbone.norm.weight",
        "norm.bias": "backbone.norm.bias",
        "final_layer_norm.weight": "backbone.final_layer_norm.weight",
        "final_layer_norm.bias": "backbone.final_layer_norm.bias",
        "head_out.weight": "head.out.weight",
        "head_out.bias": "head.out.bias",
        "istft_window": "head.istft.window",
    }
    for i in range(cfg.vocos_layers):
        src = f"backbone.convnext.{i}"
        dst = f"convnext.{i}"
        m[f"{dst}.gamma"] = f"{src}.gamma"
        for comp in ("dwconv", "norm", "pwconv1", "pwconv2"):
            m[f"{dst}.{comp}.weight"] = f"{src}.{comp}.weight"
            m[f"{dst}.{comp}.bias"] = f"{src}.{comp}.bias"
    return m


def detect_luxtts_checkpoint(path: str) -> bool:
    """A config.json whose "model" block has the flow-matching decoder's
    fields."""
    cfg_path = os.path.join(path, "config.json")
    if not (os.path.isdir(path) and os.path.exists(cfg_path)):
        return False
    with open(cfg_path) as f:
        m = json.load(f).get("model", {})
    return isinstance(m, dict) and ("fm_decoder_dim" in m
                                    or "fm_decoder_num_layers" in m)


def luxtts_vocos_dims(cfg: LuxTTSConfig, records) -> LuxTTSConfig:
    """The vocoder's width, kernel and depth read off its weights."""
    emb = records["backbone.embed.weight"].shape     # [dim, feat, kernel]
    n = 0
    while f"backbone.convnext.{n}.gamma" in records:
        n += 1
    return dataclasses.replace(cfg, vocos_dim=emb[0], vocos_kernel=emb[2],
                               vocos_layers=n)


def stack_lists(fm: dict, n_stacks: int) -> dict:
    """A decoder tree's per-stack entries as lists over the stacks, None
    where a stack has none: a mapped load gives {"1": ..} for a stack set
    that does not start at 0."""
    for key in STACK_ENTRIES:
        node = fm.get(key)
        if isinstance(node, dict):
            fm[key] = [node.get(str(s)) for s in range(n_stacks)]
        elif node is None:
            fm[key] = [None] * n_stacks
        else:
            fm[key] = list(node) + [None] * (n_stacks - len(node))
    return fm


def load_luxtts(model_dir: str, dtype=torch.float32,
                device=None) -> LuxTTS:
    """A LuxTTS directory as a ready LuxTTS on `device` (default `cuda`):
    the trunk in `dtype`, the Vocos in float32."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = luxtts_config_from_hf(json.load(f))
    main_st = TensorStorage(index_file(
        os.path.join(model_dir, "model.safetensors")))
    vocos_path = os.path.join(model_dir, "vocos.safetensors")
    vocos_st = (TensorStorage(index_file(vocos_path))
                if os.path.exists(vocos_path) else main_st)
    try:
        cfg = luxtts_vocos_dims(cfg, vocos_st.records)
        mm = luxtts_mapping(cfg)
        params = load_mapped_params(
            main_st, mm, init_luxtts_params(cfg, 0, dtype, "meta"), dtype,
            dev)
        coverage_report(main_st, mm, ignore=("backbone.", "head."))
        vm = vocos_mapping(cfg)
        params["vocos"] = load_mapped_params(
            vocos_st, vm, init_vocos_params(cfg, 0, torch.float32, "meta"),
            torch.float32, dev)
        if vocos_st is not main_st:
            coverage_report(vocos_st, vm)
    finally:
        main_st.close()
        vocos_st.close()
    stack_lists(params["fm_decoder"], len(cfg.fm_decoder_num_layers))
    phon = Phonemizer(
        tokens_path=os.path.join(model_dir, "tokens.txt"),
        dict_path=os.path.join(model_dir, "cmudict-0.7b-ipa.txt"),
        vocab_size=cfg.vocab_size)
    log.info("loaded LuxTTS: %d TE + %d FM layers, feat %d, vocos %dx%d",
             cfg.text_encoder_num_layers, cfg.total_fm_layers, cfg.feat_dim,
             cfg.vocos_layers, cfg.vocos_dim)
    return LuxTTS(cfg, params=params, phonemizer=phon, dtype=dtype,
                  device=dev)
