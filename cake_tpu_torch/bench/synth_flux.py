"""FLUX.1 checkpoints written from seeded weights, with BFL's tensor names,
for the smoke and the tests: the repository holds no published FLUX.1
checkpoint, `tokenizer.json` or `spiece.model`, and nothing may be
downloaded.

    write_flux_checkpoint(dir, cfgs, params, layout="bundle", fp8="tree")

`params`: {"transformer", "vae", "clip", "t5"} trees in the port's layout
(models/image, models/text_encoders) for the configs `cfgs` (the same
keys, as flux_loader.flux1_dev_configs gives them). Layouts:
  * "bundle": one `model.safetensors` under the ComfyUI prefixes
    (`model.diffusion_model.`, `vae.`, `text_encoders.clip_l.transformer.`
    + `text_model.`, `text_encoders.t5xxl.transformer.`);
  * "split": BFL's `flux1.safetensors` (bare transformer names) and
    `ae.safetensors` (bare `decoder.*`), HF-layout `clip/` and `t5/`.
The transformer's 2-D weights: as they are (fp8 None); cast to
float8_e4m3fn ("plain", the flux1-dev-fp8 bundle); stored halved in
float8 beside a `.scale_weight` of 2.0 ("scaled", ComfyUI's scaled FP8,
so a dropped scale shows); or, for a tree of native pairs ("tree"), each
pair's bytes with its per-tensor scale as `.scale_weight`. Beside them:
word-level `clip_tokenizer.json` and `t5_tokenizer.json` (`w0`, `w1`, ...,
then `<unk>` and `<eot>` at the top ids) and a `flux_config.json` sidecar
with the dims shapes cannot tell.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..models.image.flux_loader import (CLIP_PREFIX, T5_PREFIX,
                                        TRANSFORMER_PREFIX, VAE_PREFIX,
                                        mmdit_mapping, vae_decoder_mapping)
from ..models.text_encoders import clip_mapping, t5_mapping
from ..utils.mapping import flatten_tree
from ..utils.safetensors_io import save_safetensors
from ..utils.bpe import word_level_spec

FP8_MODES = (None, "plain", "scaled", "tree")


def _transformer_tensors(cfg, tree, prefix: str, fp8) -> dict:
    flat = flatten_tree(tree)
    out = {}
    for path, name in mmdit_mapping(cfg, prefix).items():
        stem = name[:-len(".weight")]
        if path + ".fp8" in flat:           # a native pair
            out[name] = flat[path + ".fp8"]
            out[stem + ".scale_weight"] = \
                flat[path + ".scale_inv"].reshape(-1)[0].float().clone()
            continue
        t = flat[path]
        if fp8 in ("plain", "scaled") and name.endswith(".weight") \
                and t.dim() == 2:
            if fp8 == "scaled":
                out[name] = (t.float() / 2.0).to(torch.float8_e4m3fn)
                out[stem + ".scale_weight"] = torch.tensor(2.0)
            else:
                out[name] = t.float().to(torch.float8_e4m3fn)
        else:
            out[name] = t
    return out


def _mapped(mapping: dict, tree) -> dict:
    flat = flatten_tree(tree)
    return {name: flat[path] for path, name in mapping.items()}


def write_word_level_tokenizer(path: str, vocab_size: int) -> None:
    """utils/bpe.word_level_spec written as a file."""
    with open(path, "w") as f:
        json.dump(word_level_spec(vocab_size), f)


def write_flux_checkpoint(model_dir: str, cfgs: dict, params: dict,
                          layout: str = "bundle", fp8=None) -> int:
    """Write the checkpoint, its tokenizers and sidecar; returns the bytes
    of tensor data written."""
    if layout not in ("bundle", "split") or fp8 not in FP8_MODES:
        raise ValueError(f"layout {layout!r} / fp8 {fp8!r}")
    os.makedirs(model_dir, exist_ok=True)
    bundle = layout == "bundle"
    tp = TRANSFORMER_PREFIX if bundle else ""
    files = {
        "transformer": _transformer_tensors(cfgs["mmdit"],
                                            params["transformer"], tp, fp8),
        "vae": _mapped(vae_decoder_mapping(cfgs["vae"],
                                           VAE_PREFIX if bundle else ""),
                       params["vae"]),
        "clip": _mapped(clip_mapping(cfgs["clip"], (CLIP_PREFIX if bundle
                                                    else "") + "text_model."),
                        params["clip"]),
        "t5": _mapped(t5_mapping(cfgs["t5"], T5_PREFIX if bundle else ""),
                      params["t5"]),
    }
    if bundle:
        merged = {}
        for tensors in files.values():
            merged.update(tensors)
        n = save_safetensors(os.path.join(model_dir, "model.safetensors"),
                             merged)
    else:
        n = 0
        for key, rel in (("transformer", "flux1.safetensors"),
                         ("vae", "ae.safetensors"),
                         ("clip", "clip/model.safetensors"),
                         ("t5", "t5/model.safetensors")):
            path = os.path.join(model_dir, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            n += save_safetensors(path, files[key])
    clip_cfg, t5_cfg = cfgs["clip"], cfgs["t5"]
    with open(os.path.join(model_dir, "flux_config.json"), "w") as f:
        json.dump({"mmdit": {"axes_dims": list(cfgs["mmdit"].axes_dims)},
                   "clip": {"num_heads": clip_cfg.num_heads,
                            "eot_token_id": clip_cfg.eot_token_id},
                   "t5": {"relative_max_distance":
                          t5_cfg.relative_max_distance}}, f)
    write_word_level_tokenizer(os.path.join(model_dir, "clip_tokenizer.json"),
                               clip_cfg.vocab_size)
    write_word_level_tokenizer(os.path.join(model_dir, "t5_tokenizer.json"),
                               t5_cfg.vocab_size)
    return n


def cut_depth(cfgs: dict, double: int, single: int, t5_layers: int) -> dict:
    """FLUX.1 configs at their widths with the depths cut."""
    return dict(cfgs, mmdit=dataclasses.replace(
        cfgs["mmdit"], depth_double=double, depth_single=single),
        t5=dataclasses.replace(cfgs["t5"], num_layers=t5_layers))
