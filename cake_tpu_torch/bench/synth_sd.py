"""Stable Diffusion pipelines from seeded weights, and diffusers
directories written from them with the published tensor names and
configs, for the smoke and the tests: the repository holds no published
SD checkpoint and no CLIP `vocab.json` / `merges.txt`, and nothing may be
downloaded.

    model = seeded_sd(FAMILIES["sdxl"], torch.bfloat16, "cuda", seed=0)
    write_sd_checkpoint(dir, FAMILIES["sdxl"], model)

FAMILIES holds the published configs (`unet/config.json`,
`vae/config.json`, `scheduler/scheduler_config.json`, the text encoders'
`config.json`, `model_index.json`), the fields the loader reads, of
stable-diffusion-v1-5 ("sd15"), stable-diffusion-2-1 ("sd21") and
stable-diffusion-xl-base-1.0 ("sdxl"); `cut` keeps their widths and cuts
the UNet's levels, its transformers' depth and the encoders' layers. The
tokenizers are CLIP's form, `vocab.json` + `merges.txt` beside
`tokenizer_config.json` (or, `tokenizer="json"`, the same pipeline as one
tokenizer.json): a byte-level vocabulary of the family's size, its
merges drawn from a seed over lowercase letters, so prompts of words
merge.
"""
from __future__ import annotations

import copy
import functools
import json
import os

import numpy as np
import torch

from ..models.image.sd import SDImageModel, SDXLImageModel, init_unet_params
from ..models.image.sd_loader import (SDTextEncoder, clip_config_from_dict,
                                      sd_config_from_dicts, sd_unet_mapping,
                                      sd_vae_decoder_mapping,
                                      sd_vae_encoder_mapping)
from ..models.image.vae import init_vae_decoder_params, \
    init_vae_encoder_params
from ..models.text_encoders import clip_mapping, init_clip_params
from ..utils.bpe import JsonTokenizer, bytes_to_unicode, clip_spec
from ..utils.mapping import flatten_tree
from ..utils.safetensors_io import save_safetensors

BOS, EOS = "<|startoftext|>", "<|endoftext|>"

_SD_VAE = {"_class_name": "AutoencoderKL", "act_fn": "silu",
           "block_out_channels": [128, 256, 512, 512],
           "down_block_types": ["DownEncoderBlock2D"] * 4, "in_channels": 3,
           "latent_channels": 4, "layers_per_block": 2,
           "norm_num_groups": 32, "out_channels": 3, "sample_size": 512,
           "scaling_factor": 0.18215,
           "up_block_types": ["UpDecoderBlock2D"] * 4}
_CLIP_L = {"architectures": ["CLIPTextModel"], "hidden_act": "quick_gelu",
           "hidden_size": 768, "intermediate_size": 3072,
           "max_position_embeddings": 77, "num_attention_heads": 12,
           "num_hidden_layers": 12, "projection_dim": 768,
           "vocab_size": 49408, "bos_token_id": 0, "eos_token_id": 2,
           "pad_token_id": 1}
_SD_UNET = {"_class_name": "UNet2DConditionModel", "act_fn": "silu",
            "attention_head_dim": 8,
            "block_out_channels": [320, 640, 1280, 1280],
            "cross_attention_dim": 768,
            "down_block_types": ["CrossAttnDownBlock2D"] * 3
            + ["DownBlock2D"],
            "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4,
            "layers_per_block": 2, "norm_eps": 1e-05, "norm_num_groups": 32,
            "out_channels": 4, "sample_size": 64,
            "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3}
_BETAS = {"beta_start": 0.00085, "beta_end": 0.012,
          "beta_schedule": "scaled_linear", "num_train_timesteps": 1000}

FAMILIES = {
    # runwayml/stable-diffusion-v1-5
    "sd15": {
        "unet": _SD_UNET, "vae": _SD_VAE,
        "scheduler": {"_class_name": "PNDMScheduler", **_BETAS,
                      "skip_prk_steps": True, "steps_offset": 1},
        "text_encoders": [_CLIP_L], "pads": [EOS],
        "model_index": {"_class_name": "StableDiffusionPipeline"},
        "proj": "conv"},
    # stabilityai/stable-diffusion-2-1 (768, v-prediction)
    "sd21": {
        "unet": dict(_SD_UNET, attention_head_dim=[5, 10, 20, 20],
                     cross_attention_dim=1024, sample_size=96,
                     use_linear_projection=True),
        "vae": _SD_VAE,
        "scheduler": {"_class_name": "DDIMScheduler", **_BETAS,
                      "prediction_type": "v_prediction"},
        "text_encoders": [dict(_CLIP_L, hidden_act="gelu", hidden_size=1024,
                               intermediate_size=4096,
                               num_attention_heads=16, num_hidden_layers=23,
                               projection_dim=512)],
        "pads": ["!"],
        "model_index": {"_class_name": "StableDiffusionPipeline"},
        "proj": "linear"},
    # stabilityai/stable-diffusion-xl-base-1.0
    "sdxl": {
        "unet": {"_class_name": "UNet2DConditionModel",
                 "addition_embed_type": "text_time",
                 "addition_time_embed_dim": 256,
                 "attention_head_dim": [5, 10, 20],
                 "block_out_channels": [320, 640, 1280],
                 "cross_attention_dim": 2048,
                 "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                                      "CrossAttnDownBlock2D"],
                 "in_channels": 4, "layers_per_block": 2,
                 "out_channels": 4,
                 "projection_class_embeddings_input_dim": 2816,
                 "sample_size": 128,
                 "transformer_layers_per_block": [1, 2, 10],
                 "up_block_types": ["CrossAttnUpBlock2D",
                                    "CrossAttnUpBlock2D", "UpBlock2D"],
                 "use_linear_projection": True},
        "vae": dict(_SD_VAE, scaling_factor=0.13025, sample_size=1024,
                    force_upcast=True),
        "scheduler": {"_class_name": "EulerDiscreteScheduler", **_BETAS,
                      "prediction_type": "epsilon"},
        "text_encoders": [
            _CLIP_L,
            dict(_CLIP_L, architectures=["CLIPTextModelWithProjection"],
                 hidden_act="gelu", hidden_size=1280,
                 intermediate_size=5120, num_attention_heads=20,
                 num_hidden_layers=32, projection_dim=1280)],
        "pads": [EOS, "!"],
        "model_index": {"_class_name": "StableDiffusionXLPipeline",
                        "force_zeros_for_empty_prompt": True},
        "proj": "linear"},
}


def cut(family: dict, levels: int | None = None, depth: int | None = None,
        encoder_layers: int | None = None, vocab_size: int | None = None
        ) -> dict:
    """The family at its widths with its UNet cut to its first `levels`
    levels (the up path mirrored) and each transformer's depth to
    `depth`, its text encoders to `encoder_layers` layers, their vocab to
    `vocab_size` (at least 514: the byte pieces and the two specials)."""
    fam = copy.deepcopy(family)
    u = fam["unet"]
    if levels:
        n = len(u["block_out_channels"])
        u["block_out_channels"] = u["block_out_channels"][:levels]
        u["down_block_types"] = u["down_block_types"][:levels]
        u["up_block_types"] = u["up_block_types"][n - levels:]
        for key in ("attention_head_dim", "transformer_layers_per_block"):
            if isinstance(u.get(key), list):
                u[key] = u[key][:levels]
    if depth:
        t = u.get("transformer_layers_per_block", 1)
        u["transformer_layers_per_block"] = (
            [min(d, depth) for d in t] if isinstance(t, list)
            else min(t, depth))
    for te in fam["text_encoders"]:
        if encoder_layers:
            te["num_hidden_layers"] = encoder_layers
        if vocab_size:
            te["vocab_size"] = vocab_size
    return fam


def tiny_family(name: str, vocab_size: int = 600) -> dict:
    """FAMILIES[name] at test widths (the CPU tests' and rehearsals'): two
    UNet levels of 32 / 64 channels, 2-wide heads, transformer depth 1
    (SDXL: 1, 2), a two-level VAE of 32 / 64, text encoders of 2 layers at
    widths 32 (SD2.x 48; SDXL's second 48), their vocab `vocab_size`. The
    published field layout is kept: SD2.x's per-level head list, SDXL's
    text_time embedding and encoder pair."""
    fam = cut(FAMILIES[name], levels=2, encoder_layers=2,
              vocab_size=vocab_size)
    u = fam["unet"]
    u["block_out_channels"] = [32, 64]
    u["attention_head_dim"] = ([2, 4] if isinstance(
        u["attention_head_dim"], list) else 2)
    widths = [te["hidden_size"] for te in fam["text_encoders"]]
    for te, w in zip(fam["text_encoders"], widths):
        w = 48 if w > 768 else 32
        te.update(hidden_size=w, intermediate_size=2 * w,
                  num_attention_heads=2, projection_dim=w)
    u["cross_attention_dim"] = sum(te["hidden_size"]
                                   for te in fam["text_encoders"])
    if "transformer_layers_per_block" in u:
        u["transformer_layers_per_block"] = [1, 2]
    if u.get("addition_embed_type"):
        u["addition_time_embed_dim"] = 8
        u["projection_class_embeddings_input_dim"] = \
            fam["text_encoders"][-1]["projection_dim"] + 6 * 8
    fam["vae"] = dict(fam["vae"], block_out_channels=[32, 64],
                      down_block_types=fam["vae"]["down_block_types"][:2],
                      up_block_types=fam["vae"]["up_block_types"][:2])
    return fam


def pipeline_config(family: dict):
    return sd_config_from_dicts(family["unet"], family["vae"],
                                family["scheduler"])


def clip_vocab_merges(vocab_size: int, seed: int = 0
                      ) -> tuple[dict[str, int], str]:
    """CLIP's vocabulary layout at `vocab_size`: the 256 byte-level
    characters, the same with "</w>", one token per merge, then
    <|startoftext|> and <|endoftext|> (EOT the last id); the merges drawn
    from `seed`, mostly over lowercase letters and the tokens they have
    made. Returns (vocab, merges.txt's text)."""
    vocab, merges = _vocab_merges(vocab_size, seed)
    return dict(vocab), merges


@functools.lru_cache(maxsize=8)
def _vocab_merges(vocab_size: int, seed: int) -> tuple[dict[str, int], str]:
    n_merges = vocab_size - 514
    if n_merges < 0:
        raise ValueError(f"a CLIP vocab needs 514 ids, not {vocab_size}")
    rng = np.random.default_rng(seed)
    base = list(bytes_to_unicode().values())
    tokens = base + [b + "</w>" for b in base]
    have = set(tokens)
    pool = list("abcdefghijklmnopqrstuvwxyz")
    merges: list[str] = []
    while len(merges) < n_merges:
        a = pool[rng.integers(len(pool))] if rng.random() < 0.9 \
            else base[rng.integers(256)]
        b = pool[rng.integers(len(pool))] if rng.random() < 0.9 \
            else base[rng.integers(256)]
        if rng.random() < 0.4:
            b += "</w>"
        merged = a + b
        if b not in have or merged in have:
            continue
        have.add(merged)
        tokens.append(merged)
        merges.append(f"{a} {b}")
        if not merged.endswith("</w>"):
            pool.append(merged)
    tokens += [BOS, EOS]
    return ({t: i for i, t in enumerate(tokens)},
            "#version: 0.2\n" + "\n".join(merges) + "\n")


def tokenizer_config(pad: str) -> dict:
    """tokenizer_config.json as the published SD repositories write it."""
    def added(content):
        return {"__type": "AddedToken", "content": content, "lstrip": False,
                "normalized": True, "rstrip": False, "single_word": False}
    return {"add_prefix_space": False, "bos_token": added(BOS),
            "do_lower_case": True, "eos_token": added(EOS),
            "errors": "replace", "model_max_length": 77, "pad_token": pad,
            "tokenizer_class": "CLIPTokenizer", "unk_token": added(EOS)}


@functools.lru_cache(maxsize=8)
def clip_tokenizer(vocab_size: int, pad: str = EOS, seed: int = 0
                   ) -> JsonTokenizer:
    """The tokenizer AutoTokenizer makes of clip_vocab_merges' files (one
    per arguments: a tokenizer holds no state but its word cache)."""
    vocab, merges = _vocab_merges(vocab_size, seed)
    return JsonTokenizer(clip_spec(vocab, merges, tokenizer_config(pad)))


def seeded_sd(family: dict, dtype=torch.bfloat16, device="cuda",
              seed: int = 0, vae_dtype=torch.float32, encoder: bool = True):
    """An SDImageModel (SDXLImageModel for two text encoders) of the
    family's configs from seeded weights drawn on `device`: the UNet and
    encoders in `dtype`, the VAE in `vae_dtype` (float32, as the loader
    keeps it), with its encoder unless `encoder` is False; CLIP
    tokenizers of the encoders' vocab (clip_tokenizer)."""
    cfg = pipeline_config(family)
    params = {"unet": init_unet_params(cfg.unet, seed, dtype, device),
              "vae": init_vae_decoder_params(cfg.vae, seed + 1, vae_dtype,
                                             device)}
    lc = cfg.vae.latent_channels
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    params["vae"]["post_quant_conv"] = {
        "weight": (torch.randn((lc, lc, 1, 1), generator=gen, device=device)
                   * lc ** -0.5).to(vae_dtype),
        "bias": torch.zeros((lc,), dtype=vae_dtype, device=device)}
    if encoder:
        params["vae_enc"] = init_vae_encoder_params(cfg.vae, seed + 3,
                                                    vae_dtype, device)
    encoders = []
    for n, (raw, pad) in enumerate(zip(family["text_encoders"],
                                       family["pads"])):
        ccfg = clip_config_from_dict(raw, with_projection=n == 1)
        encoders.append(SDTextEncoder(
            ccfg, init_clip_params(ccfg, seed + 4 + n, dtype, device),
            clip_tokenizer(ccfg.vocab_size, pad, seed=n), dtype))
    if len(encoders) == 2:
        return SDXLImageModel(cfg, params, encoders[0], encoders[1],
                              dtype=dtype, device=device,
                              force_zeros_for_empty_prompt=family[
                                  "model_index"].get(
                                      "force_zeros_for_empty_prompt", True))
    return SDImageModel(cfg, params, encoders[0], dtype=dtype, device=device)


def _mapped(mapping: dict, tree, expand: dict | None = None) -> dict:
    """{checkpoint name: tensor} through a loader mapping; `expand`: the
    paths whose tensors get the shape the checkpoint stores ([C, C, 1, 1]
    convs, [C, C] linears)."""
    flat = flatten_tree(tree)
    out = {}
    for path, name in mapping.items():
        t = flat[path]
        if expand and path in expand:
            t = expand[path](t)
        out[name] = t
    return out


def _to_conv(t):
    return t.reshape(*t.shape, 1, 1) if t.dim() == 2 else t


def _to_linear(t):
    return t.reshape(t.shape[0], t.shape[1]) if t.dim() == 4 else t


class _Names:
    """A `storage` stand-in for the VAE maps: which attention names."""

    def __init__(self, new_style: bool, prefix: str):
        self.key = prefix + "mid_block.attentions.0.to_q.weight"
        self.new_style = new_style

    def __contains__(self, name):
        return self.new_style and name == self.key


def _json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def write_sd_checkpoint(model_dir: str, family: dict, model,
                        vae_names: str = "new", proj: str | None = None,
                        tokenizer: str = "vocab") -> int:
    """Write `model` (seeded_sd's, or any SDImageModel of the family's
    configs) as a diffusers directory; returns the bytes of tensor data.
    vae_names: "new" (to_q, ..., to_out.0) or "old" (query, ...,
    proj_attn); proj: the spatial transformers' projections as "conv"
    (SD1.x's [C, C, 1, 1]) or "linear" (the family's own by default);
    tokenizer: "vocab" (vocab.json + merges.txt + tokenizer_config.json)
    or "json" (tokenizer.json)."""
    cfg = model.cfg
    os.makedirs(model_dir, exist_ok=True)
    n = 0
    um, _ = sd_unet_mapping(cfg.unet)
    proj = proj or family["proj"]
    expand = {p: _to_conv for p in um if ".proj_in.weight" in p
              or ".proj_out.weight" in p} if proj == "conv" else None
    _json(os.path.join(model_dir, "unet", "config.json"), family["unet"])
    n += save_safetensors(
        os.path.join(model_dir, "unet", "diffusion_pytorch_model.safetensors"),
        _mapped(um, model.params["unet"], expand))
    vae = {}
    vm, _ = sd_vae_decoder_mapping(_Names(vae_names == "new", "decoder."),
                                   cfg.vae)
    attn = {p: _to_linear for p in vm if p.startswith("mid_attn.")
            and p.endswith(".weight") and not p.startswith("mid_attn.norm")}
    vae.update(_mapped(vm, model.params["vae"], attn))
    if "vae_enc" in model.params:
        em, _ = sd_vae_encoder_mapping(_Names(vae_names == "new",
                                              "encoder."), cfg.vae)
        vae.update(_mapped(em, model.params["vae_enc"], attn))
    _json(os.path.join(model_dir, "vae", "config.json"), family["vae"])
    n += save_safetensors(
        os.path.join(model_dir, "vae", "diffusion_pytorch_model.safetensors"),
        vae)
    _json(os.path.join(model_dir, "scheduler", "scheduler_config.json"),
          family["scheduler"])
    _json(os.path.join(model_dir, "model_index.json"), family["model_index"])
    encoders = [model.text_encoder] + ([model.text_encoder2] if hasattr(
        model, "text_encoder2") else [])
    for i, (enc, raw, pad) in enumerate(zip(encoders,
                                            family["text_encoders"],
                                            family["pads"])):
        sfx = f"_{i + 1}" if i else ""
        te = os.path.join(model_dir, "text_encoder" + sfx)
        _json(os.path.join(te, "config.json"), raw)
        n += save_safetensors(os.path.join(te, "model.safetensors"),
                              _mapped(clip_mapping(enc.cfg), enc.params))
        tok = os.path.join(model_dir, "tokenizer" + sfx)
        vocab, merges = clip_vocab_merges(enc.cfg.vocab_size, seed=i)
        if tokenizer == "json":
            _json(os.path.join(tok, "tokenizer.json"),
                  clip_spec(vocab, merges, tokenizer_config(pad)))
        else:
            _json(os.path.join(tok, "vocab.json"), vocab)
            with open(os.path.join(tok, "merges.txt"), "w",
                      encoding="utf-8") as f:
                f.write(merges)
            _json(os.path.join(tok, "tokenizer_config.json"),
                  tokenizer_config(pad))
            _json(os.path.join(tok, "special_tokens_map.json"),
                  {"bos_token": BOS, "eos_token": EOS, "pad_token": pad,
                   "unk_token": EOS})
    return n
