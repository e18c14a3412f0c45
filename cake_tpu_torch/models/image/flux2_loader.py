"""FLUX.2-klein checkpoint loading, diffusers layout (counterpart of
cake_tpu/models/image/flux2_loader.py: Flux2Checkpoint,
detect_flux2_checkpoint, flux2_transformer_mapping, flux2_vae_mapping,
infer_flux2_configs, load_flux2_image_model), and klein-4B's widths from
a seed (`seeded_flux2`, the card's full-width demo).

    model_index.json              {"_class_name": "Flux2Pipeline", ...}
    transformer/*.safetensors     diffusers Flux2Transformer2DModel names
    vae/*.safetensors             decoder.*, post_quant_conv.*, bn.*
    text_encoder/                 a Qwen3 HF checkpoint (config.json)
    tokenizer/tokenizer.json      Qwen's tokenizer

Configs come from tensor shapes; a `flux_config.json` sidecar ({"flux2":
{...}, "vae": {...}, "encoder": {...}}) overrides what shapes cannot
tell (the RoPE axes split, the capture layers). The transformer and the
encoder load in the model dtype, the VAE in float32. The encoder loads
through the port's text loader, cut after its last capture layer (the
reference computes every layer and discards the top ones: the same
captures). The tokenizer is read by utils/bpe.py (the card's machine has
no `tokenizers`) and encodes without added special tokens; the pad id is
<|endoftext|>'s, or 151643.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os

import torch

from ...device import resolve_device
from ...utils.bpe import JsonTokenizer
from ...utils.mapping import coverage_report, load_mapped_params
from ...utils.safetensors_io import TensorStorage
from ..common.config import config_from_hf_dict
from ..common.layers import init_params
from .flux2 import (Flux2Config, Flux2ImageModel, Flux2PipelineConfig,
                    Flux2TextEncoder, default_output_layers,
                    init_flux2_params)
from .vae import VaeConfig, init_vae_decoder_params

log = logging.getLogger("cake_tpu_torch.flux2_loader")

QWEN_PAD_ID = 151643            # <|endoftext|> in Qwen's vocabulary

# Qwen3-4B's text config (FLUX.2-klein's text_encoder/config.json), from
# memory: widths as published for Qwen3-4B; the rope theta, eps and
# context length are assumed
QWEN3_4B = dict(architectures=["Qwen3ForCausalLM"], vocab_size=151936,
                hidden_size=2560, intermediate_size=9728,
                num_hidden_layers=36, num_attention_heads=32,
                num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-6,
                rope_theta=1000000.0, max_position_embeddings=40960,
                tie_word_embeddings=True, eos_token_id=151645)


@dataclasses.dataclass
class Flux2Checkpoint:
    transformer: TensorStorage
    vae: TensorStorage
    text_encoder_dir: str
    tokenizer_path: str
    model_dir: str


def detect_flux2_checkpoint(path: str) -> Flux2Checkpoint | None:
    """A diffusers FLUX.2 pipeline directory's storages, or None."""
    if not os.path.isdir(path):
        return None
    tdir, vdir, edir = (os.path.join(path, d)
                        for d in ("transformer", "vae", "text_encoder"))
    if not all(os.path.isdir(d) for d in (tdir, vdir, edir)):
        return None
    try:
        tst = TensorStorage.from_model_dir(tdir)
    except FileNotFoundError:
        return None
    # the shared-modulation tensors are FLUX.2's alone
    if not any(n.startswith("double_stream_modulation_img.")
               for n in tst.names()):
        mi = os.path.join(path, "model_index.json")
        is_flux2 = False
        if os.path.exists(mi):
            with open(mi) as f:
                is_flux2 = json.load(f).get("_class_name") == "Flux2Pipeline"
        if not is_flux2:
            tst.close()
            return None
    try:
        vst = TensorStorage.from_model_dir(vdir)
    except FileNotFoundError:
        tst.close()
        return None
    tok = os.path.join(path, "tokenizer", "tokenizer.json")
    if not os.path.exists(tok):
        tok = os.path.join(edir, "tokenizer.json")
    return Flux2Checkpoint(transformer=tst, vae=vst, text_encoder_dir=edir,
                           tokenizer_path=tok, model_dir=path)


# ---------------------------------------------------------------------------
# Name mappings (tree path -> diffusers tensor name)
# ---------------------------------------------------------------------------


def flux2_transformer_mapping(cfg: Flux2Config) -> dict[str, str]:
    m = {
        "x_embedder.weight": "x_embedder.weight",
        "context_embedder.weight": "context_embedder.weight",
        "time_mlp.in.weight":
            "time_guidance_embed.timestep_embedder.linear_1.weight",
        "time_mlp.out.weight":
            "time_guidance_embed.timestep_embedder.linear_2.weight",
        "double_mod_img.weight": "double_stream_modulation_img.linear.weight",
        "double_mod_txt.weight": "double_stream_modulation_txt.linear.weight",
        "single_mod.weight": "single_stream_modulation.linear.weight",
        "norm_out.weight": "norm_out.linear.weight",
        "proj_out.weight": "proj_out.weight",
    }
    for i in range(cfg.depth_double):
        src, dst = f"transformer_blocks.{i}.", f"double.{i}."
        for ours, theirs in (("img_attn.q", "attn.to_q"),
                             ("img_attn.k", "attn.to_k"),
                             ("img_attn.v", "attn.to_v"),
                             ("img_attn.o", "attn.to_out.0"),
                             ("txt_attn.q", "attn.add_q_proj"),
                             ("txt_attn.k", "attn.add_k_proj"),
                             ("txt_attn.v", "attn.add_v_proj"),
                             ("txt_attn.o", "attn.to_add_out"),
                             ("ff.linear_in", "ff.linear_in"),
                             ("ff.linear_out", "ff.linear_out"),
                             ("ff_context.linear_in", "ff_context.linear_in"),
                             ("ff_context.linear_out",
                              "ff_context.linear_out"),
                             ("img_attn.q_norm", "attn.norm_q"),
                             ("img_attn.k_norm", "attn.norm_k"),
                             ("txt_attn.q_norm", "attn.norm_added_q"),
                             ("txt_attn.k_norm", "attn.norm_added_k")):
            m[f"{dst}{ours}.weight"] = f"{src}{theirs}.weight"
    for i in range(cfg.depth_single):
        src, dst = f"single_transformer_blocks.{i}.", f"single.{i}."
        m[f"{dst}to_qkv_mlp.weight"] = f"{src}attn.to_qkv_mlp_proj.weight"
        m[f"{dst}to_out.weight"] = f"{src}attn.to_out.weight"
        m[f"{dst}q_norm.weight"] = f"{src}attn.norm_q.weight"
        m[f"{dst}k_norm.weight"] = f"{src}attn.norm_k.weight"
    return m


def _to_1x1(a: torch.Tensor) -> torch.Tensor:
    """A linear's (c, c) weight as a 1x1 convolution's (c, c, 1, 1)."""
    return a.reshape(*a.shape, 1, 1)


def flux2_vae_mapping(cfg: VaeConfig) -> tuple[dict[str, str], dict]:
    """AutoencoderKLFlux2's decoder names (up_blocks in processing order,
    the mid attention's projections as linears: the transforms reshape
    them to the decoder's 1x1 convolutions) and post_quant_conv."""
    def conv(dst, src):
        return {f"{dst}.weight": f"{src}.weight", f"{dst}.bias": f"{src}.bias"}

    def resnet(dst, src, has_shortcut):
        mm = {}
        for name in ("norm1", "conv1", "norm2", "conv2"):
            mm.update(conv(f"{dst}.{name}", f"{src}.{name}"))
        if has_shortcut:
            mm.update(conv(f"{dst}.shortcut", f"{src}.conv_shortcut"))
        return mm

    d = "decoder."
    chs = [cfg.base_channels * mlt for mlt in cfg.channel_mults]
    m: dict[str, str] = {}
    transforms: dict = {}
    m.update(conv("post_quant_conv", "post_quant_conv"))
    m.update(conv("conv_in", f"{d}conv_in"))
    m.update(resnet("mid_res1", f"{d}mid_block.resnets.0", False))
    m.update(resnet("mid_res2", f"{d}mid_block.resnets.1", False))
    attn = f"{d}mid_block.attentions.0"
    for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                         ("proj", "to_out.0")):
        m.update(conv(f"mid_attn.{ours}", f"{attn}.{theirs}"))
        transforms[f"mid_attn.{ours}.weight"] = _to_1x1
    m.update(conv("mid_attn.norm", f"{attn}.group_norm"))
    cin = chs[-1]
    for k, c in enumerate(reversed(chs)):
        src = f"{d}up_blocks.{k}"
        for j in range(cfg.num_res_blocks):
            m.update(resnet(f"ups.{k}.res.{j}", f"{src}.resnets.{j}",
                            has_shortcut=cin != c))
            cin = c
        if k < len(chs) - 1:
            m.update(conv(f"ups.{k}.upsample", f"{src}.upsamplers.0.conv"))
    m.update(conv("norm_out", f"{d}conv_norm_out"))
    m.update(conv("conv_out", f"{d}conv_out"))
    return m, transforms


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def _count(storage, fmt: str) -> int:
    i = 0
    while fmt.format(i) in storage:
        i += 1
    return i


def infer_flux2_configs(ckpt: Flux2Checkpoint) -> dict:
    """{"flux2": Flux2Config, "vae": VaeConfig, "encoder_over": {...}}
    from the shapes and the sidecar."""
    over: dict = {}
    sidecar = os.path.join(ckpt.model_dir, "flux_config.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            over = json.load(f)
    rec = ckpt.transformer.records
    hidden, in_ch = rec["x_embedder.weight"].shape
    head_dim = rec["transformer_blocks.0.attn.norm_q.weight"].shape[0]
    mlp2 = rec["transformer_blocks.0.ff.linear_in.weight"].shape[0]
    t = dict(
        in_channels=in_ch, hidden_size=hidden,
        num_heads=hidden // head_dim, head_dim=head_dim,
        mlp_ratio=(mlp2 // 2) / hidden,
        depth_double=_count(ckpt.transformer,
                            "transformer_blocks.{}.attn.to_q.weight"),
        depth_single=_count(
            ckpt.transformer,
            "single_transformer_blocks.{}.attn.to_qkv_mlp_proj.weight"),
        context_in_dim=rec["context_embedder.weight"].shape[1],
        axes_dims=(head_dim // 4,) * 4,           # klein: (32,) * 4 of 128
        theta=2000.0,
    )
    t.update(over.get("flux2", {}))
    t["axes_dims"] = tuple(t["axes_dims"])
    vrec = ckpt.vae.records
    n_lv = _count(ckpt.vae, "decoder.up_blocks.{}.resnets.0.conv1.weight")
    base = vrec["decoder.conv_out.weight"].shape[1]
    # up_blocks run high channels first; channel_mults list low first
    outs = [vrec[f"decoder.up_blocks.{k}.resnets.0.conv2.weight"].shape[0]
            for k in range(n_lv)]
    vae = dict(
        latent_channels=vrec["decoder.conv_in.weight"].shape[1],
        base_channels=base,
        channel_mults=tuple(c // base for c in reversed(outs)),
        num_res_blocks=_count(ckpt.vae,
                              "decoder.up_blocks.0.resnets.{}.conv1.weight"),
        scaling_factor=1.0, shift_factor=0.0,
    )
    vae.update(over.get("vae", {}))
    vae["channel_mults"] = tuple(vae["channel_mults"])
    return {"flux2": Flux2Config(**t), "vae": VaeConfig(**vae),
            "encoder_over": over.get("encoder", {})}


def token_id(tokenizer: JsonTokenizer, content: str) -> int | None:
    """A token's id: an added token's, else the vocab's, else None."""
    if content in tokenizer.added:
        return tokenizer.added[content]
    return tokenizer.vocab.get(content)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def load_flux2_image_model(path, dtype=torch.bfloat16,
                           max_txt_len: int = 512, device=None):
    """A FLUX.2 pipeline directory (or a detected Flux2Checkpoint) as a
    ready Flux2ImageModel on `device` (default `cuda`)."""
    from ...utils.loaders import load_model_params
    ckpt = path if isinstance(path, Flux2Checkpoint) \
        else detect_flux2_checkpoint(path)
    if ckpt is None:
        raise ValueError(
            f"{path!r} is not a FLUX.2 pipeline directory (expected "
            "transformer/ + vae/ + text_encoder/ subdirs with "
            "double_stream_modulation_img.* transformer tensors or a "
            "Flux2Pipeline model_index.json)")
    dev = resolve_device(device)
    try:
        cfgs = infer_flux2_configs(ckpt)
        t_cfg, v_cfg = cfgs["flux2"], cfgs["vae"]
        tmap = flux2_transformer_mapping(t_cfg)
        params = {"transformer": load_mapped_params(
            ckpt.transformer, tmap,
            init_flux2_params(t_cfg, 0, dtype, "meta"), dtype, dev)}
        coverage_report(ckpt.transformer, tmap)
        vmap, vtrans = flux2_vae_mapping(v_cfg)
        vae_shapes = init_vae_decoder_params(v_cfg, 0, torch.float32, "meta")
        # post_quant_conv is diffusers' alone: without it in the expected
        # tree the load would drop it
        lc = v_cfg.latent_channels
        vae_shapes["post_quant_conv"] = {
            "weight": torch.empty((lc, lc, 1, 1), device="meta"),
            "bias": torch.empty((lc,), device="meta")}
        params["vae"] = load_mapped_params(ckpt.vae, vmap, vae_shapes,
                                           torch.float32, dev,
                                           transforms=vtrans)
        coverage_report(ckpt.vae, vmap,
                        ignore=("encoder.", "quant_conv.", "bn."))
        bn = None
        if "bn.running_mean" in ckpt.vae:
            bn = (ckpt.vae.read("bn.running_mean").float(),
                  ckpt.vae.read("bn.running_var").float())
    finally:
        ckpt.transformer.close()
        ckpt.vae.close()
    with open(os.path.join(ckpt.text_encoder_dir, "config.json")) as f:
        enc_cfg = config_from_hf_dict(json.load(f))
    output_layers = tuple(cfgs["encoder_over"].get(
        "output_layers", default_output_layers(enc_cfg.num_hidden_layers)))
    if t_cfg.context_in_dim != len(output_layers) * enc_cfg.hidden_size:
        raise ValueError(
            f"transformer context dim {t_cfg.context_in_dim} != "
            f"{len(output_layers)} captures x encoder hidden "
            f"{enc_cfg.hidden_size}")
    enc_params = load_model_params(
        enc_cfg, ckpt.text_encoder_dir, dtype, dev,
        layer_range=(0, max(output_layers) + 1), include_embed=True,
        include_head=False)
    tokenizer = JsonTokenizer.from_file(ckpt.tokenizer_path)
    pad_id = token_id(tokenizer, "<|endoftext|>")
    encoder = Flux2TextEncoder(
        enc_cfg, enc_params, tokenizer=tokenizer, max_len=max_txt_len,
        output_layers=output_layers,
        pad_id=QWEN_PAD_ID if pad_id is None else pad_id, dtype=dtype)
    model = Flux2ImageModel(
        Flux2PipelineConfig(transformer=t_cfg, vae=v_cfg,
                            max_txt_len=max_txt_len),
        params=params, text_encoder=encoder, bn_stats=bn, dtype=dtype,
        device=dev)
    log.info("loaded FLUX.2 checkpoint: %d double + %d single blocks, "
             "hidden %d, encoder %d layers (captures %s)",
             t_cfg.depth_double, t_cfg.depth_single, t_cfg.hidden_size,
             max(output_layers) + 1, output_layers)
    return model


def klein_4b_configs() -> dict:
    """FLUX.2-klein-4B's component configs: the transformer, the 32-channel
    VAE, the Qwen3-4B encoder (its HF dict) and the capture layers."""
    pipe = Flux2PipelineConfig()
    return {"flux2": pipe.transformer, "vae": pipe.vae,
            "encoder": dict(QWEN3_4B),
            "output_layers": default_output_layers(
                QWEN3_4B["num_hidden_layers"])}


def seeded_flux2(cfgs: dict | None = None, dtype=torch.bfloat16, device=None,
                 seed: int = 42, max_txt_len: int = 512, tokenizer=None):
    """A Flux2ImageModel from seeded weights drawn on the device
    (klein-4B's configs by default): the transformer and the encoder
    (layers 0..max(captures) only) in `dtype`, the VAE in float32, and
    Qwen's specials in a byte-level BPE (bench/synth_flux2.qwen_tokenizer)
    unless a tokenizer is given."""
    cfgs = cfgs or klein_4b_configs()
    dev = resolve_device(device)
    enc_cfg = config_from_hf_dict(cfgs["encoder"])
    layers = max(cfgs["output_layers"]) + 1
    enc = init_params(dataclasses.replace(enc_cfg, num_hidden_layers=layers),
                      seed + 2, dtype, dev, gen_device=dev)
    enc.pop("norm", None)
    if tokenizer is None:
        from ...bench.synth_flux2 import qwen_tokenizer
        tokenizer = JsonTokenizer(qwen_tokenizer(enc_cfg.vocab_size))
    pad_id = token_id(tokenizer, "<|endoftext|>")
    encoder = Flux2TextEncoder(enc_cfg, enc, tokenizer=tokenizer,
                               max_len=max_txt_len,
                               output_layers=cfgs["output_layers"],
                               pad_id=QWEN_PAD_ID if pad_id is None
                               else pad_id, dtype=dtype)
    pipe = Flux2PipelineConfig(transformer=cfgs["flux2"], vae=cfgs["vae"],
                               max_txt_len=max_txt_len)
    model = Flux2ImageModel(pipe, text_encoder=encoder, dtype=dtype,
                            seed=seed, device=dev)
    # a published VAE has a post_quant_conv (the loaders require one): the
    # identity here, so a written directory loads to this same tree
    lc = cfgs["vae"].latent_channels
    model.params["vae"]["post_quant_conv"] = {
        "weight": torch.eye(lc, device=dev).reshape(lc, lc, 1, 1),
        "bias": torch.zeros(lc, device=dev)}
    return model
