"""Stable Diffusion checkpoints in the diffusers directory layout
(counterpart of cake_tpu/models/image/sd_loader.py: sd_unet_mapping,
sd_vae_decoder_mapping, sd_vae_encoder_mapping, detect_sd_checkpoint,
sd_configs_from_dir, SDTextEncoder, load_sd_image_model).

    model_dir/
      unet/config.json + diffusion_pytorch_model.safetensors
      vae/config.json + diffusion_pytorch_model.safetensors
      text_encoder/config.json + model.safetensors      (HF CLIPTextModel)
      tokenizer/tokenizer.json | vocab.json + merges.txt
      scheduler/scheduler_config.json     (optional: prediction_type, betas)
      text_encoder_2/, tokenizer_2/       (SDXL; CLIPTextModelWithProjection)
      model_index.json                    (optional: SDXL's
                                           force_zeros_for_empty_prompt)

The configs come from the diffusers config.json files, the tensors by
their published names: SD1.x's spatial-transformer projections stored as
1x1 convs are squeezed to linears (SD2.x and SDXL store linears), and
the VAE's mid-block attention loads under either name generation (to_q
... or query ...). The UNet and text encoders load in the model dtype,
the VAE in float32; a VAE without encoder weights loads decoder-only
(img2img then raises). Tokenizers: tokenizer.json, else vocab.json +
merges.txt read as AutoTokenizer reads them (utils/bpe.load_tokenizer).
"""
from __future__ import annotations

import json
import logging
import os

import torch

from ...device import resolve_device
from ...utils.bpe import load_tokenizer
from ...utils.mapping import coverage_report, load_mapped_params
from ...utils.safetensors_io import TensorStorage
from ..text_encoders import (CLIPTextConfig, clip_mapping, clip_text_forward,
                             init_clip_params)
from .sd import SDPipelineConfig, UNetConfig, init_unet_params
from .vae import VaeConfig, init_vae_decoder_params, init_vae_encoder_params

log = logging.getLogger("cake_tpu_torch.sd_loader")


def _squeeze_conv(t: torch.Tensor) -> torch.Tensor:
    """[C, C', 1, 1] conv kernel -> [C, C'] linear weight."""
    return t.reshape(t.shape[0], t.shape[1]) if t.dim() == 4 else t


def _expand_conv(t: torch.Tensor) -> torch.Tensor:
    """[C, C'] linear weight -> [C, C', 1, 1] conv kernel (newer diffusers
    VAEs store their attention as linears; ours are 1x1 convs)."""
    return t.reshape(*t.shape, 1, 1) if t.dim() == 2 else t


def sd_unet_mapping(cfg: UNetConfig) -> tuple[dict, dict]:
    """(mapping, transforms): parameter path -> diffusers UNet tensor
    name, and the projections' squeeze."""
    m: dict[str, str] = {}
    tr: dict[str, object] = {}

    def conv(dst, src):
        m[f"{dst}.weight"] = f"{src}.weight"
        m[f"{dst}.bias"] = f"{src}.bias"

    def resnet(dst, src, has_shortcut):
        for ours, theirs in (("norm1", "norm1"), ("conv1", "conv1"),
                             ("time", "time_emb_proj"), ("norm2", "norm2"),
                             ("conv2", "conv2")):
            conv(f"{dst}.{ours}", f"{src}.{theirs}")
        if has_shortcut:
            conv(f"{dst}.shortcut", f"{src}.conv_shortcut")

    def xattn(dst, src, depth):
        conv(f"{dst}.norm", f"{src}.norm")
        for pj in ("proj_in", "proj_out"):
            conv(f"{dst}.{pj}", f"{src}.{pj}")
            tr[f"{dst}.{pj}.weight"] = _squeeze_conv
        for d in range(depth):
            t = f"{src}.transformer_blocks.{d}"
            b = f"{dst}.blocks.{d}"
            for ln in ("norm1", "norm2", "norm3"):
                conv(f"{b}.{ln}", f"{t}.{ln}")
            for blk, ours in (("attn1", "self"), ("attn2", "cross")):
                for proj in ("q", "k", "v"):
                    m[f"{b}.{ours}_{proj}.weight"] = \
                        f"{t}.{blk}.to_{proj}.weight"
                conv(f"{b}.{ours}_o", f"{t}.{blk}.to_out.0")
            conv(f"{b}.ff1", f"{t}.ff.net.0.proj")
            conv(f"{b}.ff2", f"{t}.ff.net.2")

    conv("conv_in", "conv_in")
    conv("time_mlp1", "time_embedding.linear_1")
    conv("time_mlp2", "time_embedding.linear_2")
    if cfg.addition_embed_dim:
        conv("add_mlp1", "add_embedding.linear_1")
        conv("add_mlp2", "add_embedding.linear_2")
    conv("norm_out", "conv_norm_out")
    conv("conv_out", "conv_out")
    chs = [cfg.base_channels * mlt for mlt in cfg.channel_mults]
    n_lv = len(chs)
    cin = cfg.base_channels
    for lvl, c in enumerate(chs):
        src, dst = f"down_blocks.{lvl}", f"down.{lvl}"
        for j in range(cfg.num_res_blocks):
            resnet(f"{dst}.res.{j}", f"{src}.resnets.{j}", cin != c)
            if lvl in cfg.attn_levels:
                xattn(f"{dst}.attn.{j}", f"{src}.attentions.{j}",
                      cfg.depth_at(lvl))
            cin = c
        if lvl < n_lv - 1:
            conv(f"{dst}.down", f"{src}.downsamplers.0.conv")
    resnet("mid_res1", "mid_block.resnets.0", False)
    xattn("mid_attn", "mid_block.attentions.0", cfg.depth_at(n_lv - 1))
    resnet("mid_res2", "mid_block.resnets.1", False)
    # up_blocks.0 runs first (the deepest level); every up resnet takes a
    # skip concatenation, so each has a conv_shortcut
    for k, lvl in enumerate(reversed(range(n_lv))):
        src, dst = f"up_blocks.{k}", f"up.{k}"
        for j in range(cfg.num_res_blocks + 1):
            resnet(f"{dst}.res.{j}", f"{src}.resnets.{j}", True)
            if lvl in cfg.attn_levels:
                xattn(f"{dst}.attn.{j}", f"{src}.attentions.{j}",
                      cfg.depth_at(lvl))
        if lvl > 0:
            conv(f"{dst}.up", f"{src}.upsamplers.0.conv")
    return m, tr


def _vae_map_helpers(m: dict):
    """(conv, resnet) emitters shared by the encoder and decoder maps."""
    def conv(dst, src):
        m[f"{dst}.weight"] = f"{src}.weight"
        m[f"{dst}.bias"] = f"{src}.bias"

    def resnet(dst, src, has_shortcut):
        for name in ("norm1", "conv1", "norm2", "conv2"):
            conv(f"{dst}.{name}", f"{src}.{name}")
        if has_shortcut:
            conv(f"{dst}.shortcut", f"{src}.conv_shortcut")
    return conv, resnet


def _vae_map_mid_attention(m: dict, tr: dict, storage, a: str) -> None:
    """mid_block.attentions.0 under the name generation the checkpoint
    holds (to_q / to_k / to_v / to_out.0, or query / key / value /
    proj_attn)."""
    conv, _ = _vae_map_helpers(m)
    new_style = f"{a}.to_q.weight" in storage
    names = ((("norm", "group_norm"), ("q", "to_q"), ("k", "to_k"),
              ("v", "to_v"), ("proj", "to_out.0")) if new_style else
             (("norm", "group_norm"), ("q", "query"), ("k", "key"),
              ("v", "value"), ("proj", "proj_attn")))
    for ours, theirs in names:
        conv(f"mid_attn.{ours}", f"{a}.{theirs}")
        if ours != "norm":
            tr[f"mid_attn.{ours}.weight"] = _expand_conv


def sd_vae_decoder_mapping(storage, cfg: VaeConfig,
                           prefix: str = "") -> tuple[dict, dict]:
    """diffusers AutoencoderKL decoder names, post_quant_conv included."""
    m: dict[str, str] = {}
    tr: dict[str, object] = {}
    conv, resnet = _vae_map_helpers(m)
    d = f"{prefix}decoder."
    conv("post_quant_conv", f"{prefix}post_quant_conv")
    conv("conv_in", f"{d}conv_in")
    resnet("mid_res1", f"{d}mid_block.resnets.0", False)
    resnet("mid_res2", f"{d}mid_block.resnets.1", False)
    _vae_map_mid_attention(m, tr, storage, f"{d}mid_block.attentions.0")
    chs = [cfg.base_channels * mlt for mlt in cfg.channel_mults]
    cin = chs[-1]
    for k, c in enumerate(reversed(chs)):   # up_blocks.0 runs first
        src = f"{d}up_blocks.{k}"
        for j in range(cfg.num_res_blocks):
            resnet(f"ups.{k}.res.{j}", f"{src}.resnets.{j}", cin != c)
            cin = c
        if k < len(chs) - 1:
            conv(f"ups.{k}.upsample", f"{src}.upsamplers.0.conv")
    conv("norm_out", f"{d}conv_norm_out")
    conv("conv_out", f"{d}conv_out")
    return m, tr


def sd_vae_encoder_mapping(storage, cfg: VaeConfig) -> tuple[dict, dict]:
    """diffusers AutoencoderKL encoder names, quant_conv included (the
    img2img entry: pixels -> the posterior's latent)."""
    m: dict[str, str] = {}
    tr: dict[str, object] = {}
    conv, resnet = _vae_map_helpers(m)
    e = "encoder."
    conv("quant_conv", "quant_conv")
    conv("conv_in", f"{e}conv_in")
    chs = [cfg.base_channels * mlt for mlt in cfg.channel_mults]
    n_res = max(cfg.num_res_blocks - 1, 1)
    cin = chs[0]
    for i, c in enumerate(chs):
        src = f"{e}down_blocks.{i}"
        for j in range(n_res):
            resnet(f"downs.{i}.res.{j}", f"{src}.resnets.{j}", cin != c)
            cin = c
        if i < len(chs) - 1:
            conv(f"downs.{i}.downsample", f"{src}.downsamplers.0.conv")
    resnet("mid_res1", f"{e}mid_block.resnets.0", False)
    resnet("mid_res2", f"{e}mid_block.resnets.1", False)
    _vae_map_mid_attention(m, tr, storage, f"{e}mid_block.attentions.0")
    conv("norm_out", f"{e}conv_norm_out")
    conv("conv_out", f"{e}conv_out")
    return m, tr


# -- detection and configs ----------------------------------------------------

def detect_sd_checkpoint(path: str) -> bool:
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "unet", "config.json"))
            and os.path.exists(os.path.join(path, "vae", "config.json")))


def _load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def sd_configs_from_dir(model_dir: str) -> SDPipelineConfig:
    """The pipeline's config from unet/, vae/ and scheduler/ config.json
    (the scheduler's optional)."""
    sched_path = os.path.join(model_dir, "scheduler", "scheduler_config.json")
    return sd_config_from_dicts(
        _load_json(model_dir, "unet", "config.json"),
        _load_json(model_dir, "vae", "config.json"),
        _load_json(sched_path) if os.path.exists(sched_path) else {})


def sd_config_from_dicts(u: dict, v: dict, sched: dict) -> SDPipelineConfig:
    """The pipeline's config from the three diffusers config dicts."""
    add_type = u.get("addition_embed_type")
    if add_type not in (None, "text_time"):
        raise NotImplementedError(
            f"addition_embed_type={add_type!r} is not supported "
            "(SDXL's 'text_time' and plain SD1.x/2.x load fine)")
    blocks = u["block_out_channels"]
    base = blocks[0]
    attn_levels = tuple(i for i, t in enumerate(u["down_block_types"])
                        if "CrossAttn" in t)
    # diffusers' `attention_head_dim` holds HEAD COUNTS: an int for SD1.x
    # (8 everywhere), a per-level list for SD2.x (64-wide heads)
    head_dim = u.get("attention_head_dim", 8)
    num_heads = tuple(head_dim) if isinstance(head_dim, list) else head_dim
    if isinstance(num_heads, tuple) and len(num_heads) != len(blocks):
        raise ValueError(
            f"attention_head_dim list has {len(num_heads)} entries for "
            f"{len(blocks)} UNet levels")
    depth = u.get("transformer_layers_per_block", 1)
    unet = UNetConfig(
        in_channels=u["in_channels"], base_channels=base,
        channel_mults=tuple(c // base for c in blocks),
        num_res_blocks=u.get("layers_per_block", 2),
        attn_levels=attn_levels, num_heads=num_heads,
        context_dim=u["cross_attention_dim"], time_dim=base * 4,
        transformer_depth=tuple(depth) if isinstance(depth, list) else depth,
        addition_embed_dim=(u.get("projection_class_embeddings_input_dim")
                            if add_type == "text_time" else None),
        addition_time_embed_dim=u.get("addition_time_embed_dim", 256))
    vbase = v["block_out_channels"][0]
    vae = VaeConfig(
        latent_channels=v["latent_channels"], base_channels=vbase,
        channel_mults=tuple(c // vbase for c in v["block_out_channels"]),
        num_res_blocks=v.get("layers_per_block", 2) + 1,
        scaling_factor=v.get("scaling_factor", 0.18215),
        shift_factor=v.get("shift_factor") or 0.0)
    # the scheduler's config carries the parameterization (SD2.1-768 is
    # v-prediction) and the training betas
    return SDPipelineConfig(
        unet=unet, vae=vae,
        prediction_type=sched.get("prediction_type", "epsilon"),
        beta_start=sched.get("beta_start", 0.00085),
        beta_end=sched.get("beta_end", 0.012),
        beta_schedule=sched.get("beta_schedule", "scaled_linear"))


# -- text encoders ------------------------------------------------------------

class SDTextEncoder:
    """prompt -> (CLIP hidden states, pooled, penultimate), the ids cut or
    padded with EOT to max_positions (77), on the parameters' device.
    `__call__` gives (hidden, pooled), SD1.x / 2.x's conditioning;
    `encode3` all three, for SDXL."""

    def __init__(self, cfg: CLIPTextConfig, params: dict, tokenizer,
                 dtype=torch.float32):
        self.cfg, self.params, self.dtype = cfg, params, dtype
        self.tokenizer = tokenizer

    def ids(self, prompt: str) -> list[int]:
        n, eot = self.cfg.max_positions, self.cfg.eot_token_id
        ids = self.tokenizer.encode(prompt)
        if len(ids) > n:
            ids = ids[:n]
            ids[-1] = eot
        return ids + [eot] * (n - len(ids))

    @torch.inference_mode()
    def encode3(self, prompt: str):
        dev = self.params["token_embedding"]["weight"].device
        ids = torch.tensor([self.ids(prompt)], dtype=torch.long, device=dev)
        hidden, pooled, penult = clip_text_forward(self.cfg, self.params, ids)
        return (hidden.to(self.dtype), pooled.to(self.dtype),
                penult.to(self.dtype))

    def __call__(self, prompt: str):
        hidden, pooled, _ = self.encode3(prompt)
        return hidden, pooled


def clip_config_from_dict(raw: dict, with_projection: bool = False
                          ) -> CLIPTextConfig:
    """A text_encoder/config.json as the reference reads it."""
    vocab = raw.get("vocab_size", 49408)
    return CLIPTextConfig(
        vocab_size=vocab, hidden_size=raw.get("hidden_size", 768),
        num_layers=raw.get("num_hidden_layers", 12),
        num_heads=raw.get("num_attention_heads", 12),
        intermediate_size=raw.get("intermediate_size", 3072),
        max_positions=raw.get("max_position_embeddings", 77),
        # NOT config.json's eos_token_id: the published CLIP configs say 2,
        # the real EOT is vocab - 1 (49407)
        eot_token_id=raw.get("eot_token_id", vocab - 1),
        # SD2.x and SDXL's OpenCLIP encoders use the exact gelu
        hidden_act=raw.get("hidden_act", "quick_gelu"),
        projection_dim=raw.get("projection_dim") if with_projection
        else None)


def _load_clip_encoder(path: str, subdir: str, tokenizer_subdir: str,
                       dtype, device, with_projection: bool = False
                       ) -> SDTextEncoder:
    te_dir = os.path.join(path, subdir)
    cfg_path = os.path.join(te_dir, "config.json")
    cfg = clip_config_from_dict(_load_json(cfg_path)
                                if os.path.exists(cfg_path) else {},
                                with_projection)
    storage = TensorStorage.from_model_dir(te_dir)
    cmap = clip_mapping(cfg)
    params = load_mapped_params(storage, cmap,
                                init_clip_params(cfg, 0, dtype, "meta"),
                                dtype, device)
    coverage_report(storage, cmap,
                    ignore=("text_model.embeddings.position_ids",))
    return SDTextEncoder(cfg, params,
                         load_tokenizer(os.path.join(path, tokenizer_subdir)),
                         dtype)


# -- the pipeline --------------------------------------------------------------

def load_sd_params(path: str, cfg: SDPipelineConfig, dtype=torch.bfloat16,
                   device=None) -> dict:
    """{"unet", "vae", and "vae_enc" when the VAE has encoder weights} on
    `device`: the UNet in `dtype`, the VAE in float32; every tensor
    checked against its shape, unread ones reported."""
    dev = resolve_device(device)
    unet_st = TensorStorage.from_model_dir(os.path.join(path, "unet"))
    um, ut = sd_unet_mapping(cfg.unet)
    params = {"unet": load_mapped_params(
        unet_st, um, init_unet_params(cfg.unet, 0, dtype, "meta"), dtype,
        dev, transforms=ut)}
    coverage_report(unet_st, um)
    vae_st = TensorStorage.from_model_dir(os.path.join(path, "vae"))
    vm, vt = sd_vae_decoder_mapping(vae_st, cfg.vae)
    expected = init_vae_decoder_params(cfg.vae, 0, torch.float32, "meta")
    # post_quant_conv is diffusers' only: the init tree has none
    lc = cfg.vae.latent_channels
    expected["post_quant_conv"] = {
        "weight": torch.empty((lc, lc, 1, 1), device="meta"),
        "bias": torch.empty((lc,), device="meta")}
    params["vae"] = load_mapped_params(vae_st, vm, expected, torch.float32,
                                       dev, transforms=vt)
    # the coverage map by checkpoint name: the two halves share paths
    cov, ignore = {n: n for n in vm.values()}, ("encoder.", "quant_conv.")
    if "encoder.conv_in.weight" in vae_st:
        em, et = sd_vae_encoder_mapping(vae_st, cfg.vae)
        params["vae_enc"] = load_mapped_params(
            vae_st, em, init_vae_encoder_params(cfg.vae, 0, torch.float32,
                                                "meta"),
            torch.float32, dev, transforms=et)
        cov.update({n: n for n in em.values()})
        ignore = ()
    coverage_report(vae_st, cov, ignore=ignore)
    return params


def load_sd_image_model(path: str, dtype=torch.bfloat16, device=None):
    """A diffusers SD 1.x / 2.x / SDXL directory as a ready SDImageModel
    (SDXLImageModel when it has text_encoder_2/)."""
    from .sd import SDImageModel, SDXLImageModel
    if not detect_sd_checkpoint(path):
        raise ValueError(f"{path!r} is not a diffusers SD directory (no "
                         "unet/config.json and vae/config.json)")
    dev = resolve_device(device)
    cfg = sd_configs_from_dir(path)
    params = load_sd_params(path, cfg, dtype, dev)
    encoder = _load_clip_encoder(path, "text_encoder", "tokenizer", dtype,
                                 dev)
    if os.path.isdir(os.path.join(path, "text_encoder_2")):
        encoder2 = _load_clip_encoder(path, "text_encoder_2", "tokenizer_2",
                                      dtype, dev, with_projection=True)
        force_zeros = True
        mi_path = os.path.join(path, "model_index.json")
        if os.path.exists(mi_path):
            force_zeros = bool(_load_json(mi_path).get(
                "force_zeros_for_empty_prompt", True))
        log.info("loaded SDXL checkpoint: base %d, mults %s, ctx %d, depth "
                 "%s", cfg.unet.base_channels, cfg.unet.channel_mults,
                 cfg.unet.context_dim, cfg.unet.transformer_depth)
        return SDXLImageModel(cfg, params, encoder, encoder2, dtype=dtype,
                              force_zeros_for_empty_prompt=force_zeros,
                              device=dev)
    log.info("loaded SD checkpoint: base %d, mults %s, ctx %d",
             cfg.unet.base_channels, cfg.unet.channel_mults,
             cfg.unet.context_dim)
    return SDImageModel(cfg, params, encoder, dtype=dtype, device=dev)
