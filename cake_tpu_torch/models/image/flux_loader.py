"""FLUX.1 release-checkpoint loading (counterpart of
cake_tpu/models/image/flux_loader.py: flux1_dev_configs, mmdit_mapping,
vae_decoder_mapping, FluxCheckpoint, detect_flux_checkpoint,
load_flux_params, infer_flux_configs, Flux1TextEncoder,
load_flux_image_model).

Layouts:
  * the ComfyUI-style single bundle (e.g. flux1-dev-fp8.safetensors):
    the transformer under `model.diffusion_model.`, CLIP-L under
    `text_encoders.clip_l.transformer.`, T5-XXL under
    `text_encoders.t5xxl.transformer.`, the autoencoder under `vae.`;
  * BFL's split layout: a transformer file with bare `double_blocks.*`
    names beside `ae.safetensors` (bare `decoder.*`), CLIP and T5 in HF
    layout in `clip/` and `t5/`.
Tensor names are BFL's published ones. FP8 transformer weights are
dequantized at load, or with fp8_native kept at 1 byte per parameter and
dequantized per use by the hand-written kernel (utils/mapping.py). The
VAE loads in float32, the encoders and transformer in the model dtype.
Tokenizers: `clip_tokenizer.json` (or `tokenizer.json`) and
`t5_tokenizer.json`, read by utils/bpe.py; a bare
`spiece.model` is refused (no SentencePiece reader on the card's
machine).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os

import numpy as np
import torch

from ...device import resolve_device
from ...utils.mapping import coverage_report, load_mapped_params
from ...utils.safetensors_io import TensorStorage, index_file
from ...utils.bpe import JsonTokenizer, word_level_spec
from ..text_encoders import (CLIPTextConfig, T5Config, clip_mapping,
                             clip_text_forward, init_clip_params,
                             init_t5_params, t5_encode, t5_mapping)
from .mmdit import MMDiTConfig, init_mmdit_params
from .vae import VaeConfig, init_vae_decoder_params

log = logging.getLogger("cake_tpu_torch.flux_loader")

TRANSFORMER_PREFIX = "model.diffusion_model."
CLIP_PREFIX = "text_encoders.clip_l.transformer."
T5_PREFIX = "text_encoders.t5xxl.transformer."
VAE_PREFIX = "vae."


def flux1_dev_configs() -> dict:
    """FLUX.1-dev's component configs (BFL's published dims)."""
    return dict(mmdit=MMDiTConfig(), vae=VaeConfig(), clip=CLIPTextConfig(),
                t5=T5Config())


def mmdit_mapping(cfg: MMDiTConfig, prefix: str = "") -> dict[str, str]:
    """parameter path -> BFL FLUX transformer tensor name."""
    m: dict[str, str] = {}
    for pt, ck in (("img_in", "img_in"), ("txt_in", "txt_in"),
                   ("final_out", "final_layer.linear"),
                   ("final_mod", "final_layer.adaLN_modulation.1")):
        m[f"{pt}.weight"] = f"{prefix}{ck}.weight"
        m[f"{pt}.bias"] = f"{prefix}{ck}.bias"
    embedders = [("time_mlp", "time_in"), ("vec_mlp", "vector_in")]
    if cfg.guidance_embed:
        embedders.append(("guidance_mlp", "guidance_in"))
    for pt, ck in embedders:
        for ours, theirs in (("in", "in_layer"), ("out", "out_layer")):
            m[f"{pt}.{ours}.weight"] = f"{prefix}{ck}.{theirs}.weight"
            m[f"{pt}.{ours}.bias"] = f"{prefix}{ck}.{theirs}.bias"
    for i in range(cfg.depth_double):
        for s in ("img", "txt"):
            src = f"{prefix}double_blocks.{i}.{s}_"
            dst = f"double.{i}.{s}."
            for pt, ck in (("mod", "mod.lin"), ("qkv", "attn.qkv"),
                           ("proj", "attn.proj"), ("mlp_in", "mlp.0"),
                           ("mlp_out", "mlp.2")):
                m[f"{dst}{pt}.weight"] = f"{src}{ck}.weight"
                m[f"{dst}{pt}.bias"] = f"{src}{ck}.bias"
            m[f"{dst}q_norm.weight"] = f"{src}attn.norm.query_norm.scale"
            m[f"{dst}k_norm.weight"] = f"{src}attn.norm.key_norm.scale"
    for i in range(cfg.depth_single):
        src = f"{prefix}single_blocks.{i}."
        dst = f"single.{i}."
        for pt, ck in (("mod", "modulation.lin"), ("linear1", "linear1"),
                       ("linear2", "linear2")):
            m[f"{dst}{pt}.weight"] = f"{src}{ck}.weight"
            m[f"{dst}{pt}.bias"] = f"{src}{ck}.bias"
        m[f"{dst}q_norm.weight"] = f"{src}norm.query_norm.scale"
        m[f"{dst}k_norm.weight"] = f"{src}norm.key_norm.scale"
    return m


def vae_decoder_mapping(cfg: VaeConfig, prefix: str = "") -> dict[str, str]:
    """parameter path -> CompVis/BFL autoencoder decoder tensor name. The
    checkpoint's `up.{lvl}` runs the lowest resolution last-indexed, so
    ups[k] <-> up.{L-1-k}."""
    def conv(dst, src):
        return {f"{dst}.weight": f"{src}.weight", f"{dst}.bias": f"{src}.bias"}

    def resnet(dst, src, has_shortcut):
        m = {}
        for name in ("norm1", "conv1", "norm2", "conv2"):
            m.update(conv(f"{dst}.{name}", f"{src}.{name}"))
        if has_shortcut:
            m.update(conv(f"{dst}.shortcut", f"{src}.nin_shortcut"))
        return m
    d = f"{prefix}decoder."
    n_lv = len(cfg.channel_mults)
    chs = [cfg.base_channels * mlt for mlt in cfg.channel_mults]
    m: dict[str, str] = {}
    m.update(conv("conv_in", f"{d}conv_in"))
    m.update(resnet("mid_res1", f"{d}mid.block_1", False))
    m.update(resnet("mid_res2", f"{d}mid.block_2", False))
    for ours, theirs in (("norm", "norm"), ("q", "q"), ("k", "k"),
                         ("v", "v"), ("proj", "proj_out")):
        m.update(conv(f"mid_attn.{ours}", f"{d}mid.attn_1.{theirs}"))
    cin = chs[-1]
    for k in range(n_lv):
        lvl = n_lv - 1 - k
        c = list(reversed(chs))[k]
        for j in range(cfg.num_res_blocks):
            m.update(resnet(f"ups.{k}.res.{j}", f"{d}up.{lvl}.block.{j}",
                            has_shortcut=(cin != c)))
            cin = c
        if k < n_lv - 1:
            m.update(conv(f"ups.{k}.upsample", f"{d}up.{lvl}.upsample.conv"))
    m.update(conv("norm_out", f"{d}norm_out"))
    m.update(conv("conv_out", f"{d}conv_out"))
    return m


@dataclasses.dataclass
class FluxCheckpoint:
    kind: str                       # "bundle" | "split"
    transformer: TensorStorage
    transformer_prefix: str
    vae: TensorStorage
    vae_prefix: str
    clip: TensorStorage | None
    clip_prefix: str
    t5: TensorStorage | None
    t5_prefix: str
    model_dir: str


def detect_flux_checkpoint(path: str) -> FluxCheckpoint | None:
    """Sniff safetensors headers for a FLUX.1 layout; None if not one."""
    if os.path.isfile(path) and path.endswith(".safetensors"):
        files = [path]
        model_dir = os.path.dirname(path) or "."
    elif os.path.isdir(path):
        files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith(".safetensors")]
        model_dir = path
    else:
        return None
    bundle = transformer = ae = None
    for f in files:
        names = index_file(f).keys()
        if any(n.startswith(TRANSFORMER_PREFIX + "double_blocks.")
               for n in names):
            bundle = f
        elif any(n.startswith("double_blocks.") for n in names):
            transformer = f
        elif any(n.startswith("decoder.conv_in.") for n in names):
            ae = f
    if bundle:
        st = TensorStorage(index_file(bundle))
        has_clip = any(n.startswith(CLIP_PREFIX) for n in st.names())
        has_t5 = any(n.startswith(T5_PREFIX) for n in st.names())
        return FluxCheckpoint(
            kind="bundle", transformer=st,
            transformer_prefix=TRANSFORMER_PREFIX, vae=st,
            vae_prefix=VAE_PREFIX, clip=st if has_clip else None,
            clip_prefix=CLIP_PREFIX + "text_model.",
            t5=st if has_t5 else None, t5_prefix=T5_PREFIX,
            model_dir=model_dir)
    if transformer and ae:
        def subdir_storage(sub):
            p = os.path.join(model_dir, sub)
            try:
                return TensorStorage.from_model_dir(p) \
                    if os.path.isdir(p) else None
            except FileNotFoundError:
                return None
        return FluxCheckpoint(
            kind="split", transformer=TensorStorage(index_file(transformer)),
            transformer_prefix="", vae=TensorStorage(index_file(ae)),
            vae_prefix="", clip=subdir_storage("clip"),
            clip_prefix="text_model.", t5=subdir_storage("t5"), t5_prefix="",
            model_dir=model_dir)
    return None


def load_flux_params(ckpt: FluxCheckpoint, cfgs: dict, dtype=torch.bfloat16,
                     fp8_native: bool = False, device=None) -> dict:
    """The transformer and VAE decoder (and CLIP / T5 when present) on
    `device`, every tensor checked against its shape, unread tensors
    reported. fp8_native keeps the transformer's float8-stored 2-D
    weights at 1 byte per parameter; the VAE and encoders are unaffected
    (bf16 / f32 in release bundles)."""
    dev = resolve_device(device)
    mm_cfg, vae_cfg = cfgs["mmdit"], cfgs["vae"]
    mm_map = mmdit_mapping(mm_cfg, ckpt.transformer_prefix)
    params = {"transformer": load_mapped_params(
        ckpt.transformer, mm_map, init_mmdit_params(mm_cfg, 0, dtype, "meta"),
        dtype, dev, fp8_native=fp8_native)}
    coverage_report(ckpt.transformer, mm_map, ckpt.transformer_prefix)
    vae_map = vae_decoder_mapping(vae_cfg, ckpt.vae_prefix)
    params["vae"] = load_mapped_params(
        ckpt.vae, vae_map, init_vae_decoder_params(vae_cfg, 0, torch.float32,
                                                   "meta"),
        torch.float32, dev)
    coverage_report(ckpt.vae, vae_map, ckpt.vae_prefix,
                    ignore=(ckpt.vae_prefix + "encoder.",))
    if ckpt.clip is not None:
        cmap = clip_mapping(cfgs["clip"], ckpt.clip_prefix)
        params["clip"] = load_mapped_params(
            ckpt.clip, cmap, init_clip_params(cfgs["clip"], 0, dtype, "meta"),
            dtype, dev)
        coverage_report(ckpt.clip, cmap, ckpt.clip_prefix,
                        ignore=(ckpt.clip_prefix + "embeddings.position_ids",))
    if ckpt.t5 is not None:
        tmap = t5_mapping(cfgs["t5"], ckpt.t5_prefix)
        params["t5"] = load_mapped_params(
            ckpt.t5, tmap, init_t5_params(cfgs["t5"], 0, dtype, "meta"),
            dtype, dev)
        coverage_report(ckpt.t5, tmap, ckpt.t5_prefix)
    return params


def _count(storage, fmt: str) -> int:
    i = 0
    while fmt.format(i) in storage:
        i += 1
    return i


def infer_flux_configs(ckpt: FluxCheckpoint) -> dict:
    """Component configs from the checkpoint's shapes; what shapes cannot
    say (CLIP's head count, T5's bucket distance, the rope split) takes
    FLUX.1-dev's values unless a `flux_config.json` sidecar overrides it
    ({"mmdit": {...}, "vae": {...}, "clip": {...}, "t5": {...}})."""
    over: dict = {}
    sidecar = os.path.join(ckpt.model_dir, "flux_config.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            over = json.load(f)
    st, tp = ckpt.transformer, ckpt.transformer_prefix
    rec = st.records
    hidden, in_ch = rec[f"{tp}img_in.weight"].shape
    head_dim = rec[f"{tp}double_blocks.0.img_attn.norm.query_norm.scale"
                   ].shape[0]
    qkv_out = rec[f"{tp}double_blocks.0.img_attn.qkv.weight"].shape[0]
    mlp_dim = rec[f"{tp}double_blocks.0.img_mlp.0.weight"].shape[0]
    s_ax = (head_dim * 7 // 16) // 2 * 2     # the dev ratio (16, 56, 56)
    mm = dict(
        in_channels=in_ch, hidden_size=hidden,
        num_heads=qkv_out // 3 // head_dim, head_dim=head_dim,
        mlp_ratio=mlp_dim / hidden,
        depth_double=_count(st, tp + "double_blocks.{}.img_mod.lin.weight"),
        depth_single=_count(st, tp + "single_blocks.{}.linear1.weight"),
        txt_dim=rec[f"{tp}txt_in.weight"].shape[1],
        vec_dim=rec[f"{tp}vector_in.in_layer.weight"].shape[1],
        guidance_embed=f"{tp}guidance_in.in_layer.weight" in st,
        axes_dims=(head_dim - 2 * s_ax, s_ax, s_ax))
    mm.update(over.get("mmdit", {}))
    mm["axes_dims"] = tuple(mm["axes_dims"])
    sv, vp = ckpt.vae, ckpt.vae_prefix
    vrec = sv.records
    n_lv = _count(sv, vp + "decoder.up.{}.block.0.conv1.weight")
    base = vrec[f"{vp}decoder.conv_out.weight"].shape[1]
    mults = tuple(vrec[f"{vp}decoder.up.{lvl}.block.0.conv1.weight"].shape[0]
                  // base for lvl in range(n_lv))
    vae = dict(latent_channels=vrec[f"{vp}decoder.conv_in.weight"].shape[1],
               base_channels=base, channel_mults=mults,
               num_res_blocks=_count(sv, vp + "decoder.up.0.block.{}.conv1."
                                     "weight"))
    vae.update(over.get("vae", {}))
    vae["channel_mults"] = tuple(vae["channel_mults"])
    cfgs = {"mmdit": MMDiTConfig(**mm), "vae": VaeConfig(**vae)}
    if ckpt.clip is not None:
        cp = ckpt.clip_prefix
        crec = ckpt.clip.records
        ch = crec[f"{cp}embeddings.token_embedding.weight"].shape
        clip = dict(
            vocab_size=ch[0], hidden_size=ch[1],
            num_layers=_count(ckpt.clip, cp + "encoder.layers.{}.self_attn."
                              "q_proj.weight"),
            num_heads=max(1, ch[1] // 64),      # CLIP's 64-wide heads
            intermediate_size=crec[f"{cp}encoder.layers.0.mlp.fc1.weight"
                                   ].shape[0],
            max_positions=crec[f"{cp}embeddings.position_embedding.weight"
                               ].shape[0],
            eot_token_id=ch[0] - 1)
        clip.update(over.get("clip", {}))
        cfgs["clip"] = CLIPTextConfig(**clip)
    if ckpt.t5 is not None:
        t5p = ckpt.t5_prefix
        trec = ckpt.t5.records
        rel = trec[f"{t5p}encoder.block.0.layer.0.SelfAttention."
                   f"relative_attention_bias.weight"].shape
        q_out = trec[f"{t5p}encoder.block.0.layer.0.SelfAttention.q.weight"
                     ].shape[0]
        t5 = dict(
            vocab_size=trec[f"{t5p}shared.weight"].shape[0],
            d_model=trec[f"{t5p}shared.weight"].shape[1],
            num_layers=_count(ckpt.t5, t5p + "encoder.block.{}.layer.0."
                              "SelfAttention.q.weight"),
            num_heads=rel[1], d_kv=q_out // rel[1],
            d_ff=trec[f"{t5p}encoder.block.0.layer.1.DenseReluDense.wi_0."
                      f"weight"].shape[0],
            relative_buckets=rel[0])
        t5.update(over.get("t5", {}))
        cfgs["t5"] = T5Config(**t5)
    return cfgs


class Flux1TextEncoder:
    """prompt -> (T5 sequence embeddings [1, t5_seq_len, d_model], CLIP
    pooled vector [1, hidden]) on the parameters' device; `from_dir`
    reads the tokenizers beside a checkpoint."""

    def __init__(self, cfgs: dict, params: dict, clip_tok, t5_tok,
                 t5_seq_len: int = 512, dtype=torch.bfloat16):
        self.cfgs, self.params, self.dtype = cfgs, params, dtype
        self.clip_tok, self.t5_tok = clip_tok, t5_tok
        self.t5_seq_len = t5_seq_len

    @classmethod
    def from_dir(cls, cfgs: dict, params: dict, model_dir: str, **kw):
        return cls(cfgs, params,
                   cls._load_tokenizer(model_dir, ("clip_tokenizer.json",
                                                   "tokenizer.json")),
                   cls._load_tokenizer(model_dir, ("t5_tokenizer.json",),
                                       spiece="spiece.model"), **kw)

    @staticmethod
    def _load_tokenizer(model_dir, names, spiece=None) -> JsonTokenizer:
        for n in names:
            p = os.path.join(model_dir, n)
            if os.path.exists(p):
                return JsonTokenizer.from_file(p)
        if spiece and os.path.exists(os.path.join(model_dir, spiece)):
            raise FileNotFoundError(
                f"{model_dir} has {spiece} but no {names[0]}: the port reads "
                "tokenizers-format files only (no SentencePiece reader)")
        raise FileNotFoundError(
            f"no tokenizer found in {model_dir} (looked for {names}"
            + (f" or {spiece}" if spiece else "") + ")")

    @staticmethod
    def _ids(tok, text, length, pad_id, end_id=None) -> np.ndarray:
        """encode(text).ids cut to `length` (the end token kept last on a
        cut: CLIP pools at the first EOT) and padded with pad_id."""
        ids = tok.encode(text)
        if len(ids) > length:
            ids = ids[:length]
            if end_id is not None:
                ids[-1] = end_id
        ids = ids + [pad_id] * (length - len(ids))
        return np.asarray([ids], np.int32)

    @torch.inference_mode()
    def __call__(self, prompt: str):
        clip_cfg = self.cfgs["clip"]
        dev = self.params["t5"]["shared"]["weight"].device
        clip_ids = self._ids(self.clip_tok, prompt, clip_cfg.max_positions,
                             clip_cfg.eot_token_id,
                             end_id=clip_cfg.eot_token_id)
        t5_ids = self._ids(self.t5_tok, prompt, self.t5_seq_len, 0, end_id=1)
        _, pooled, _ = clip_text_forward(
            clip_cfg, self.params["clip"],
            torch.from_numpy(clip_ids).long().to(dev))
        txt = t5_encode(self.cfgs["t5"], self.params["t5"],
                        torch.from_numpy(t5_ids).long().to(dev))
        return txt.to(self.dtype), pooled.to(self.dtype)


def load_flux_image_model(path: str, dtype=torch.bfloat16,
                          t5_seq_len: int = 512, fp8_native: bool = False,
                          device=None):
    """A FLUX.1 checkpoint (file or directory) as a ready FluxImageModel:
    detect the layout, infer the configs, load and check every
    component."""
    from .flux import FluxImageModel, FluxPipelineConfig
    ckpt = detect_flux_checkpoint(path)
    if ckpt is None:
        raise ValueError(
            f"{path!r} is not a recognizable FLUX checkpoint (expected a "
            "ComfyUI-style bundle with model.diffusion_model.* tensors, or "
            "a transformer .safetensors with bare double_blocks.* names "
            "next to ae.safetensors)")
    missing = [n for n, s in (("CLIP-L", ckpt.clip), ("T5", ckpt.t5))
               if s is None]
    if missing:
        raise ValueError(
            f"FLUX checkpoint at {path!r} is missing text encoders: "
            f"{missing}. Bundle them (text_encoders.* prefixes) or provide "
            f"clip/ and t5/ subdirectories in HF layout.")
    dev = resolve_device(device)
    cfgs = infer_flux_configs(ckpt)
    params = load_flux_params(ckpt, cfgs, dtype, fp8_native=fp8_native,
                              device=dev)
    encoder = Flux1TextEncoder.from_dir(cfgs, params, ckpt.model_dir,
                                        t5_seq_len=t5_seq_len, dtype=dtype)
    model = FluxImageModel(
        FluxPipelineConfig(mmdit=cfgs["mmdit"], vae=cfgs["vae"]),
        params={"transformer": params["transformer"], "vae": params["vae"]},
        text_encoder=encoder, dtype=dtype, device=dev)
    log.info("loaded FLUX checkpoint (%s layout): %d double + %d single "
             "blocks, hidden %d", ckpt.kind, cfgs["mmdit"].depth_double,
             cfgs["mmdit"].depth_single, cfgs["mmdit"].hidden_size)
    return model


def seeded_flux1(cfgs: dict | None = None, dtype=torch.bfloat16, device=None,
                 seed: int = 42, fp8_native: bool = False):
    """A FluxImageModel from seeded weights drawn on the device (FLUX.1-dev's
    configs by default): the MMDiT in `dtype` or, fp8_native, as native FP8
    pairs with per-tensor scales; the VAE in float32 as the loader keeps
    it; CLIP and T5 in `dtype` behind word-level tokenizers
    (utils/bpe.word_level_spec)."""
    from .flux import FluxImageModel, FluxPipelineConfig
    cfgs = cfgs or flux1_dev_configs()
    dev = resolve_device(device)
    params = {
        "transformer": init_mmdit_params(cfgs["mmdit"], seed, dtype, dev,
                                         fp8_native=fp8_native),
        "vae": init_vae_decoder_params(cfgs["vae"], seed + 1, torch.float32,
                                       dev),
        "clip": init_clip_params(cfgs["clip"], seed + 2, dtype, dev),
        "t5": init_t5_params(cfgs["t5"], seed + 3, dtype, dev)}
    encoder = Flux1TextEncoder(
        cfgs, {"clip": params["clip"], "t5": params["t5"]},
        JsonTokenizer(word_level_spec(cfgs["clip"].vocab_size)),
        JsonTokenizer(word_level_spec(cfgs["t5"].vocab_size)), dtype=dtype)
    return FluxImageModel(
        FluxPipelineConfig(mmdit=cfgs["mmdit"], vae=cfgs["vae"]),
        params={"transformer": params["transformer"], "vae": params["vae"]},
        text_encoder=encoder, dtype=dtype, device=dev)
