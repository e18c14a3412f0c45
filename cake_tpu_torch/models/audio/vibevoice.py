"""VibeVoice text-to-speech (counterpart of cake_tpu/models/audio/vibevoice.py:
VibeVoiceConfig, vibevoice_config_from_hf, tiny_tts_config, the diffusion
prediction head, the acoustic connector, the EOS classifier, the sigma-VAE
decoder and encoder, inject_voice_kv, AudioOutput, VibeVoiceTTS,
load_voice_prompt).

    tts = VibeVoiceTTS(tiny_tts_config(), device="cuda")
    audio = tts.generate_speech("hello there", seed=3)
    open("out.wav", "wb").write(audio.wav_bytes())

  * two Qwen2 decoder stacks on the port's blocks and KV caches: the base
    LM (`model.language_model`) reads windows of 5 text tokens; its
    normed output plus the text type embedding goes through the TTS LM
    (`model.tts_language_model`); speech frames go back through the TTS
    LM as connector(latent) plus the speech type embedding, in a positive
    stream and a negative (CFG) stream, each with its own cache;
  * the diffusion head (`model.prediction_head`): DiT-style AdaLN blocks
    with a SwiGLU FFN, v-prediction, batched CFG (positive and negative
    conditions in one call), DPM-Solver++(2M) over the cosine schedule
    (ops/diffusion.DpmSolverPP, a fresh solver per frame);
  * windows of 6 frames between text windows; once the text is spent, the
    frames run to max_frames; the EOS classifier stops after at least 3;
  * the acoustic sigma-VAE decoder (causal Conv1d / ConvTranspose1d stages
    with ConvNeXt-style blocks: channel RMS norm, depthwise k7 causal
    conv, gamma residuals) over the whole latent sequence; the encoder
    (raw-wav voice cloning) its mirror.

Noise is drawn from a generator seeded by the request's seed (on the
CPU, then moved), one [1, acoustic_dim] draw per frame; `frame_noise=`
takes those draws from the caller (a list, frame by frame), so parity
tests pass the reference's jax.random draws in. `frame_latents=` feeds
the caller's latents (each frame's sample, before the denormalization)
back into the loop in place of the frame's own, and `frame_log=` is a
list that collects each frame's condition, latent and EOS probability:
two devices teacher-forced with one run's latents see the same inputs at
every frame, so their roundings do not compound through the loop. The VAE decodes and
encodes in its own dtype (float32 from a checkpoint), the latents and the
waveform cast to it: the reference feeds the model dtype into its
float32 convolutions, which fails in bf16 (ROADMAP §3).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...ops.activations import adaln_modulate
from ...ops.conv import conv1d, conv_transpose1d
from ...ops.diffusion import DpmSolverPP, cfg_combine
from ...ops.linear import linear
from ...ops.norms import rms_norm, rms_norm_channel
from ...utils.init import generator, normal
from ...utils.wav import decode_wav, encode_wav, f32_to_pcm16
from ..common.cache import init_cache
from ..common.config import ModelConfig, config_from_hf_dict, tiny_config
from ..common.layers import forward_layers, init_params, make_rope

log = logging.getLogger("cake_tpu_torch.vibevoice")

TEXT_WINDOW = 5      # text tokens per window
SPEECH_WINDOW = 6    # speech frames per window


@dataclasses.dataclass(frozen=True)
class VibeVoiceConfig:
    lm_base: ModelConfig = None        # model.language_model stack
    lm_tts: ModelConfig = None         # model.tts_language_model stack
    acoustic_dim: int = 64             # acoustic_vae_dim
    head_layers: int = 4
    head_ffn_ratio: float = 3.0
    head_eps: float = 1e-5
    ddpm_num_steps: int = 1000
    solver_steps: int = 10
    vae_n_filters: int = 32
    vae_ratios: tuple[int, ...] = (8, 5, 5, 4, 2, 2)   # hop 3200 at 24 kHz
    vae_depths: tuple[int, ...] = (3, 3, 3, 3, 3, 3, 8)
    vae_eps: float = 1e-6
    # the encoder's (raw-wav cloning); None mirrors the decoder
    enc_n_filters: int | None = None
    enc_depths: tuple[int, ...] | None = None
    sample_rate: int = 24000
    cfg_scale: float = 1.3

    @property
    def hidden(self) -> int:
        return self.lm_tts.hidden_size

    @property
    def vae_channels(self) -> tuple[int, ...]:
        """n_filters * 2^(stages - 1), halving per stage (7 stages for 6
        ratios)."""
        n = len(self.vae_ratios) + 1
        return tuple(self.vae_n_filters * (1 << (n - 1 - i))
                     for i in range(n))

    @property
    def enc_channels(self) -> tuple[int, ...]:
        """The encoder doubles its channels per stage: n_filters * 2^i."""
        n = len(self.vae_ratios) + 1
        f = self.enc_n_filters or self.vae_n_filters
        return tuple(f * (1 << i) for i in range(n))

    @property
    def enc_depths_resolved(self) -> tuple[int, ...]:
        """Blocks per encoder stage; 3 each when the config has none."""
        return self.enc_depths or (3,) * (len(self.vae_ratios) + 1)

    @property
    def hop(self) -> int:
        return int(np.prod(self.vae_ratios))


def vibevoice_config_from_hf(raw: dict) -> VibeVoiceConfig:
    """The release config.json: decoder_config, diffusion_head_config,
    acoustic_tokenizer_config and tts_backbone_num_hidden_layers."""
    dc = raw["decoder_config"]
    hc = raw["diffusion_head_config"]
    ac = raw["acoustic_tokenizer_config"]

    def lm_cfg(layers: int, prefix: str) -> ModelConfig:
        d = dict(dc)
        d.update(architectures=["Qwen2ForCausalLM"], num_hidden_layers=layers)
        return dataclasses.replace(config_from_hf_dict(d), model_prefix=prefix)

    ratios = tuple(ac.get("decoder_ratios") or ac["encoder_ratios"])
    depths_s = ac.get("decoder_depths")
    if depths_s:
        # an explicit string is in decoder stage order (stage 0: the top
        # channels)
        depths = tuple(int(x) for x in depths_s.split("-"))
    else:
        # mirror the encoder's, reversed
        enc = [int(x) for x in (ac.get("encoder_depths") or "").split("-")
               if x] or [3] * (len(ratios) + 1)
        depths = tuple(reversed(enc))
    return VibeVoiceConfig(
        lm_base=lm_cfg(dc["num_hidden_layers"], "model.language_model"),
        lm_tts=lm_cfg(raw["tts_backbone_num_hidden_layers"],
                      "model.tts_language_model"),
        acoustic_dim=raw["acoustic_vae_dim"],
        head_layers=hc["head_layers"],
        head_ffn_ratio=hc.get("head_ffn_ratio", 3.0),
        head_eps=hc.get("rms_norm_eps", 1e-5),
        ddpm_num_steps=hc.get("ddpm_num_steps", 1000),
        solver_steps=hc.get("ddpm_num_inference_steps", 10),
        vae_n_filters=ac.get("decoder_n_filters") or ac["encoder_n_filters"],
        vae_ratios=ratios, vae_depths=depths,
        vae_eps=ac.get("layernorm_eps", 1e-6),
        enc_n_filters=ac.get("encoder_n_filters"),
        enc_depths=tuple(int(x) for x in ac["encoder_depths"].split("-"))
        if ac.get("encoder_depths") else None,
    )


def tiny_tts_config() -> VibeVoiceConfig:
    lm = tiny_config("qwen2")
    return VibeVoiceConfig(
        lm_base=dataclasses.replace(lm, model_prefix="model.language_model"),
        lm_tts=dataclasses.replace(lm,
                                   model_prefix="model.tts_language_model"),
        acoustic_dim=16, head_layers=2, head_ffn_ratio=2.0,
        vae_n_filters=8, vae_ratios=(4, 4), vae_depths=(1, 1, 1),
        solver_steps=4,
    )


# -- the diffusion prediction head -------------------------------------------


def vv_timestep_embedding(t: torch.Tensor) -> torch.Tensor:
    """Sinusoidal embedding of raw timesteps -> [B, 256], cos first."""
    half = 128
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device)
                      * (-math.log(10000.0) / half))
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _w(gen, o, i, dtype, device, std):
    return {"weight": normal(gen, (o, i), dtype, device, std)}


def init_head_params(cfg: VibeVoiceConfig, seed: int = 0,
                     dtype=torch.float32, device="cpu") -> dict:
    gen = generator(seed, device)
    h, lat = cfg.hidden, cfg.acoustic_dim
    inner = int(h * cfg.head_ffn_ratio)

    def w(o, i):
        return _w(gen, o, i, dtype, device, 1.0 / i ** 0.5)

    return {
        "t_mlp1": w(h, 256), "t_mlp2": w(h, h),
        "noisy_proj": w(h, lat), "cond_proj": w(h, h),
        "layers": [{"norm": {"weight": torch.ones(h, dtype=dtype,
                                                  device=device)},
                    "ada": w(3 * h, h), "gate_proj": w(inner, h),
                    "up_proj": w(inner, h), "down_proj": w(h, inner)}
                   for _ in range(cfg.head_layers)],
        "final_ada": w(2 * h, h), "final_linear": w(lat, h),
    }


def head_forward(cfg: VibeVoiceConfig, p: dict, x_t, t, cond):
    """x_t: [B, latent]; t: [B] raw timesteps; cond: [B, hidden]. Returns
    the v-prediction [B, latent]."""
    h = linear(x_t, p["noisy_proj"]["weight"])
    temb = linear(F.silu(linear(vv_timestep_embedding(t).to(x_t.dtype),
                                p["t_mlp1"]["weight"])),
                  p["t_mlp2"]["weight"])
    sc = F.silu(linear(cond, p["cond_proj"]["weight"]) + temb)
    eps = cfg.head_eps
    for lp in p["layers"]:
        shift, scale, gate = linear(sc, lp["ada"]["weight"]).chunk(3, dim=-1)
        hh = adaln_modulate(rms_norm(h, lp["norm"]["weight"], eps), shift,
                            scale)
        hh = linear(F.silu(linear(hh, lp["gate_proj"]["weight"]))
                    * linear(hh, lp["up_proj"]["weight"]),
                    lp["down_proj"]["weight"])
        h = h + gate * hh
    shift, scale = linear(sc, p["final_ada"]["weight"]).chunk(2, dim=-1)
    ones = torch.ones(cfg.hidden, dtype=h.dtype, device=h.device)
    hh = adaln_modulate(rms_norm(h, ones, eps), shift, scale)
    return linear(hh, p["final_linear"]["weight"])


# -- the acoustic connector and the EOS classifier ----------------------------


def init_connector_params(cfg: VibeVoiceConfig, seed: int = 0,
                          dtype=torch.float32, device="cpu",
                          bias: bool = True) -> dict:
    gen = generator(seed, device)
    h, lat = cfg.hidden, cfg.acoustic_dim
    p = {"fc1": _w(gen, h, lat, dtype, device, 0.02),
         "norm": {"weight": torch.ones(h, dtype=dtype, device=device)},
         "fc2": _w(gen, h, h, dtype, device, 0.02)}
    if bias:
        for k in ("fc1", "fc2"):
            p[k]["bias"] = torch.zeros(h, dtype=dtype, device=device)
    return p


def connector_forward(cfg: VibeVoiceConfig, p: dict, latent):
    h = linear(latent, p["fc1"]["weight"], p["fc1"].get("bias"))
    h = rms_norm(h, p["norm"]["weight"], cfg.lm_tts.rms_norm_eps)
    return linear(h, p["fc2"]["weight"], p["fc2"].get("bias"))


def init_eos_params(cfg: VibeVoiceConfig, seed: int = 0, dtype=torch.float32,
                    device="cpu", inner: int | None = None) -> dict:
    gen = generator(seed, device)
    h = cfg.hidden
    inner = inner or h
    return {"fc1": dict(_w(gen, inner, h, dtype, device, 0.02),
                        bias=torch.zeros(inner, dtype=dtype, device=device)),
            "fc2": dict(_w(gen, 1, inner, dtype, device, 0.02),
                        bias=torch.zeros(1, dtype=dtype, device=device))}


def eos_probability(p: dict, cond) -> torch.Tensor:
    h = F.silu(linear(cond, p["fc1"]["weight"], p["fc1"]["bias"]))
    return torch.sigmoid(linear(h, p["fc2"]["weight"],
                                p["fc2"]["bias"]).float())


# -- the acoustic sigma-VAE --------------------------------------------------


def _vae_conv_p(gen, co, ci, kk, dtype, device):
    return {"weight": normal(gen, (co, ci, kk), dtype, device, 0.05),
            "bias": torch.zeros(co, dtype=dtype, device=device)}


def _vae_block_p(gen, c, dtype, device):
    """A ConvNeXt-style block's parameters (the encoder's are the
    decoder's)."""
    inner = 4 * c

    def full(v):
        return torch.full((c,), v, dtype=dtype, device=device)
    return {
        "norm": {"weight": full(1.0)}, "gamma": full(0.1),
        "mixer": {"weight": normal(gen, (c, 1, 7), dtype, device, 0.1),
                  "bias": full(0.0)},
        "ffn_norm": {"weight": full(1.0)}, "ffn_gamma": full(0.1),
        "ffn1": {"weight": normal(gen, (inner, c), dtype, device, 0.05),
                 "bias": torch.zeros(inner, dtype=dtype, device=device)},
        "ffn2": {"weight": normal(gen, (c, inner), dtype, device, 0.05),
                 "bias": full(0.0)},
    }


def init_vae_decoder_params(cfg: VibeVoiceConfig, seed: int = 0,
                            dtype=torch.float32, device="cpu") -> dict:
    gen = generator(seed, device)
    chans = cfg.vae_channels
    p: dict = {"up": [_vae_conv_p(gen, chans[0], cfg.acoustic_dim, 7, dtype,
                                  device)]}
    for i, r in enumerate(cfg.vae_ratios):
        # a transposed convolution's weight is [in, out, k]
        p["up"].append({"weight": normal(gen, (chans[i], chans[i + 1], 2 * r),
                                         dtype, device, 0.05),
                        "bias": torch.zeros(chans[i + 1], dtype=dtype,
                                            device=device)})
    p["stages"] = [[_vae_block_p(gen, chans[i], dtype, device)
                    for _ in range(cfg.vae_depths[i])]
                   for i in range(len(chans))]
    p["head"] = _vae_conv_p(gen, 1, chans[-1], 7, dtype, device)
    return p


def _causal_pad(x, amount: int):
    return F.pad(x, (amount, 0))


def _decoder_block(cfg: VibeVoiceConfig, p: dict, x):
    """channel RMS -> depthwise causal k7 conv -> gamma residual; channel
    RMS -> FFN (exact GELU) -> gamma residual."""
    c = x.shape[1]
    h = rms_norm_channel(x, p["norm"]["weight"], cfg.vae_eps)
    h = conv1d(_causal_pad(h, 6), p["mixer"]["weight"], p["mixer"]["bias"],
               groups=c)
    x = x + p["gamma"][None, :, None] * h
    h = rms_norm_channel(x, p["ffn_norm"]["weight"], cfg.vae_eps)
    h = linear(h.transpose(1, 2), p["ffn1"]["weight"], p["ffn1"]["bias"])
    h = linear(F.gelu(h), p["ffn2"]["weight"], p["ffn2"]["bias"])
    return x + p["ffn_gamma"][None, :, None] * h.transpose(1, 2)


def vae_decode_frames(cfg: VibeVoiceConfig, p: dict, latents):
    """latents: [B, T, acoustic_dim] (denormalized) -> waveform [B, T *
    hop]."""
    x = latents.transpose(1, 2)
    for i, up in enumerate(p["up"]):
        if i == 0:
            x = conv1d(_causal_pad(x, 6), up["weight"], up["bias"])
        else:
            r = cfg.vae_ratios[i - 1]
            x = conv_transpose1d(x, up["weight"], up["bias"], stride=r)
            x = x[:, :, :-r]                           # causal right trim
        for blk in p["stages"][i]:
            x = _decoder_block(cfg, blk, x)
    x = conv1d(_causal_pad(x, 6), p["head"]["weight"], p["head"]["bias"])
    return x[:, 0]


def init_vae_encoder_params(cfg: VibeVoiceConfig, seed: int = 0,
                            dtype=torch.float32, device="cpu") -> dict:
    """Downsample convolutions: a stem 1 -> c0 (k7, stride 1), then c_i ->
    c_{i+1} with k = 2r, stride r, the config's ratios reversed."""
    gen = generator(seed, device)
    chans = cfg.enc_channels
    p: dict = {"down": [_vae_conv_p(gen, chans[0], 1, 7, dtype, device)]}
    for i, r in enumerate(reversed(cfg.vae_ratios)):
        p["down"].append(_vae_conv_p(gen, chans[i + 1], chans[i], 2 * r,
                                     dtype, device))
    p["stages"] = [[_vae_block_p(gen, chans[i], dtype, device)
                    for _ in range(d)]
                   for i, d in enumerate(cfg.enc_depths_resolved)]
    p["head"] = _vae_conv_p(gen, cfg.acoustic_dim, chans[-1], 7, dtype,
                            device)
    return p


def encoder_frames(cfg: VibeVoiceConfig, n_samples: int) -> int:
    """Frames vae_encode_wav makes of an unpadded clip of n_samples."""
    length = n_samples
    for s in (1,) + tuple(reversed(cfg.vae_ratios)):
        k = 7 if s == 1 else 2 * s
        length += k - s
        if s > 1:
            n = (length - k) // s + 1
            length = max(length, n * s + k)
        length = (length - k) // s + 1
    return length


def vae_encode_wav(cfg: VibeVoiceConfig, p: dict, audio):
    """audio: [B, S] 24 kHz mono -> latents [B, T, acoustic_dim]. Each
    downsampling convolution is causally left-padded by (kernel - stride)
    and right-padded to the stride grid."""
    x = audio[:, None, :]
    strides = (1,) + tuple(reversed(cfg.vae_ratios))
    for i, dp in enumerate(p["down"]):
        k, s = dp["weight"].shape[2], strides[i]
        x = _causal_pad(x, k - s)
        if s > 1:
            length = x.shape[2]
            ideal = ((length - k) // s + 1) * s + k
            if ideal > length:
                x = F.pad(x, (0, ideal - length))
        x = conv1d(x, dp["weight"], dp["bias"], stride=s)
        for blk in p["stages"][i]:
            x = _decoder_block(cfg, blk, x)
    x = conv1d(_causal_pad(x, 6), p["head"]["weight"], p["head"]["bias"])
    return x.transpose(1, 2)


# -- voice prompts -----------------------------------------------------------


def inject_voice_kv(cache: dict, kv: list, dtype) -> int:
    """Write per-layer (key, value) [1, Hkv, S, D] prompt tensors into a
    fresh cache at positions 0..S-1, in place; returns S (the cache's
    next position)."""
    seq = 0
    for lc, (k, v) in zip(cache["layers"], kv):
        k = torch.as_tensor(k).to(lc["k"].device, dtype).transpose(1, 2)
        v = torch.as_tensor(v).to(lc["v"].device, dtype).transpose(1, 2)
        seq = k.shape[1]
        if seq > lc["k"].shape[1]:
            raise ValueError(
                f"voice prompt ({seq} positions) exceeds cache "
                f"({lc['k'].shape[1]} slots)")
        lc["k"][:, :seq] = k
        lc["v"][:, :seq] = v
        lc["pos"][:, :seq] = torch.arange(seq, dtype=lc["pos"].dtype,
                                          device=lc["pos"].device)
    cache["pos"] = seq
    return seq


def load_voice_prompt(path: str) -> dict:
    """A precomputed voice-prompt safetensors file ({lm, tts_lm, neg_lm,
    neg_tts_lm}.{last_hidden_state, kv.N.{key, value}})."""
    from ...utils.safetensors_io import TensorStorage, index_file
    st = TensorStorage(index_file(path))

    def kv_list(prefix: str):
        out, i = [], 0
        while f"{prefix}.kv.{i}.key" in st:
            out.append((st.read(f"{prefix}.kv.{i}.key"),
                        st.read(f"{prefix}.kv.{i}.value")))
            i += 1
        return out
    try:
        return {"lm": kv_list("lm"), "tts_lm": kv_list("tts_lm"),
                "neg_tts_lm": kv_list("neg_tts_lm"),
                "neg_hidden": st.read("neg_tts_lm.last_hidden_state")}
    finally:
        st.close()


# -- the facade --------------------------------------------------------------


@dataclasses.dataclass
class AudioOutput:
    samples: np.ndarray
    sample_rate: int

    def wav_bytes(self) -> bytes:
        return encode_wav(self.samples, self.sample_rate)

    def pcm_bytes(self) -> bytes:
        return f32_to_pcm16(self.samples)


def _lm_forward(cfg: ModelConfig, p: dict, rope: dict, x, cache: dict,
                valid_len=None):
    """One window through an LM stack at the cache's position, then its
    final norm; the cache advances by the window (or valid_len)."""
    x = forward_layers(cfg, p, x, cache["layers"], cache["pos"], rope,
                       valid_len=valid_len)
    cache["pos"] += x.shape[1] if valid_len is None else valid_len
    return rms_norm(x, p["norm"]["weight"], cfg.rms_norm_eps)


class VibeVoiceTTS:
    """generate_speech(text) -> AudioOutput. `stats` holds the last
    generation's frames, lm_s (text windows, LM steps and diffusion) and
    vae_s."""

    def __init__(self, cfg: VibeVoiceConfig, params: dict | None = None,
                 tokenizer=None, dtype=torch.float32, seed: int = 0,
                 max_frames: int = 256, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.tokenizer = tokenizer
        self.max_frames = max_frames
        self.device = dev = resolve_device(device)
        if params is None:
            gd = dev if dev.type == "cuda" else "cpu"
            params = {
                "base": init_params(cfg.lm_base, seed, dtype, dev, gd),
                "tts": init_params(cfg.lm_tts, seed + 1, dtype, dev, gd),
                "input_types": {"weight": normal(
                    generator(seed + 2, dev), (2, cfg.hidden), dtype, dev)},
                "head": init_head_params(cfg, seed + 3, dtype, dev),
                "connector": init_connector_params(cfg, seed + 4, dtype, dev),
                "eos": init_eos_params(cfg, seed + 5, dtype, dev),
                "vae": init_vae_decoder_params(cfg, seed + 6, torch.float32,
                                               dev),
                "vae_enc": init_vae_encoder_params(cfg, seed + 7,
                                                   torch.float32, dev),
                "speech_scaling_factor": torch.tensor(1.0, device=dev),
                "speech_bias_factor": torch.tensor(0.0, device=dev),
            }
        self.params = params
        self.alphas = DpmSolverPP.from_cosine(
            n=cfg.ddpm_num_steps).alphas_cumprod
        self.rope = {"base": make_rope(cfg.lm_base, dev),
                     "tts": make_rope(cfg.lm_tts, dev)}
        self.stats: dict = {}

    # -- internals ----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fresh(self, which: str, cache_len: int) -> dict:
        lm = self.cfg.lm_base if which == "base" else self.cfg.lm_tts
        return init_cache(lm, 1, cache_len, self.dtype, self.device)

    def _base(self, x, cache, valid_len=None):
        return _lm_forward(self.cfg.lm_base, self.params["base"],
                           self.rope["base"], x, cache, valid_len)

    def _tts(self, x, cache, valid_len=None):
        return _lm_forward(self.cfg.lm_tts, self.params["tts"],
                           self.rope["tts"], x, cache, valid_len)

    def _type_embed(self, idx: int):
        return self.params["input_types"]["weight"][idx][None, None, :]

    def _sample_latent(self, cond_pos, cond_neg, scale: float, steps: int,
                       noise: torch.Tensor) -> torch.Tensor:
        """One acoustic frame: batched-CFG diffusion from `noise` [1,
        acoustic_dim]."""
        sch = DpmSolverPP(self.alphas)
        cond = torch.cat([cond_pos, cond_neg], dim=0)
        x = noise.to(self.device, self.dtype)
        ts = sch.timesteps(steps)
        for j, t in enumerate(ts):
            tv = torch.full((2,), float(t), dtype=torch.float32,
                            device=self.device)
            v2 = head_forward(self.cfg, self.params["head"],
                              torch.cat([x, x], dim=0), tv, cond)
            v = cfg_combine(v2[1:], v2[:1], scale)
            t_next = int(ts[j + 1]) if j + 1 < len(ts) else 0
            x = sch.step(v, int(t), t_next, x)
        return x

    # -- public -------------------------------------------------------------

    @torch.inference_mode()
    def generate_speech(self, text: str, voice=None,
                        voice_wav: bytes | None = None,
                        cfg_scale: float | None = None,
                        steps: int | None = None, seed: int = 0,
                        max_frames: int | None = None, on_frame=None,
                        frame_noise=None, frame_latents=None,
                        frame_log: list | None = None) -> AudioOutput:
        cfg = self.cfg
        scale = cfg.cfg_scale if cfg_scale is None else cfg_scale
        steps = cfg.solver_steps if steps is None else steps
        max_frames = max_frames or min(self.max_frames, 8 + len(text) // 2)
        gen = torch.Generator().manual_seed(seed)
        t0 = time.perf_counter()
        token_ids = self._encode_text(text)
        # the voice prompt before the caches are sized: its KV holds
        # positions 0..S-1
        vp = None
        if voice is not None:
            if os.path.exists(str(voice)):
                vp = load_voice_prompt(str(voice))
            else:
                log.warning("voice %r is not a voice-prompt file; ignoring",
                            voice)
        clone_emb = None
        if vp is None and voice_wav is not None:
            clone_emb = self._voice_embeds(voice_wav)
        vseq = max((kv[0].shape[2] for kv in vp["tts_lm"]), default=0) \
            if vp else (clone_emb.shape[1] if clone_emb is not None else 0)
        cache_len = -(-max(64, vseq + len(token_ids) + max_frames + 80)
                      // 64) * 64
        base_cache = self._fresh("base", cache_len)
        tts_cache = self._fresh("tts", cache_len)
        neg_cache = self._fresh("tts", cache_len)
        neg_cond = torch.zeros((1, cfg.hidden), dtype=self.dtype,
                               device=self.device)
        if vp is not None:
            inject_voice_kv(base_cache, vp["lm"], self.dtype)
            inject_voice_kv(tts_cache, vp["tts_lm"], self.dtype)
            inject_voice_kv(neg_cache, vp["neg_tts_lm"], self.dtype)
            neg_cond = vp["neg_hidden"][:, -1].to(self.device, self.dtype)
        elif clone_emb is not None:
            # the speech-type reference embeddings prefill the base and
            # positive TTS streams only; the CFG negative stays
            # unconditional. Padded to an 8-frame bucket, the pads masked
            # (valid_len), as the reference pads for its compile cache
            emb = clone_emb + self._type_embed(0).to(self.dtype)
            n_true = emb.shape[1]
            n_pad = -(-n_true // 8) * 8
            emb = F.pad(emb, (0, 0, 0, n_pad - n_true))
            self._base(emb, base_cache, n_true)
            self._tts(emb, tts_cache, n_true)
        text_type = self._type_embed(1).to(self.dtype)
        speech_type = self._type_embed(0).to(self.dtype)
        sf = float(self.params["speech_scaling_factor"])
        bf = float(self.params["speech_bias_factor"])
        embed = self.params["base"]["embed_tokens"]["weight"]
        latents: list[torch.Tensor] = []
        cursor, pos_last = 0, None
        while len(latents) < max_frames:
            window = token_ids[cursor:cursor + TEXT_WINDOW]
            if window:
                emb = embed[torch.tensor([window], device=self.device)]
                h = self._base(emb.to(self.dtype), base_cache) + text_type
                pos_last = self._tts(h, tts_cache)
                cursor += len(window)
            if pos_last is None:
                break
            n_frames = SPEECH_WINDOW if cursor < len(token_ids) \
                else max_frames - len(latents)
            stop = False
            for _ in range(n_frames):
                if len(latents) >= max_frames:
                    break
                cond = pos_last[:, -1]
                i = len(latents)
                noise = (frame_noise[i] if frame_noise is not None else
                         torch.randn((1, cfg.acoustic_dim), generator=gen))
                latent = self._sample_latent(cond, neg_cond, scale, steps,
                                             noise)
                latents.append((latent[0] / sf - bf).float())
                if on_frame:
                    on_frame(len(latents))
                if frame_log is not None:
                    frame_log.append({
                        "cond": cond.float().cpu(),
                        "latent": latent.float().cpu(),
                        "eos": float(eos_probability(self.params["eos"],
                                                     cond)[0, 0])})
                if len(latents) >= 3 and float(eos_probability(
                        self.params["eos"], cond)[0, 0]) > 0.9:
                    stop = True
                    break
                if frame_latents is not None:
                    latent = frame_latents[i].to(self.device, self.dtype)
                emb = connector_forward(cfg, self.params["connector"],
                                        latent)[:, None, :] + speech_type
                pos_last = self._tts(emb, tts_cache)
                neg_cond = self._tts(emb, neg_cache)[:, -1]
            if stop or cursor >= len(token_ids):
                break
        self._sync()
        t1 = time.perf_counter()
        self.stats = {"frames": len(latents), "lm_s": t1 - t0,
                      "vae_s": 0.0}
        if not latents:
            return AudioOutput(samples=np.zeros(0, np.float32),
                               sample_rate=cfg.sample_rate)
        wav = self.decode_latents(torch.stack(latents)[None])
        self._sync()
        self.stats["vae_s"] = time.perf_counter() - t1
        return AudioOutput(
            samples=np.clip(wav[0].float().cpu().numpy(), -1.0, 1.0),
            sample_rate=cfg.sample_rate)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """[1, T, acoustic_dim] denormalized latents -> [1, T * hop], in
        the VAE's dtype (the latents cast to it)."""
        vae = self.params["vae"]
        return vae_decode_frames(self.cfg, vae,
                                 latents.to(vae["head"]["weight"].dtype))

    # -- helpers ------------------------------------------------------------

    def _encode_text(self, text: str) -> list[int]:
        if self.tokenizer is not None:
            return list(self.tokenizer.encode(text))
        # the demo fallback: deterministic hash tokens in the vocabulary
        v = self.cfg.lm_base.vocab_size
        return [(zlib.crc32(f"{text}:{i}".encode()) % (v - 4)) + 2
                for i in range(min(32, max(4, len(text) // 3)))]

    @torch.inference_mode()
    def encode_voice_reference(self, samples: np.ndarray):
        """Raw 24 kHz mono samples -> (features [1, T, D], connected [1, T,
        hidden]): features = (latents + bias) * scale, then the connector.
        The clip is padded to an 8-hop grid (the reference's compile
        bucket) and the frames past the clip's own are cut off."""
        if "vae_enc" not in self.params:
            raise ValueError(
                "this checkpoint has no acoustic encoder, so raw-wav voice "
                "cloning is unavailable — pass a precomputed voice-prompt "
                "file instead")
        cfg = self.cfg
        samples = np.asarray(samples, np.float32)
        n_true = encoder_frames(cfg, max(len(samples), 1))
        grid = max(cfg.hop, 1) * 8
        need = max(-(-len(samples) // grid) * grid, grid)
        if len(samples) < need:
            samples = np.pad(samples, (0, need - len(samples)))
        enc = self.params["vae_enc"]
        lat = vae_encode_wav(cfg, enc, torch.from_numpy(samples[None]).to(
            self.device, enc["head"]["weight"].dtype))
        sf = self.params["speech_scaling_factor"].to(self.dtype)
        bf = self.params["speech_bias_factor"].to(self.dtype)
        features = ((lat + bf) * sf).to(self.dtype)
        connected = connector_forward(cfg, self.params["connector"],
                                      features)
        return features[:, :n_true], connected[:, :n_true]

    def _voice_embeds(self, voice_wav: bytes):
        cfg = self.cfg
        samples, sr = decode_wav(voice_wav)
        if sr != cfg.sample_rate and len(samples) > 1:
            # resample to the model's rate; downsampling low-passes at the
            # target Nyquist first (an FFT brick wall)
            if sr > cfg.sample_rate:
                spec = np.fft.rfft(samples)
                spec[int(len(spec) * cfg.sample_rate / sr):] = 0.0
                samples = np.fft.irfft(spec, n=len(samples))
            n_out = int(len(samples) * cfg.sample_rate / sr)
            samples = np.interp(
                np.linspace(0, len(samples) - 1, max(n_out, 2)),
                np.arange(len(samples)), samples).astype(np.float32)
        return self.encode_voice_reference(samples)[1]
