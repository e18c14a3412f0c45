"""LuxTTS text-to-speech (counterpart of cake_tpu/models/audio/luxtts.py:
LuxTTSConfig, luxtts_config_from_hf, tiny_luxtts_config, the Zipformer
primitives and layer, the text encoder, the flow-matching decoder, the
Euler schedule, the Vocos vocoder, the host ISTFT, resampler and mel
features, the Phonemizer and the LuxTTS facade).

    tts = LuxTTS(tiny_luxtts_config(), device="cuda")
    audio = tts.generate_speech("hello there", seed=3)
    open("out.wav", "wb").write(audio.wav_bytes())

Pipeline: text -> Phonemizer (tokens.txt) -> Zipformer text encoder ->
the text condition stretched to the frame count -> flow-matching decoder
(stacks of Zipformer layers, each stack downsampled by its factor and
given its own time embedding; Euler steps over a t_shift-warped schedule)
-> Vocos (ConvNeXt backbone, head to log-magnitude and phase) -> ISTFT
on the host -> 2x linear resampling to 48 kHz.

A Zipformer layer: one relative-position attention (no 1/sqrt(d) scale,
a float32 softmax) whose weights feed a tanh-gated nonlinear attention
(head 0 only) and two value self-attentions; three SwooshL feed-forwards;
two GLU -> depthwise conv -> SwooshR convolution modules; BiasNorm; the
learned bypass scales (mid and final). Everything is plain PyTorch on the
model's device, as the reference is plain XLA: no hand-written kernel
lies on this path. The ISTFT overlap-add, the resampler and the mel
features are host numpy, as in the reference.

The initial noise is drawn from a CPU generator seeded by the request's
seed, then moved; `noise=` takes it from the caller (parity tests pass
the reference's jax.random draw), and `step_log=` is a list that collects
x after each Euler step (on the host). The vocoder runs in its own dtype
(float32 from a checkpoint), the mel cast to it: the reference casts the
mel to the model dtype and its bf16 model with a float32 Vocos fails
(ROADMAP §3). The seeded initializers draw from a generator and take
their shapes from the config alone, so any Vocos depth seeds and loads
(the reference's Vocos seeding runs out of keys past two layers).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...ops.conv import conv1d, depthwise_conv1d
from ...ops.diffusion import flow_matching_euler_step
from ...ops.linear import linear
from ...ops.norms import layer_norm
from ...utils.init import generator, normal
from ...utils.wav import decode_wav
from .vibevoice import AudioOutput

log = logging.getLogger("cake_tpu_torch.luxtts")


# -- config ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LuxTTSConfig:
    """The defaults are the published widths."""
    vocab_size: int = 256
    feat_dim: int = 100                       # mel features
    text_encoder_dim: int = 192
    text_encoder_num_layers: int = 4
    text_encoder_feedforward_dim: int = 512
    text_encoder_num_heads: int = 4
    text_encoder_cnn_module_kernel: int = 9
    fm_decoder_dim: int = 512
    fm_decoder_feedforward_dim: int = 1536
    fm_decoder_num_heads: int = 4
    fm_decoder_num_layers: tuple[int, ...] = (2, 2, 4, 4, 4)
    fm_decoder_downsampling_factor: tuple[int, ...] = (1, 2, 4, 2, 1)
    fm_decoder_cnn_module_kernel: tuple[int, ...] = (31, 15, 7, 15, 31)
    query_head_dim: int = 32
    value_head_dim: int = 12
    pos_dim: int = 48
    pos_head_dim: int = 4
    time_embed_dim: int = 192
    # feature extraction / vocoder
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 100
    sample_rate: int = 24000
    vocos_dim: int = 512
    vocos_layers: int = 8
    vocos_kernel: int = 7
    feat_scale: float = 0.1

    @property
    def total_fm_layers(self) -> int:
        return sum(self.fm_decoder_num_layers)

    def stack_of(self, flat_idx: int) -> int:
        i = flat_idx
        for s, n in enumerate(self.fm_decoder_num_layers):
            if i < n:
                return s
            i -= n
        raise IndexError(flat_idx)


def luxtts_config_from_hf(raw: dict) -> LuxTTSConfig:
    """The release config.json: {"model": {...}, "feature": {...}}. The
    Vocos widths are not in it (the loader reads them off the weights)."""
    m = raw.get("model", raw)
    f = raw.get("feature", {})
    return LuxTTSConfig(
        vocab_size=m.get("vocab_size", 256),
        feat_dim=m.get("feat_dim", 100),
        text_encoder_dim=m["text_encoder_dim"],
        text_encoder_num_layers=m["text_encoder_num_layers"],
        text_encoder_feedforward_dim=m["text_encoder_feedforward_dim"],
        text_encoder_num_heads=m["text_encoder_num_heads"],
        text_encoder_cnn_module_kernel=m.get("text_encoder_cnn_module_kernel",
                                             9),
        fm_decoder_dim=m["fm_decoder_dim"],
        fm_decoder_feedforward_dim=m["fm_decoder_feedforward_dim"],
        fm_decoder_num_heads=m["fm_decoder_num_heads"],
        fm_decoder_num_layers=tuple(m["fm_decoder_num_layers"]),
        fm_decoder_downsampling_factor=tuple(
            m["fm_decoder_downsampling_factor"]),
        fm_decoder_cnn_module_kernel=tuple(m["fm_decoder_cnn_module_kernel"]),
        query_head_dim=m.get("query_head_dim", 32),
        value_head_dim=m.get("value_head_dim", 12),
        pos_dim=m.get("pos_dim", 48),
        pos_head_dim=m.get("pos_head_dim", 4),
        time_embed_dim=m.get("time_embed_dim", 192),
        n_fft=f.get("n_fft", 1024), hop_length=f.get("hop_length", 256),
        n_mels=f.get("n_mels", 100),
        sample_rate=f.get("sample_rate", 24000),
    )


def tiny_luxtts_config() -> LuxTTSConfig:
    return LuxTTSConfig(
        vocab_size=96, feat_dim=16, text_encoder_dim=32,
        text_encoder_num_layers=1, text_encoder_feedforward_dim=64,
        text_encoder_num_heads=2, text_encoder_cnn_module_kernel=5,
        fm_decoder_dim=32, fm_decoder_feedforward_dim=64,
        fm_decoder_num_heads=2, fm_decoder_num_layers=(1, 1),
        fm_decoder_downsampling_factor=(1, 2),
        fm_decoder_cnn_module_kernel=(5, 5),
        query_head_dim=8, value_head_dim=4, pos_dim=12, pos_head_dim=2,
        time_embed_dim=16, n_fft=64, hop_length=16, n_mels=16,
        vocos_dim=32, vocos_layers=2, vocos_kernel=5,
    )


# -- primitives --------------------------------------------------------------


def swoosh_r(x):
    """log(1 + exp(x - 1)) - 0.08 x - 0.313261687"""
    return F.softplus(x - 1.0) - 0.08 * x - 0.313261687


def swoosh_l(x):
    """log(1 + exp(x - 4)) - 0.08 x - 0.035"""
    return F.softplus(x - 4.0) - 0.08 * x - 0.035


def bias_norm(x, p, eps: float = 1e-5):
    """x * exp(log_scale) / rms(x - bias): the RMS is of x - bias, the
    scaled value is x itself."""
    xc = (x - p["bias"]).float()
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (x.float() * inv * torch.exp(p["log_scale"].float())).to(x.dtype)


def _bypass(scale, orig, x):
    """orig + (x - orig) * scale"""
    return orig + (x - orig) * scale


def zipformer_pos_emb(seq_len: int, pos_dim: int) -> np.ndarray:
    """The compact relative positional encoding [1, 2S - 1, pos_dim]
    (host numpy)."""
    pos_len = 2 * seq_len - 1
    half = pos_dim // 2
    comp = math.sqrt(pos_dim)
    length_scale = pos_dim / (2.0 * math.pi)
    t = np.arange(pos_len, dtype=np.float32) - (seq_len - 1)
    xc = comp * np.sign(t) * (np.log(np.abs(t) + comp) - math.log(comp))
    xa = np.arctan(xc / length_scale)
    out = np.zeros((pos_len, pos_dim), np.float32)
    for i in range(half):
        out[:, 2 * i] = np.cos(xa * (i + 1))
        out[:, 2 * i + 1] = np.sin(xa * (i + 1))
    out[:, pos_dim - 1] = 1.0
    return out[None]


def _pos(seq_len: int, cfg: LuxTTSConfig, like: torch.Tensor):
    return torch.from_numpy(zipformer_pos_emb(seq_len, cfg.pos_dim)).to(
        like.device, like.dtype)


# -- seeded parameters -------------------------------------------------------


def _lin_p(gen, o, i, dtype, device, std=0.05):
    return {"weight": normal(gen, (o, i), dtype, device, std),
            "bias": _full((o,), 0.0, dtype, device)}


def _full(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


def init_zip_layer(cfg: LuxTTSConfig, gen, dim, ff_dim, heads, kernel,
                   dtype=torch.float32, device="cpu") -> dict:
    """One Zipformer layer's parameters (the reference's initializer's
    shapes and scales; "meta" gives shapes only)."""
    qhd, phd, vhd = cfg.query_head_dim, cfg.pos_head_dim, cfg.value_head_dim

    def lin(o, i):
        return _lin_p(gen, o, i, dtype, device)

    p: dict = {
        "norm": {"bias": _full((dim,), 0.0, dtype, device),
                 "log_scale": _full((1,), 0.0, dtype, device)},
        "self_attn_weights": {
            "in_proj": lin(heads * (2 * qhd + phd), dim),
            "linear_pos": {"weight": normal(
                gen, (heads * phd, cfg.pos_dim), dtype, device, 0.05)},
        },
        "bypass": {"bypass_scale": _full((dim,), 0.5, dtype, device)},
        "bypass_mid": {"bypass_scale": _full((dim,), 0.5, dtype, device)},
    }
    for name, fdim in (("feed_forward1", ff_dim * 3 // 4),
                       ("feed_forward2", ff_dim),
                       ("feed_forward3", ff_dim * 5 // 4)):
        p[name] = {"in_proj": lin(fdim, dim), "out_proj": lin(dim, fdim)}
    for name in ("self_attn1", "self_attn2"):
        p[name] = {"in_proj": lin(heads * vhd, dim),
                   "out_proj": lin(dim, heads * vhd)}
    hidden = 3 * dim // 4
    p["nonlin_attention"] = {"in_proj": lin(3 * hidden, dim),
                             "out_proj": lin(dim, hidden)}
    for name in ("conv_module1", "conv_module2"):
        p[name] = {
            "in_proj": lin(2 * dim, dim),
            "depthwise_conv": {
                "weight": normal(gen, (dim, 1, kernel), dtype, device, 0.1),
                "bias": _full((dim,), 0.0, dtype, device)},
            "out_proj": lin(dim, dim)}
    return p


def init_luxtts_params(cfg: LuxTTSConfig, seed: int = 0,
                       dtype=torch.float32, device="cpu") -> dict:
    """Everything but the vocoder (init_vocos_params), drawn on `device`.
    Per-stack entries are lists over the stacks, None where a stack does
    not downsample."""
    gen = generator(seed, device)
    te_dim, fm_dim = cfg.text_encoder_dim, cfg.fm_decoder_dim

    def lin(o, i):
        return _lin_p(gen, o, i, dtype, device)

    return {
        "embed": {"weight": normal(gen, (cfg.vocab_size, te_dim), dtype,
                                   device, 0.05)},
        "text_encoder": {
            "in_proj": lin(te_dim, te_dim),
            "out_proj": lin(cfg.feat_dim, te_dim),
            "layers": [init_zip_layer(
                cfg, gen, te_dim, cfg.text_encoder_feedforward_dim,
                cfg.text_encoder_num_heads, cfg.text_encoder_cnn_module_kernel,
                dtype, device) for _ in range(cfg.text_encoder_num_layers)],
        },
        "fm_decoder": {
            "in_proj": lin(fm_dim, cfg.feat_dim * 3),
            "out_proj": lin(cfg.feat_dim, fm_dim),
            "time_embed_0": lin(cfg.time_embed_dim * 2, cfg.time_embed_dim),
            "time_embed_2": lin(cfg.time_embed_dim, cfg.time_embed_dim * 2),
            "stack_time_emb": [lin(fm_dim, cfg.time_embed_dim)
                               for _ in cfg.fm_decoder_num_layers],
            "downsample": [
                {"bias": _full((ds,), 0.0, dtype, device)} if ds > 1 else None
                for ds in cfg.fm_decoder_downsampling_factor],
            "out_combiner": [
                {"bypass_scale": _full((fm_dim,), 0.5, dtype, device)}
                if ds > 1 else None
                for ds in cfg.fm_decoder_downsampling_factor],
            "layers": [init_zip_layer(
                cfg, gen, fm_dim, cfg.fm_decoder_feedforward_dim,
                cfg.fm_decoder_num_heads,
                cfg.fm_decoder_cnn_module_kernel[cfg.stack_of(i)], dtype,
                device) for i in range(cfg.total_fm_layers)],
        },
    }


def init_vocos_params(cfg: LuxTTSConfig, seed: int = 0, dtype=torch.float32,
                      device="cpu") -> dict:
    """The vocoder's parameters at any depth, its periodic Hann window
    included."""
    gen = generator(seed, device)
    d, k = cfg.vocos_dim, cfg.vocos_kernel
    n_freq = cfg.n_fft // 2 + 1

    def ln():
        return {"weight": _full((d,), 1.0, dtype, device),
                "bias": _full((d,), 0.0, dtype, device)}

    window = np.hanning(cfg.n_fft + 1)[:-1].astype(np.float32)
    return {
        "embed": {"weight": normal(gen, (d, cfg.feat_dim, k), dtype, device,
                                   0.05),
                  "bias": _full((d,), 0.0, dtype, device)},
        "norm": ln(),
        "convnext": [{
            "dwconv": {"weight": normal(gen, (d, 1, k), dtype, device, 0.1),
                       "bias": _full((d,), 0.0, dtype, device)},
            "gamma": _full((d,), 0.1, dtype, device),
            "norm": ln(),
            "pwconv1": _lin_p(gen, 3 * d, d, dtype, device),
            "pwconv2": _lin_p(gen, d, 3 * d, dtype, device),
        } for _ in range(cfg.vocos_layers)],
        "final_layer_norm": ln(),
        "head_out": _lin_p(gen, 2 * n_freq, d, dtype, device),
        "istft_window": (torch.empty(cfg.n_fft, device="meta")
                         if torch.device(device).type == "meta" else
                         torch.from_numpy(window).to(device)),
    }


# -- the Zipformer layer -----------------------------------------------------


def _lp(p, x):
    return linear(x, p["weight"], p.get("bias"))


def _attn_weights(cfg: LuxTTSConfig, p, x, pos_emb, heads):
    """[B, S, D] -> softmax attention weights [B, H, S, S] with the
    compact relative-position term; the scores in float32."""
    b, s, _ = x.shape
    qhd, phd = cfg.query_head_dim, cfg.pos_head_dim
    proj = _lp(p["in_proj"], x)
    q = proj[..., :heads * qhd].reshape(b, s, heads, qhd)
    k = proj[..., heads * qhd:2 * heads * qhd].reshape(b, s, heads, qhd)
    pp = proj[..., 2 * heads * qhd:].reshape(b, s, heads, phd)
    # content scores (Zipformer: no 1/sqrt(d) scale)
    content = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    # positional scores against [1, 2S - 1, pos_dim]
    pos_proj = linear(pos_emb, p["linear_pos"]["weight"]).reshape(
        1, -1, heads, phd)
    pos_scores = torch.einsum("bshd,bthd->bhst", pp.float(),
                              pos_proj.float())
    # the relative shift: row i keeps columns [S - 1 - i, 2S - 1 - i)
    ar = torch.arange(s, device=x.device)
    idx = (s - 1) - ar[:, None] + ar[None, :]
    pos_scores = pos_scores.gather(
        3, idx[None, None].expand(b, heads, s, s))
    return torch.softmax(content + pos_scores, dim=-1).to(x.dtype)


def _self_attn(cfg: LuxTTSConfig, p, x, attn):
    b, s, _ = x.shape
    heads = attn.shape[1]
    v = _lp(p["in_proj"], x).reshape(b, s, heads, cfg.value_head_dim)
    out = torch.einsum("bhst,bthd->bshd", attn, v).reshape(
        b, s, heads * cfg.value_head_dim)
    return _lp(p["out_proj"], out)


def _nonlin_attn(p, x, attn_head0):
    proj = _lp(p["in_proj"], x)
    sgn, xv, y = proj.chunk(3, dim=-1)
    xg = xv * torch.tanh(sgn)
    # a single-head weighting with attention head 0
    out = torch.einsum("bst,btd->bsd", attn_head0, xg)
    return _lp(p["out_proj"], out * y)


def _conv_module(p, x):
    d = x.shape[-1]
    proj = _lp(p["in_proj"], x)
    a, g = proj[..., :d], proj[..., d:]
    h = (a * torch.sigmoid(g)).transpose(1, 2)                   # [B, D, S]
    w = p["depthwise_conv"]["weight"]
    h = depthwise_conv1d(h, w, p["depthwise_conv"]["bias"],
                         padding=w.shape[-1] // 2)
    return _lp(p["out_proj"], swoosh_r(h.transpose(1, 2)))


def _ffn(p, x):
    return _lp(p["out_proj"], swoosh_l(_lp(p["in_proj"], x)))


def zip_layer_forward(cfg: LuxTTSConfig, p: dict, x, pos_emb, heads,
                      time_emb=None):
    """One Zipformer encoder layer, in the reference's order."""
    orig = x
    attn = _attn_weights(cfg, p["self_attn_weights"], x, pos_emb, heads)
    if time_emb is not None:
        x = x + time_emb
    x = x + _ffn(p["feed_forward1"], x)
    x = x + _nonlin_attn(p["nonlin_attention"], x, attn[:, 0])
    x = x + _self_attn(cfg, p["self_attn1"], x, attn)
    if time_emb is not None:
        x = x + time_emb
    x = x + _conv_module(p["conv_module1"], x)
    x = x + _ffn(p["feed_forward2"], x)
    x = _bypass(p["bypass_mid"]["bypass_scale"], orig, x)
    x = x + _self_attn(cfg, p["self_attn2"], x, attn)
    if time_emb is not None:
        x = x + time_emb
    x = x + _conv_module(p["conv_module2"], x)
    x = x + _ffn(p["feed_forward3"], x)
    x = bias_norm(x, p["norm"])
    return _bypass(p["bypass"]["bypass_scale"], orig, x)


# -- the text encoder and the flow-matching decoder --------------------------


def text_encode(cfg: LuxTTSConfig, p: dict, token_ids):
    """token_ids [B, S] -> the text condition [B, S, feat_dim]."""
    x = p["embed"]["weight"][token_ids]
    te = p["text_encoder"]
    x = _lp(te["in_proj"], x)
    pos = _pos(x.shape[1], cfg, x)
    for lp_ in te["layers"]:
        x = zip_layer_forward(cfg, lp_, x, pos, cfg.text_encoder_num_heads)
    return _lp(te["out_proj"], x)


def sinusoidal_time_embedding(t, dim: int, device="cpu"):
    """[cos(t freqs); sin(t freqs)] with freqs exp(-ln 1e4 i / (half - 1)),
    float32, [1, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=device)
                      / max(half - 1, 1))
    args = torch.as_tensor(t, dtype=torch.float32, device=device) * freqs
    return torch.cat([torch.cos(args), torch.sin(args)])[None]


def _downsample(x, ds: int, bias):
    """A softmax(bias)-weighted average over groups of ds frames, the last
    frame repeated to fill the last group."""
    b, s, d = x.shape
    n = -(-s // ds)
    if n * ds > s:
        x = torch.cat([x, x[:, -1:].expand(b, n * ds - s, d)], dim=1)
    w = torch.softmax(bias.float(), dim=-1).to(x.dtype)
    return torch.einsum("bngd,g->bnd", x.reshape(b, n, ds, d), w)


def _upsample(x, ds: int):
    b, s, d = x.shape
    return x[:, :, None].expand(b, s, ds, d).reshape(b, s * ds, d)


def fm_velocity(cfg: LuxTTSConfig, p: dict, x, text_cond, speech_cond, t):
    """One velocity evaluation of the flow-matching decoder: x, text_cond
    and speech_cond [B, T, feat_dim], t a float."""
    fm = p["fm_decoder"]
    temb = sinusoidal_time_embedding(t, cfg.time_embed_dim,
                                     x.device).to(x.dtype)
    temb = _lp(fm["time_embed_2"], swoosh_r(_lp(fm["time_embed_0"], temb)))
    h = _lp(fm["in_proj"], torch.cat([x, text_cond, speech_cond], dim=-1))
    flat = 0
    for s_idx, n_layers in enumerate(cfg.fm_decoder_num_layers):
        ds = cfg.fm_decoder_downsampling_factor[s_idx]
        orig = h
        if ds > 1:
            h = _downsample(h, ds, fm["downsample"][s_idx]["bias"])
        stack_te = _lp(fm["stack_time_emb"][s_idx], swoosh_r(temb))[:, None]
        pos = _pos(h.shape[1], cfg, h)
        for _ in range(n_layers):
            h = zip_layer_forward(cfg, fm["layers"][flat], h, pos,
                                  cfg.fm_decoder_num_heads, time_emb=stack_te)
            flat += 1
        if ds > 1:
            h = _upsample(h, ds)[:, :orig.shape[1]]
            h = _bypass(fm["out_combiner"][s_idx]["bypass_scale"], orig, h)
    return _lp(fm["out_proj"], h)


def euler_schedule(steps: int, t_shift: float) -> np.ndarray:
    """linspace(0, 1, steps + 1) warped by t_shift, float32."""
    t = np.linspace(0.0, 1.0, steps + 1, dtype=np.float32)
    if abs(t_shift - 1.0) > 1e-6:
        t = t_shift * t / (1.0 + (t_shift - 1.0) * t)
    return t


# -- the Vocos vocoder and the host audio ------------------------------------


def _ln(x, p, eps=1e-5):
    return layer_norm(x, p["weight"], p["bias"], eps)


def vocos_forward(cfg: LuxTTSConfig, p: dict, mel):
    """mel [B, feat_dim, T] -> (log-magnitude, phase), each [B, T,
    n_fft // 2 + 1]."""
    x = conv1d(mel, p["embed"]["weight"], p["embed"]["bias"],
               padding=cfg.vocos_kernel // 2)
    x = _ln(x.transpose(1, 2), p["norm"]).transpose(1, 2)
    for blk in p["convnext"]:
        res = x
        h = depthwise_conv1d(x, blk["dwconv"]["weight"],
                             blk["dwconv"]["bias"],
                             padding=cfg.vocos_kernel // 2)
        h = _ln(h.transpose(1, 2), blk["norm"])
        h = _lp(blk["pwconv2"], F.gelu(_lp(blk["pwconv1"], h)))
        x = res + (h * blk["gamma"]).transpose(1, 2)
    x = _ln(x.transpose(1, 2), p["final_layer_norm"])
    out = _lp(p["head_out"], x)
    n_freq = cfg.n_fft // 2 + 1
    return out[..., :n_freq], out[..., n_freq:]


def istft(cfg: LuxTTSConfig, log_mag: np.ndarray, phase: np.ndarray,
          window: np.ndarray) -> np.ndarray:
    """Vocos' ISTFT on the host: the magnitude exp(log_mag) clipped at 100
    with the phase, inverse real FFTs, windowed overlap-add normalized by
    the summed squared window, and the "same" trim."""
    mag = np.minimum(np.exp(log_mag), 100.0)
    spec = mag * (np.cos(phase) + 1j * np.sin(phase))   # [T, n_freq]
    frames = np.fft.irfft(spec, n=cfg.n_fft, axis=-1)   # [T, n_fft]
    frames = frames * window[None]
    n = frames.shape[0]
    hop = cfg.hop_length
    out_len = (n - 1) * hop + cfg.n_fft
    out = np.zeros(out_len, np.float32)
    env = np.zeros(out_len, np.float32)
    w2 = (window * window).astype(np.float32)
    for i in range(n):
        out[i * hop:i * hop + cfg.n_fft] += frames[i]
        env[i * hop:i * hop + cfg.n_fft] += w2
    out = out / np.maximum(env, 1e-8)
    pad = (cfg.n_fft - hop) // 2
    return out[pad:out_len - pad]


def resample_2x(x: np.ndarray) -> np.ndarray:
    """24 kHz -> 48 kHz by linear interpolation."""
    n = len(x)
    if n < 2:
        return np.repeat(x, 2).astype(np.float32)
    t = np.arange(2 * n, dtype=np.float32) / 2.0
    return np.interp(t, np.arange(n, dtype=np.float32), x).astype(np.float32)


def mel_spectrogram(cfg: LuxTTSConfig, samples: np.ndarray) -> np.ndarray:
    """Log-mel features of a reference clip [n_mels, T] (host numpy)."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    if len(samples) < n_fft:
        samples = np.pad(samples, (0, n_fft - len(samples)))
    window = np.hanning(n_fft + 1)[:-1]
    n_frames = 1 + (len(samples) - n_fft) // hop
    idx = np.arange(n_fft)[None] + hop * np.arange(n_frames)[:, None]
    spec = np.abs(np.fft.rfft(samples[idx] * window[None], axis=-1)) ** 2
    n_freq = n_fft // 2 + 1
    f = np.linspace(0, cfg.sample_rate / 2, n_freq)

    def hz2mel(h):
        return 2595.0 * np.log10(1.0 + h / 700.0)

    mels = np.linspace(hz2mel(0.0), hz2mel(cfg.sample_rate / 2),
                       cfg.n_mels + 2)
    hz = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    fb = np.zeros((cfg.n_mels, n_freq), np.float32)
    for m in range(cfg.n_mels):
        lo, c, hi = hz[m], hz[m + 1], hz[m + 2]
        up = (f - lo) / max(c - lo, 1e-8)
        down = (hi - f) / max(hi - c, 1e-8)
        fb[m] = np.maximum(0.0, np.minimum(up, down))
    mel = fb @ spec.T
    return np.log(np.maximum(mel, 1e-10)).astype(np.float32)


# -- the phonemizer ----------------------------------------------------------


class Phonemizer:
    """tokens.txt's symbol table and an optional word -> IPA dictionary
    (cmudict). Without the dictionary a word is looked up symbol by
    symbol; with an empty table each character becomes ord % vocab."""

    def __init__(self, tokens_path: str | None = None,
                 dict_path: str | None = None, vocab_size: int = 256):
        self.sym2id: dict[str, int] = {}
        self.word2ipa: dict[str, str] = {}
        self.vocab_size = vocab_size
        if tokens_path and os.path.exists(tokens_path):
            with open(tokens_path, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    # a symbol may BE a space (the word separator): split
                    # on the last space only
                    i = line.rfind(" ")
                    if i <= 0 or not line[i + 1:].isdigit():
                        continue
                    self.sym2id[line[:i]] = int(line[i + 1:])
        if dict_path and os.path.exists(dict_path):
            with open(dict_path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    parts = line.strip().split(None, 1)
                    if len(parts) == 2 and not parts[0].startswith(";"):
                        self.word2ipa[parts[0].lower()] = parts[1]

    def tokenize(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in text.lower().split():
            sym_text = self.word2ipa.get(word, word)
            for ch in sym_text:
                if ch in self.sym2id:
                    ids.append(self.sym2id[ch])
                elif not self.sym2id:
                    ids.append(ord(ch) % self.vocab_size)
            sp = self.sym2id.get(" ")
            if sp is not None:
                ids.append(sp)
        return ids or [0]


# -- the facade --------------------------------------------------------------


class LuxTTS:
    """generate_speech(text) -> AudioOutput at 48 kHz. `stats` holds the
    last generation's frames, steps, encode_s, fm_s (all velocity
    evaluations), s_per_eval, vocos_s and istft_s (the host ISTFT and
    resampling)."""

    def __init__(self, cfg: LuxTTSConfig, params: dict | None = None,
                 phonemizer: Phonemizer | None = None, dtype=torch.float32,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        if params is None:
            params = init_luxtts_params(cfg, seed, dtype, dev)
            # the vocoder in float32, as a checkpoint's loads
            params["vocos"] = init_vocos_params(cfg, seed + 1,
                                                torch.float32, dev)
        self.params = params
        self.phonemizer = phonemizer or Phonemizer(vocab_size=cfg.vocab_size)
        self.stats: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def encode_text(self, text: str, speed: float = 1.0,
                    max_frames: int | None = None):
        """The text condition stretched to the frame count: [1, frames,
        feat_dim], frames = int(tokens / speed), at most max_frames."""
        ids = self.phonemizer.tokenize(text)
        tc = text_encode(self.cfg, self.params, torch.tensor(
            [ids], dtype=torch.long, device=self.device))
        s = tc.shape[1]
        frames = max(int(s / max(speed, 1e-3)), 1)
        if max_frames:
            frames = min(frames, max_frames)
        idx = (np.arange(frames) * s) // frames
        return tc[:, torch.from_numpy(idx).to(self.device)]

    def speech_condition(self, voice_wav: bytes | None, frames: int):
        """Zeros, or feat_scale times the log-mel of the reference clip
        (resampled to the model's rate) stretched to the frame count."""
        cfg = self.cfg
        if voice_wav is None:
            return torch.zeros((1, frames, cfg.feat_dim), dtype=self.dtype,
                               device=self.device)
        samples, sr = decode_wav(voice_wav)
        if sr != cfg.sample_rate and len(samples) > 1:
            # linear resampling to the model's rate (the mel hop and
            # filterbank are built for it)
            n_out = int(len(samples) * cfg.sample_rate / sr)
            samples = np.interp(
                np.linspace(0, len(samples) - 1, max(n_out, 2)),
                np.arange(len(samples)), samples).astype(np.float32)
        mel = mel_spectrogram(cfg, samples)                     # [M, T]
        mi = (np.arange(frames) * mel.shape[1]) // max(frames, 1)
        mi = np.minimum(mi, mel.shape[1] - 1)
        # the model's space is feat_scale * mel (the output is divided by
        # feat_scale before the vocoder)
        return torch.from_numpy(mel.T[mi][None] * cfg.feat_scale).to(
            self.device, self.dtype)

    def vocode(self, x: torch.Tensor):
        """Euler output [1, frames, feat_dim] -> (log-magnitude, phase) on
        the device, in the vocoder's dtype: the mel is cast to the Vocos
        weights' dtype."""
        voc = self.params["vocos"]
        mel = (x.transpose(1, 2) / self.cfg.feat_scale).to(
            voc["embed"]["weight"].dtype)
        return vocos_forward(self.cfg, voc, mel)

    def waveform(self, log_mag, phase) -> np.ndarray:
        """The host half: ISTFT, clip to [-1, 1], 2x resampling."""
        window = self.params["vocos"]["istft_window"].float().cpu().numpy()
        wav = istft(self.cfg, log_mag[0].float().cpu().numpy(),
                    phase[0].float().cpu().numpy(), window)
        return resample_2x(np.clip(wav, -1.0, 1.0))

    @torch.inference_mode()
    def generate_speech(self, text: str, voice=None,
                        voice_wav: bytes | None = None,
                        steps: int = 4, t_shift: float = 0.7,
                        speed: float = 1.0, seed: int = 0,
                        cfg_scale=None, max_frames: int | None = None,
                        on_frame=None, noise=None,
                        step_log: list | None = None) -> AudioOutput:
        cfg = self.cfg
        if voice is not None or (cfg_scale not in (None, 1.0)):
            log.warning("LuxTTS ignores voice=/cfg_scale= (voice "
                        "conditioning uses voice_wav reference audio; flow "
                        "matching is CFG-free)")
        t0 = time.perf_counter()
        text_cond = self.encode_text(text, speed=speed,
                                     max_frames=max_frames)
        frames = text_cond.shape[1]
        speech_cond = self.speech_condition(voice_wav, frames)
        self._sync()
        t1 = time.perf_counter()
        ts = euler_schedule(steps, t_shift)
        if noise is None:
            noise = torch.randn((1, frames, cfg.feat_dim),
                                generator=torch.Generator().manual_seed(seed))
        x = torch.as_tensor(noise).to(self.device, self.dtype)
        for j in range(steps):
            v = fm_velocity(cfg, self.params, x, text_cond, speech_cond,
                            float(ts[j]))
            x = flow_matching_euler_step(x, v, float(ts[j]),
                                         float(ts[j + 1]))
            if step_log is not None:
                step_log.append(x.float().cpu())
            if on_frame:
                on_frame(j + 1)
        self._sync()
        t2 = time.perf_counter()
        log_mag, phase = self.vocode(x)
        self._sync()
        t3 = time.perf_counter()
        wav = self.waveform(log_mag, phase)
        t4 = time.perf_counter()
        self.stats = {"frames": frames, "steps": steps, "encode_s": t1 - t0,
                      "fm_s": t2 - t1, "s_per_eval": (t2 - t1) / max(steps, 1),
                      "vocos_s": t3 - t2, "istft_s": t4 - t3}
        return AudioOutput(samples=wav, sample_rate=cfg.sample_rate * 2)
