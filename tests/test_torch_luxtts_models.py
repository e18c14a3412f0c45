"""Module 14d's LuxTTS against the JAX package on the CPU, in float32, on
the same weights (the reference's seeded tree, every leaf but the ISTFT
window shifted by seeded noise so that no bias, scale or bypass is at its
initial constant, carried across by utils/weights.luxtts_params_from_numpy):

  * within 1e-5 (relative, or 1e-5 of the largest magnitude near zero):
    swoosh_r, swoosh_l, bias_norm, the bypass, zipformer_pos_emb and the
    sinusoidal time embedding;
  * within 1e-4: one Zipformer layer with and without a time embedding,
    text_encode, _downsample on lengths that need padding and _upsample,
    fm_velocity at the tiny config and at the cut of the published widths
    (text encoder 1 layer, FM stacks 1-1-1-1-1 at the published widths,
    downsampling and kernels, Vocos 2 layers), euler_schedule,
    vocos_forward at the published Vocos (512 x 8, on parameters built in
    numpy: the reference's own seeding stops at 2 layers), istft,
    mel_spectrogram and resample_2x;
  * within 1e-4 on the waveform: whole generate_speech runs from the
    reference's jax.random noise (passed in as `noise=`), at both
    configurations, without and with a 16 kHz voice_wav to clone;
  * the Phonemizer's ids equal the reference's: a space symbol, a
    cmudict, the empty-table fallback; and the release config parse.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.audio import luxtts as jlx
from cake_tpu.utils.wav import encode_wav
from cake_tpu_torch.bench.synth_luxtts import hf_config
from cake_tpu_torch.models.audio import luxtts as tlx
from cake_tpu_torch.utils.weights import (luxtts_params_from_numpy,
                                          tree_from_numpy)

torch.set_num_threads(1)

CUT = dict(text_encoder_num_layers=1, fm_decoder_num_layers=(1,) * 5,
           vocos_layers=2)
TEXT = "hello there, general"


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=1e-5):
    want = _f32(want)
    got = _f32(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jitter(tree, seed: int):
    """Every leaf (the ISTFT window aside) plus N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def go(node, key=""):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: go(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [go(v) for v in node]
        a = np.asarray(node, np.float32)
        if key == "istft_window":
            return a
        return (a + rng.standard_normal(a.shape) * 0.05).astype(np.float32)
    return go(tree)


def _pair(cfg_over: dict | None, seed: int):
    jcfg = jlx.tiny_luxtts_config() if cfg_over is None else \
        jlx.LuxTTSConfig(**cfg_over)
    tcfg = tlx.tiny_luxtts_config() if cfg_over is None else \
        tlx.LuxTTSConfig(**cfg_over)
    tree = _jitter(jax.tree.map(np.asarray, jlx.init_luxtts_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32)), seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = luxtts_params_from_numpy(tree, "cpu", torch.float32)
    return (jlx.LuxTTS(jcfg, params=jparams, dtype=jnp.float32),
            tlx.LuxTTS(tcfg, params=tparams, dtype=torch.float32,
                       device="cpu"))


@pytest.fixture(scope="module")
def tiny():
    return _pair(None, 3)


@pytest.fixture(scope="module")
def cut():
    return _pair(CUT, 4)


# -- primitives (1e-5) ---------------------------------------------------------


@pytest.mark.parametrize("fn", ["swoosh_r", "swoosh_l"])
def test_swoosh_matches_reference(fn):
    x = _rand((3, 7, 33), 1, 4.0)
    _close(getattr(tlx, fn)(torch.from_numpy(x)), getattr(jlx, fn)(x))


def test_bias_norm_and_bypass_match_reference():
    x = _rand((2, 9, 24), 2)
    p = {"bias": _rand((24,), 3), "log_scale": _rand((1,), 4, 0.3)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(tlx.bias_norm(torch.from_numpy(x), tp), jlx.bias_norm(x, p))
    orig, scale = _rand((2, 9, 24), 5), _rand((24,), 6)
    _close(tlx._bypass(torch.from_numpy(scale), torch.from_numpy(orig),
                       torch.from_numpy(x)), jlx._bypass(scale, orig, x))


@pytest.mark.parametrize("seq,pos_dim", [(1, 12), (7, 12), (40, 48),
                                         (131, 48)])
def test_pos_emb_matches_reference(seq, pos_dim):
    got = tlx.zipformer_pos_emb(seq, pos_dim)
    want = jlx.zipformer_pos_emb(seq, pos_dim)
    assert got.shape == want.shape == (1, 2 * seq - 1, pos_dim)
    _close(torch.from_numpy(got), want)


@pytest.mark.parametrize("t,dim", [(0.0, 16), (0.37, 192), (1.0, 2)])
def test_time_embedding_matches_reference(t, dim):
    _close(tlx.sinusoidal_time_embedding(t, dim),
           jlx.sinusoidal_time_embedding(t, dim))


# -- the Zipformer layer, encoder and decoder (1e-4) --------------------------


@pytest.mark.parametrize("with_time", [False, True])
def test_zip_layer_matches_reference(tiny, with_time):
    jm, tm = tiny
    cfg = jm.cfg
    dim, heads = cfg.fm_decoder_dim, cfg.fm_decoder_num_heads
    x = _rand((1, 11, dim), 7)
    pos = jlx.zipformer_pos_emb(11, cfg.pos_dim)
    temb = _rand((1, 1, dim), 8) if with_time else None
    want = jlx.zip_layer_forward(cfg, jm.params["fm_decoder"]["layers"][0],
                                 x, pos, heads, temb)
    got = tlx.zip_layer_forward(
        tm.cfg, tm.params["fm_decoder"]["layers"][0], torch.from_numpy(x),
        torch.from_numpy(pos), heads,
        None if temb is None else torch.from_numpy(temb))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("which", ["tiny", "cut"])
def test_text_encode_matches_reference(tiny, cut, which):
    jm, tm = tiny if which == "tiny" else cut
    ids = jm.phonemizer.tokenize(TEXT)
    want = jlx.text_encode(jm.cfg, jm.params, jnp.asarray([ids], jnp.int32))
    got = tlx.text_encode(tm.cfg, tm.params, torch.tensor([ids]))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("s,ds", [(7, 4), (9, 2), (8, 4), (1, 2)])
def test_downsample_and_upsample_match_reference(s, ds):
    x, bias = _rand((2, s, 6), 9), _rand((ds,), 10)
    want = jlx._downsample(x, ds, bias)
    got = tlx._downsample(torch.from_numpy(x), ds, torch.from_numpy(bias))
    _close(got, want, 1e-4)
    _close(tlx._upsample(got, ds)[:, :s], jlx._upsample(want, ds)[:, :s],
           1e-4)


@pytest.mark.parametrize("which,frames", [("tiny", 13), ("cut", 21)])
def test_fm_velocity_matches_reference(tiny, cut, which, frames):
    jm, tm = tiny if which == "tiny" else cut
    feat = jm.cfg.feat_dim
    x, tc, sc = (_rand((1, frames, feat), 11 + i) for i in range(3))
    want = jlx.fm_velocity(jm.cfg, jm.params, x, tc, sc, 0.4375)
    got = tlx.fm_velocity(tm.cfg, tm.params, *(torch.from_numpy(a)
                                                for a in (x, tc, sc)),
                          0.4375)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("steps,shift", [(4, 0.7), (10, 0.7), (3, 1.0)])
def test_euler_schedule_matches_reference(steps, shift):
    _close(torch.from_numpy(tlx.euler_schedule(steps, shift)),
           jlx.euler_schedule(steps, shift), 1e-4)


def _numpy_vocos(cfg, seed: int) -> dict:
    d, k = cfg.vocos_dim, cfg.vocos_kernel
    n_freq = cfg.n_fft // 2 + 1
    r = iter(range(seed, seed + 1000))

    def lin(o, i):
        return {"weight": _rand((o, i), next(r), 0.05),
                "bias": _rand((o,), next(r), 0.05)}

    def ln():
        return {"weight": 1.0 + _rand((d,), next(r), 0.05),
                "bias": _rand((d,), next(r), 0.05)}
    return {
        "embed": {"weight": _rand((d, cfg.feat_dim, k), next(r), 0.05),
                  "bias": _rand((d,), next(r), 0.05)},
        "norm": ln(),
        "convnext": [{"dwconv": {"weight": _rand((d, 1, k), next(r), 0.1),
                                 "bias": _rand((d,), next(r), 0.05)},
                      "gamma": 0.1 + _rand((d,), next(r), 0.02),
                      "norm": ln(), "pwconv1": lin(3 * d, d),
                      "pwconv2": lin(d, 3 * d)}
                     for _ in range(cfg.vocos_layers)],
        "final_layer_norm": ln(),
        "head_out": lin(2 * n_freq, d),
        "istft_window": np.hanning(cfg.n_fft + 1)[:-1].astype(np.float32),
    }


def test_vocos_at_eight_layers_matches_reference():
    cfg = jlx.LuxTTSConfig()
    assert cfg.vocos_layers == 8 and cfg.vocos_dim == 512
    p = _numpy_vocos(cfg, 20)
    mel = _rand((1, cfg.feat_dim, 19), 12, 2.0)
    want = jlx.vocos_forward(cfg, jax.tree.map(jnp.asarray, p), mel)
    got = tlx.vocos_forward(tlx.LuxTTSConfig(),
                            tree_from_numpy(p, "cpu", torch.float32),
                            torch.from_numpy(mel))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


# -- host audio (1e-4) -------------------------------------------------------


@pytest.mark.parametrize("cfg_name", ["tiny", "published"])
def test_host_audio_matches_reference(cfg_name):
    jcfg = (jlx.tiny_luxtts_config() if cfg_name == "tiny"
            else jlx.LuxTTSConfig())
    tcfg = (tlx.tiny_luxtts_config() if cfg_name == "tiny"
            else tlx.LuxTTSConfig())
    n_freq = jcfg.n_fft // 2 + 1
    log_mag, phase = _rand((9, n_freq), 13, 2.0), _rand((9, n_freq), 14, 3.0)
    window = np.hanning(jcfg.n_fft + 1)[:-1].astype(np.float32)
    wav = tlx.istft(tcfg, log_mag, phase, window)
    want = jlx.istft(jcfg, log_mag, phase, window)
    assert len(wav) == 9 * jcfg.hop_length
    _close(torch.from_numpy(wav), want, 1e-4)
    _close(torch.from_numpy(tlx.resample_2x(np.clip(wav, -1, 1))),
           jlx.resample_2x(np.clip(want, -1, 1)), 1e-4)
    samples = _rand((3 * jcfg.n_fft + 17,), 15, 0.3)
    _close(torch.from_numpy(tlx.mel_spectrogram(tcfg, samples)),
           jlx.mel_spectrogram(jcfg, samples), 1e-4)
    short = samples[:jcfg.n_fft // 3]
    _close(torch.from_numpy(tlx.mel_spectrogram(tcfg, short)),
           jlx.mel_spectrogram(jcfg, short), 1e-4)
    for n in (0, 1, 5):
        assert np.array_equal(tlx.resample_2x(samples[:n]),
                              jlx.resample_2x(samples[:n]))


# -- whole generations (1e-4 on the waveform) --------------------------------


def _clip_16k() -> bytes:
    t = np.arange(16000) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 180 * t) + 0.1 * _rand((16000,), 16)
    return encode_wav(sig.astype(np.float32), 16000)


@pytest.mark.parametrize("which", ["tiny", "cut"])
@pytest.mark.parametrize("clone", [False, True])
def test_generate_speech_matches_reference(tiny, cut, which, clone):
    jm, tm = tiny if which == "tiny" else cut
    voice = _clip_16k() if clone else None
    seed, steps = 7, 4
    frames = len(jm.phonemizer.tokenize(TEXT))
    noise = np.array(jax.random.normal(
        jax.random.PRNGKey(seed), (1, frames, jm.cfg.feat_dim), jnp.float32))
    want = jm.generate_speech(TEXT, voice_wav=voice, steps=steps, seed=seed)
    seen = []
    got = tm.generate_speech(TEXT, voice_wav=voice, steps=steps,
                             noise=torch.from_numpy(noise),
                             on_frame=seen.append)
    assert seen == list(range(1, steps + 1))
    assert got.sample_rate == want.sample_rate == 2 * jm.cfg.sample_rate
    assert len(got.samples) == 2 * frames * jm.cfg.hop_length
    assert tm.stats["frames"] == frames and np.abs(got.samples).max() > 0
    _close(torch.from_numpy(got.samples), want.samples, 1e-4)


def test_speed_and_max_frames_match_reference(tiny):
    jm, tm = tiny
    s = len(jm.phonemizer.tokenize(TEXT))
    for speed, max_frames in ((0.7, None), (1.3, None), (1.0, 5)):
        frames = max(int(s / speed), 1)
        frames = min(frames, max_frames or frames)
        noise = np.array(jax.random.normal(
            jax.random.PRNGKey(0), (1, frames, jm.cfg.feat_dim)))
        want = jm.generate_speech(TEXT, steps=2, speed=speed,
                                  max_frames=max_frames)
        got = tm.generate_speech(TEXT, steps=2, speed=speed,
                                 max_frames=max_frames,
                                 noise=torch.from_numpy(noise))
        assert tm.stats["frames"] == frames
        _close(torch.from_numpy(got.samples), want.samples, 1e-4)


def test_seeded_noise_is_the_cpu_generator(tiny):
    _, tm = tiny
    a = tm.generate_speech("hi", steps=2, seed=5)
    noise = torch.randn((1, tm.stats["frames"], tm.cfg.feat_dim),
                        generator=torch.Generator().manual_seed(5))
    b = tm.generate_speech("hi", steps=2, noise=noise)
    assert np.array_equal(a.samples, b.samples)


# -- phonemizer and config ---------------------------------------------------


@pytest.mark.parametrize("table,cmudict", [
    (None, None),
    ({"_": 0, " ": 1, **{c: i + 2 for i, c in enumerate("abcdefghij")}},
     None),
    ({"_": 0, " ": 1, "h": 2, "ə": 3, "l": 4, "o": 5, "ʊ": 6},
     "HELLO  həloʊ\n;;; a comment\nworld wɜld\nbroken\n")])
def test_phonemizer_matches_reference(tmp_path, table, cmudict):
    tok = dic = None
    if table is not None:
        tok = tmp_path / "tokens.txt"
        with open(tok, "w", encoding="utf-8") as f:
            for sym, i in table.items():
                f.write(f"{sym} {i}\n")
            f.write("nonsense\n#x notanumber\n")
        tok = str(tok)
    if cmudict is not None:
        dic = tmp_path / "cmudict.txt"
        dic.write_text(cmudict, encoding="utf-8")
        dic = str(dic)
    ours = tlx.Phonemizer(tok, dic, vocab_size=96)
    theirs = jlx.Phonemizer(tok, dic, vocab_size=96)
    if table is not None:
        assert ours.sym2id == theirs.sym2id == table
    for text in ("Hello world", "abc  def", "", "héllo — ünïcode",
                 "hello hello"):
        assert ours.tokenize(text) == theirs.tokenize(text), text


@pytest.mark.parametrize("cfg", [tlx.LuxTTSConfig(),
                                 tlx.tiny_luxtts_config(),
                                 tlx.LuxTTSConfig(**CUT)])
def test_config_parse_matches_reference(cfg):
    raw = hf_config(cfg)
    ours, theirs = (tlx.luxtts_config_from_hf(raw),
                    jlx.luxtts_config_from_hf(raw))
    for f in dataclasses.fields(ours):
        if not f.name.startswith("vocos"):
            assert getattr(ours, f.name) == getattr(theirs, f.name) == \
                getattr(cfg, f.name), f.name
    assert ours.total_fm_layers == theirs.total_fm_layers
    assert [ours.stack_of(i) for i in range(ours.total_fm_layers)] == \
        [theirs.stack_of(i) for i in range(theirs.total_fm_layers)]
