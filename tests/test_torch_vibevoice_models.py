"""Module 14d's VibeVoice against the JAX package on the CPU, in float32,
its seeded parameters carried across as numpy
(utils/weights.vibevoice_params_from_numpy): the diffusion head, the
acoustic connector, the EOS classifier, the sigma-VAE decoder and
encoder, the encoder's frame count and the voice-prompt KV injection
(within 1e-5 relative, or 1e-5 of the largest magnitude near zero), the
release config parse, and whole generate_speech runs with the
reference's per-frame jax.random draws passed in (frame_noise): the same
frame count, the latents and the waveform within 1e-4, with no voice,
with a voice-prompt file, with a raw WAV to clone (at 24 kHz and through
both resampling paths) and with the EOS classifier stopping after three
frames. Whole runs are held to 1e-4 up to five frames:
test_rounding_growth_over_frames says why, and what holds past that;
teacher-forced with the reference's latents (frame_latents), all eight
frames stay within 1e-5, and forced with its own latents a run is its
free run bit for bit."""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.audio import vibevoice as jvv
from cake_tpu.utils.wav import encode_wav
from cake_tpu_torch.bench.synth_vibevoice import hf_config, write_voice_prompt
from cake_tpu_torch.models.audio import vibevoice as tvv
from cake_tpu_torch.models.audio.vibevoice_loader import REALTIME_0_5B
from cake_tpu_torch.utils.weights import (tree_from_numpy,
                                          vibevoice_params_from_numpy)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=1e-5):
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def pair():
    """(reference VibeVoiceTTS, the port's on the same parameters)."""
    jm = jvv.VibeVoiceTTS(jvv.tiny_tts_config(), dtype=jnp.float32, seed=11,
                          max_frames=8)
    tm = tvv.VibeVoiceTTS(tvv.tiny_tts_config(), params=_port(jm.params),
                          dtype=torch.float32, device="cpu", max_frames=8)
    return jm, tm


def _port(params):
    return vibevoice_params_from_numpy(_np(params), "cpu", torch.float32)


def test_config_parse_matches_reference():
    for raw in (REALTIME_0_5B, hf_config(tvv.tiny_tts_config())):
        ours, theirs = (tvv.vibevoice_config_from_hf(raw),
                        jvv.vibevoice_config_from_hf(raw))
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name.startswith("lm_"):
                for g in ("hidden_size", "intermediate_size",
                          "num_hidden_layers", "num_attention_heads",
                          "num_key_value_heads", "head_dim", "vocab_size",
                          "rms_norm_eps", "rope_theta", "qkv_bias",
                          "model_prefix"):
                    assert getattr(a, g) == getattr(b, g), (f.name, g)
            else:
                assert a == b, f.name
        assert ours.vae_channels == theirs.vae_channels
        assert ours.enc_channels == theirs.enc_channels
        assert ours.hop == theirs.hop
    cfg = tvv.vibevoice_config_from_hf(REALTIME_0_5B)
    assert (cfg.hidden, cfg.hop, cfg.lm_tts.num_hidden_layers,
            cfg.lm_base.num_attention_heads) == (896, 3200, 20, 14)


def test_head_connector_eos_match_reference(pair):
    jm, tm = pair
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, cfg.acoustic_dim)).astype(np.float32)
    cond = rng.standard_normal((2, cfg.hidden)).astype(np.float32)
    t = np.asarray([999.0, 500.0], np.float32)
    _close(tvv.head_forward(tm.cfg, tm.params["head"], torch.from_numpy(x),
                            torch.from_numpy(t), torch.from_numpy(cond)),
           jvv.head_forward(cfg, jm.params["head"], x, t, cond))
    lat = rng.standard_normal((1, 3, cfg.acoustic_dim)).astype(np.float32)
    _close(tvv.connector_forward(tm.cfg, tm.params["connector"],
                                 torch.from_numpy(lat)),
           jvv.connector_forward(cfg, jm.params["connector"], lat))
    _close(tvv.eos_probability(tm.params["eos"], torch.from_numpy(cond)),
           jvv.eos_probability(jm.params["eos"], cond))
    # the embedding alone: cos / sin of arguments up to 999 rad, where one
    # float32 ulp of the argument is 6e-5, so the two libraries' exp
    # (one ulp apart at most) move a value by up to that much
    np.testing.assert_allclose(
        _f32(tvv.vv_timestep_embedding(torch.from_numpy(t))),
        _f32(jvv.vv_timestep_embedding(jnp.asarray(t))), rtol=0, atol=1e-4)


@pytest.mark.parametrize("frames", [1, 5])
def test_vae_decoder_matches_reference(pair, frames):
    jm, tm = pair
    lat = np.random.default_rng(frames).standard_normal(
        (1, frames, jm.cfg.acoustic_dim)).astype(np.float32)
    want = jvv.vae_decode_frames(jm.cfg, jm.params["vae"], lat)
    got = tvv.vae_decode_frames(tm.cfg, tm.params["vae"],
                                torch.from_numpy(lat))
    assert got.shape == (1, frames * jm.cfg.hop)
    _close(got, want)


@pytest.mark.parametrize("n", [16 * 8, 16 * 5 + 13, 7, 200])
def test_vae_encoder_and_frame_count_match_reference(pair, n):
    jm, tm = pair
    audio = np.sin(np.linspace(0, 40, n)).astype(np.float32)[None]
    want = jvv.vae_encode_wav(jm.cfg, jm.params["vae_enc"], audio)
    got = tvv.vae_encode_wav(tm.cfg, tm.params["vae_enc"],
                             torch.from_numpy(audio))
    assert got.shape == want.shape
    _close(got, want)
    assert tvv.encoder_frames(tm.cfg, n) == jvv._encoder_frames(jm.cfg, n)
    fj, cj = jm.encode_voice_reference(audio[0])
    ft, ct = tm.encode_voice_reference(audio[0])
    _close(ft, fj)
    _close(ct, cj)


def test_inject_voice_kv_matches_reference(pair, tmp_path):
    jm, tm = pair
    path = str(tmp_path / "voice.safetensors")
    write_voice_prompt(path, tm.cfg, seq=5, seed=3)
    jvp, tvp = jvv.load_voice_prompt(path), tvv.load_voice_prompt(path)
    want = jvv.inject_voice_kv(jm._fresh("tts", 64), jvp["tts_lm"],
                               jnp.float32)
    cache = tm._fresh("tts", 64)
    assert tvv.inject_voice_kv(cache, tvp["tts_lm"], torch.float32) == 5
    assert cache["pos"] == int(want["pos"]) == 5
    for ours, theirs in zip(cache["layers"], want["layers"]):
        for k in ("k", "v", "pos"):
            assert np.array_equal(ours[k].numpy(), np.asarray(theirs[k]))
    with pytest.raises(ValueError, match="exceeds cache"):
        tvv.inject_voice_kv(tm._fresh("tts", 4), tvp["tts_lm"],
                            torch.float32)


def _draws(seed: int, n: int, dim: int) -> list:
    """The reference's per-frame noise: rng split once per frame."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        out.append(torch.from_numpy(np.asarray(
            jax.random.normal(k, (1, dim), jnp.float32)).copy()))
    return out


def _speak(jm, tm, monkeypatch, text, seed=0, **kw):
    """Both packages' generate_speech; returns (ref latents, ref samples,
    port latents, port samples)."""
    seen = {}
    real = jm._decode
    monkeypatch.setattr(jm, "_decode", lambda p, lat: (
        seen.__setitem__("ref", np.asarray(lat)), real(p, lat))[1])
    real_t = tm.decode_latents
    monkeypatch.setattr(tm, "decode_latents", lambda lat: (
        seen.__setitem__("port", lat.numpy().copy()), real_t(lat))[1])
    want = jm.generate_speech(text, seed=seed, **kw)
    got = tm.generate_speech(text, seed=seed, frame_noise=_draws(
        seed, 64, jm.cfg.acoustic_dim), **kw)
    return seen.get("ref"), want.samples, seen.get("port"), got.samples


def _same_speech(result, hop):
    ref_lat, ref_wav, lat, wav = result
    assert lat.shape == ref_lat.shape and len(wav) == len(ref_wav) == \
        lat.shape[1] * hop
    _close(lat, ref_lat, 1e-4)
    _close(wav, ref_wav, 1e-4)


@pytest.mark.parametrize("text,seed,kw", [
    ("hello there", 0, dict(max_frames=5)),
    ("a longer sentence so that several text windows interleave", 3,
     dict(max_frames=8, steps=3, cfg_scale=2.0)),
    ("x", 5, dict(max_frames=2))])
def test_generate_speech_matches_reference(pair, monkeypatch, text, seed,
                                           kw):
    jm, tm = pair
    _same_speech(_speak(jm, tm, monkeypatch, text, seed, **kw), jm.cfg.hop)


def test_rounding_growth_over_frames(pair, monkeypatch):
    """Past five frames the 1e-4 bar is not a property of this pair: the
    two libraries' float32 roundings (1e-6 relative in the head at t =
    999, from their exp / sin / cos) grow about 2.5x per frame through
    the loop (latent -> connector -> TTS LM -> condition -> diffusion) of
    the random tiny weights. Held here: the first frame within 1e-5, the
    eighth within 1e-2 of the largest latent, and the same frame count."""
    jm, tm = pair
    ref, _, got, _ = _speak(jm, tm, monkeypatch, "hello there", 0)
    assert got.shape == ref.shape == (1, 8, jm.cfg.acoustic_dim)
    scale = float(np.abs(ref).max())
    per_frame = np.abs(got - ref).max(axis=-1)[0] / scale
    assert per_frame[0] < 1e-5 and per_frame.max() < 1e-2


def test_teacher_forced_frames_do_not_grow(pair, monkeypatch):
    """The seam through which chip_smoke's 21(b) holds two devices frame
    by frame: the port teacher-forced with the reference's latents
    (frame_latents) sees the reference's inputs at every frame, so the
    eight frames that grow about 2.5x a frame when both run free (the
    test above) each stay within 1e-5 of the largest latent, with the
    same frame count; frame_log holds each frame's condition, latent and
    EOS probability."""
    jm, tm = pair
    ref, _, _, _ = _speak(jm, tm, monkeypatch, "hello there", 0)
    sf = float(tm.params["speech_scaling_factor"])
    bf = float(tm.params["speech_bias_factor"])
    teacher = [torch.from_numpy((ref[0, i:i + 1] + bf) * sf)
               for i in range(ref.shape[1])]
    log = []
    tm.generate_speech("hello there", seed=0, frame_noise=_draws(
        0, 64, jm.cfg.acoustic_dim), frame_latents=teacher, frame_log=log)
    got = np.stack([e["latent"].numpy()[0] / sf - bf for e in log])
    assert got.shape == ref[0].shape == (8, jm.cfg.acoustic_dim)
    per_frame = np.abs(got - ref[0]).max(axis=-1) / np.abs(ref).max()
    assert per_frame.max() < 1e-5
    assert all(e["cond"].shape == (1, jm.cfg.hidden) and 0 <= e["eos"] <= 1
               for e in log)


@pytest.mark.parametrize("text,kw", [
    ("hello there", dict(max_frames=6)),
    ("a longer sentence so that several text windows interleave",
     dict(max_frames=8, steps=3, cfg_scale=2.0))])
def test_teacher_forcing_with_its_own_latents_is_the_free_run(pair, text,
                                                               kw):
    _, tm = pair
    log, forced_log = [], []
    free = tm.generate_speech(text, seed=4, frame_log=log, **kw).samples
    forced = tm.generate_speech(
        text, seed=4, frame_log=forced_log,
        frame_latents=[e["latent"] for e in log], **kw).samples
    assert len(log) == len(forced_log) == kw["max_frames"]
    assert np.array_equal(free, forced)
    for a, b in zip(log, forced_log):
        assert a["eos"] == b["eos"]
        assert torch.equal(a["cond"], b["cond"])
        assert torch.equal(a["latent"], b["latent"])


def test_generate_speech_with_voice_prompt(pair, monkeypatch, tmp_path):
    jm, tm = pair
    path = str(tmp_path / "voice.safetensors")
    write_voice_prompt(path, tm.cfg, seq=6, seed=9)
    result = _speak(jm, tm, monkeypatch, "hello voice", 2, voice=path,
                    max_frames=4)
    _same_speech(result, jm.cfg.hop)
    plain = _speak(jm, tm, monkeypatch, "hello voice", 2, max_frames=4)
    assert not np.allclose(result[3], plain[3])


@pytest.mark.parametrize("rate", [24000, 16000, 48000])
def test_generate_speech_cloning_a_wav(pair, monkeypatch, rate):
    jm, tm = pair
    n = jm.cfg.hop * 8 * rate // 24000 + 5
    wav = encode_wav(np.sin(np.linspace(0, 60, n)).astype(np.float32), rate)
    _same_speech(_speak(jm, tm, monkeypatch, "clone me", 1, voice_wav=wav,
                        max_frames=3), jm.cfg.hop)


def test_eos_stops_after_three_frames(monkeypatch):
    jm = jvv.VibeVoiceTTS(jvv.tiny_tts_config(), dtype=jnp.float32, seed=4,
                          max_frames=8)
    jm.params["eos"]["fc2"]["bias"] = jnp.full((1,), 10.0)
    tm = tvv.VibeVoiceTTS(tvv.tiny_tts_config(), params=_port(jm.params),
                          dtype=torch.float32, device="cpu", max_frames=8)
    result = _speak(jm, tm, monkeypatch, "stop early please", 0)
    _same_speech(result, jm.cfg.hop)
    assert result[2].shape[1] == 3


def test_no_text_and_hash_tokens(pair):
    jm, tm = pair
    for text in ("", "hello", "x" * 200):
        assert tm._encode_text(text) == jm._encode_text(text)
    out = tm.generate_speech("", max_frames=2)
    assert out.sample_rate == 24000 and out.samples.shape[0] > 0


def test_bf16_model_decodes_in_the_vae_dtype():
    """The reference feeds model-dtype latents into its float32 VAE; the
    port casts them (and the cloning waveform) to the VAE's dtype."""
    tm = tvv.VibeVoiceTTS(tvv.tiny_tts_config(), dtype=torch.bfloat16,
                          device="cpu", max_frames=4)
    assert tm.params["vae"]["head"]["weight"].dtype == torch.float32
    wav = encode_wav(np.sin(np.linspace(0, 60, 16 * 8)).astype(np.float32))
    out = tm.generate_speech("hi", voice_wav=wav, max_frames=3)
    assert len(out.samples) == 3 * 16 and np.isfinite(out.samples).all()
    assert tm.stats["frames"] == 3


def test_tree_conversion_keeps_dtypes(pair):
    jm, _ = pair
    ported = vibevoice_params_from_numpy(_np(jm.params), "cpu",
                                         torch.bfloat16)
    assert ported["head"]["t_mlp1"]["weight"].dtype == torch.bfloat16
    assert ported["vae"]["head"]["weight"].dtype == torch.float32
    assert ported["speech_scaling_factor"].dtype == torch.float32
    assert "rope" not in ported["base"]
    with pytest.raises(ValueError):
        vibevoice_params_from_numpy({"bogus": {}}, "cpu")
    assert tree_from_numpy({"a": np.ones(2)}, "cpu")["a"].dtype == \
        torch.bfloat16
