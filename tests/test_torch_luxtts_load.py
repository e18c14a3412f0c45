"""LuxTTS checkpoint directories (module 14d's loader) read by both
packages: the port's writer (bench/synth_luxtts.py) puts a seeded LuxTTS
on disk with the release layout (config.json {"model", "feature"},
model.safetensors, vocos.safetensors, tokens.txt) and the published
tensor names, every name the reference's mapping reads and its test
expects; the JAX loader and the port's read it to the same tensors bit
for bit in float32, and both speak the same waveform from the same noise
within 1e-4. Also the two faults of the reference the port does not
copy (ROADMAP §3): its Vocos seeding runs out of keys past two layers,
so it cannot load (or seed) the published 8-layer Vocos, which the port
loads and speaks; and its bf16 model feeds a bf16 mel into the float32
Vocos of a loaded directory and raises, where the port generates.
runtime.build_audio_model gives the port's LuxTTS for demo:luxtts and a
directory, and `cli tts DIR` writes the in-memory model's WAV."""
import dataclasses
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.audio import load_luxtts as jax_load
from cake_tpu.models.audio import luxtts as jlx
from cake_tpu.models.audio.luxtts_loader import (luxtts_mapping as
                                                 jax_mapping,
                                                 vocos_mapping as
                                                 jax_vocos_mapping)
from cake_tpu.runtime import build_audio_model as jax_build_audio
from cake_tpu.utils.mapping import flatten_tree as jax_flatten
from cake_tpu_torch import cli
from cake_tpu_torch.bench.synth_luxtts import SYMBOLS, write_luxtts_checkpoint
from cake_tpu_torch.models.audio import (LuxTTS, detect_luxtts_checkpoint,
                                         load_luxtts, tiny_luxtts_config)
from cake_tpu_torch.runtime import build_audio_model
from cake_tpu_torch.utils.mapping import flatten_tree
from cake_tpu_torch.utils.safetensors_io import index_file
from cake_tpu_torch.utils.wav import decode_wav
from test_luxtts_load import EXPECTED_NAMES, EXPECTED_VOCOS

torch.set_num_threads(1)
TEXT = "hello world, again"


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


def _seeded(seed: int, **over) -> LuxTTS:
    """A tiny LuxTTS whose every leaf is off its initial constant."""
    cfg = dataclasses.replace(tiny_luxtts_config(), **over)
    m = LuxTTS(cfg, dtype=torch.float32, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for path, leaf in flatten_tree(m.params).items():
        if not path.endswith("istft_window"):
            leaf += 0.05 * torch.randn(leaf.shape, generator=gen)
    return m


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("luxtts") / "lux-tiny")
    m = _seeded(5)
    write_luxtts_checkpoint(d, m)
    return d, m


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """A directory whose Vocos has the published 8 layers."""
    d = str(tmp_path_factory.mktemp("luxtts8") / "lux-vocos8")
    m = _seeded(6, vocos_layers=8)
    write_luxtts_checkpoint(d, m)
    return d, m


def _noise(cfg, tokens: int, seed: int = 0) -> np.ndarray:
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (1, tokens, cfg.feat_dim)))


def test_names_and_detection(written, tmp_path):
    d, m = written
    names = set(index_file(os.path.join(d, "model.safetensors")))
    vnames = set(index_file(os.path.join(d, "vocos.safetensors")))
    assert not [n for n in EXPECTED_NAMES if n not in names]
    assert not [n for n in EXPECTED_VOCOS if n not in vnames]
    jcfg = jlx.tiny_luxtts_config()
    assert names == set(jax_mapping(jcfg).values())
    assert vnames == set(jax_vocos_mapping(jcfg).values())
    assert detect_luxtts_checkpoint(d)
    assert not detect_luxtts_checkpoint(str(tmp_path))
    with open(os.path.join(d, "tokens.txt"), encoding="utf-8") as f:
        assert f.read().splitlines()[1] == "  1"
    assert m.cfg.vocab_size >= len(SYMBOLS)


def test_both_loaders_read_the_same_tensors(written):
    d, seeded = written
    port = load_luxtts(d, torch.float32, device="cpu")
    ref = jax_load(d, dtype=jnp.float32)
    ours = {k: v.numpy() for k, v in flatten_tree(port.params).items()}
    theirs = {k: np.asarray(v) for k, v in jax_flatten(ref.params).items()}
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert np.array_equal(ours[k], theirs[k]), k
    want = flatten_tree(seeded.params)
    assert ours.keys() == want.keys()
    assert all(np.array_equal(ours[k], want[k].numpy()) for k in ours)
    assert port.cfg == dataclasses.replace(
        seeded.cfg, feat_scale=port.cfg.feat_scale)
    for f in dataclasses.fields(port.cfg):
        assert getattr(port.cfg, f.name) == getattr(ref.cfg, f.name), f.name
    assert port.params["fm_decoder"]["downsample"][0] is None
    assert port.phonemizer.sym2id == ref.phonemizer.sym2id
    assert port.phonemizer.tokenize(TEXT) == ref.phonemizer.tokenize(TEXT)


def test_loaded_models_speak_alike(written):
    d, seeded = written
    port = load_luxtts(d, torch.float32, device="cpu")
    ref = jax_load(d, dtype=jnp.float32)
    noise = _noise(port.cfg, len(port.phonemizer.tokenize(TEXT)), 3)
    want = ref.generate_speech(TEXT, steps=3, seed=3).samples
    got = port.generate_speech(TEXT, steps=3,
                               noise=torch.from_numpy(noise)).samples
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    seeded.phonemizer = port.phonemizer
    again = seeded.generate_speech(TEXT, steps=3,
                                   noise=torch.from_numpy(noise)).samples
    assert np.array_equal(got, again)


def test_eight_layer_vocos_directory_loads(eight):
    d, seeded = eight
    port = load_luxtts(d, torch.float32, device="cpu")
    assert port.cfg.vocos_layers == 8
    assert len(port.params["vocos"]["convnext"]) == 8
    got = flatten_tree(port.params)
    want = flatten_tree(seeded.params)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    seeded.phonemizer = port.phonemizer
    a = port.generate_speech(TEXT, steps=2, seed=1).samples
    b = seeded.generate_speech(TEXT, steps=2, seed=1).samples
    assert np.array_equal(a, b) and np.isfinite(a).all()


def test_reference_vocos_seeding_stops_past_two_layers(eight):
    """Fault F1 of the reference (ROADMAP §3): init_vocos_params splits
    4 + 2L keys and draws 3L + 2, so any Vocos past 2 layers raises
    StopIteration, when seeded and when a directory is loaded (its load
    shapes its tree through the same initializer)."""
    d, _ = eight
    cfg = jlx.tiny_luxtts_config()
    jlx.init_vocos_params(cfg, jax.random.PRNGKey(0))          # 2 layers
    for layers in (3, 8):
        with pytest.raises(StopIteration):
            jlx.init_vocos_params(dataclasses.replace(
                cfg, vocos_layers=layers), jax.random.PRNGKey(0))
    with pytest.raises(StopIteration):
        jax_load(d, dtype=jnp.float32)
    port = build_audio_model(d, "f32", device="cpu")
    assert isinstance(port, LuxTTS) and port.cfg.vocos_layers == 8
    out = port.generate_speech(TEXT, steps=2)
    assert np.isfinite(out.samples).all() and np.abs(out.samples).max() > 0
    seeded = LuxTTS(dataclasses.replace(tiny_luxtts_config(),
                                        vocos_layers=8), seed=2,
                    device="cpu")
    assert len(seeded.params["vocos"]["convnext"]) == 8


def test_reference_bf16_fails_where_the_port_generates(written):
    """Fault F2 of the reference (ROADMAP §3): a bf16 model loaded from a
    directory keeps its Vocos in float32 and casts the mel to bf16, and
    its convolution refuses the mixed dtypes; the port casts the mel to
    the Vocos' dtype."""
    d, _ = written
    ref = jax_build_audio(d, "bf16")
    with pytest.raises(TypeError, match="same dtypes"):
        ref.generate_speech(TEXT, steps=2)
    port = build_audio_model(d, "bf16", device="cpu")
    assert port.params["vocos"]["embed"]["weight"].dtype == torch.float32
    assert port.params["embed"]["weight"].dtype == torch.bfloat16
    assert port.params["fm_decoder"]["layers"][0]["norm"]["bias"].dtype == \
        torch.bfloat16
    out = port.generate_speech(TEXT, steps=2)
    frames = len(port.phonemizer.tokenize(TEXT))
    assert len(out.samples) == 2 * frames * port.cfg.hop_length
    assert np.isfinite(out.samples).all() and np.abs(out.samples).max() > 0


def test_runtime_builds_luxtts(written):
    d, _ = written
    demo = build_audio_model("demo:luxtts", "f32", device="cpu", seed=4)
    assert isinstance(demo, LuxTTS) and demo.cfg == tiny_luxtts_config()
    assert demo.params["vocos"]["head_out"]["weight"].dtype == torch.float32
    again = build_audio_model("demo:luxtts", "f32", device="cpu", seed=4)
    assert all(torch.equal(a, b) for a, b in zip(
        flatten_tree(demo.params).values(),
        flatten_tree(again.params).values()))
    loaded = build_audio_model(d, "f32", device="cpu")
    assert isinstance(loaded, LuxTTS) and loaded.phonemizer.sym2id


def test_cli_tts_writes_the_models_wav(written, tmp_path):
    d, _ = written
    out = tmp_path / "speech.wav"
    argv = ["tts", d, TEXT, "--out", str(out), "--steps", "2", "--seed",
            "4", "--dtype", "f32", "--cpu"]
    assert cli.main(argv) == 0
    data = out.read_bytes()
    samples, rate = decode_wav(data)
    port = load_luxtts(d, torch.float32, device="cpu")
    frames = len(port.phonemizer.tokenize(TEXT))
    assert rate == 48000 and len(samples) == 2 * frames * 16
    assert data == port.generate_speech(TEXT, steps=2, seed=4).wav_bytes()
    short = tmp_path / "short.wav"
    assert cli.main(["tts", "demo:luxtts", "hello there", "--out", str(short),
                     "--frames", "3", "--steps", "1", "--dtype", "f32",
                     "--cpu"]) == 0
    assert len(decode_wav(short.read_bytes())[0]) == 2 * 3 * 16
