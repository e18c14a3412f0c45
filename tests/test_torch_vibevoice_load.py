"""VibeVoice checkpoint directories (module 14d's loader) read by both
packages: the port's writer (bench/synth_vibevoice.py) puts a seeded tiny
VibeVoice on disk with the release config.json structure and the
published tensor names; the JAX loader and the port's read it to the same
tensors bit for bit and the same config, and the port's tokenizer (utils/
bpe.py) gives the ids `tokenizers.Tokenizer.encode(text)` gives the
reference. Also runtime.build_audio_model (demo:vibevoice, a directory;
demo:luxtts and a LuxTTS directory refused naming ROADMAP 14d's
remainder), `cli tts`, and the reference's bf16 fault (ROADMAP §3): its
build_audio_model(DIR, "bf16") feeds bf16 latents into its float32 VAE
and raises TypeError, where the port generates."""
import dataclasses
import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.audio import load_vibevoice as jax_load
from cake_tpu.runtime import build_audio_model as jax_build_audio
from cake_tpu_torch import cli
from cake_tpu_torch.bench.synth_vibevoice import (write_vibevoice_checkpoint,
                                                  write_voice_prompt)
from cake_tpu_torch.models.audio import (VibeVoiceTTS,
                                         detect_vibevoice_checkpoint,
                                         load_vibevoice, tiny_tts_config)
from cake_tpu_torch.runtime import build_audio_model
from cake_tpu_torch.utils.mapping import flatten_tree
from cake_tpu_torch.utils.safetensors_io import index_file
from cake_tpu_torch.utils.wav import decode_wav

torch.set_num_threads(1)

EXPECTED_NAMES = [
    "model.language_model.embed_tokens.weight",
    "model.language_model.layers.0.self_attn.q_proj.bias",
    "model.tts_language_model.layers.1.mlp.gate_proj.weight",
    "model.tts_language_model.norm.weight",
    "model.tts_input_types.weight",
    "model.prediction_head.t_embedder.mlp.0.weight",
    "model.prediction_head.noisy_images_proj.weight",
    "model.prediction_head.layers.0.adaLN_modulation.1.weight",
    "model.prediction_head.layers.1.ffn.gate_proj.weight",
    "model.prediction_head.final_layer.adaLN_modulation.1.weight",
    "model.prediction_head.final_layer.linear.weight",
    "model.acoustic_connector.fc1.weight",
    "model.acoustic_connector.norm.weight",
    "tts_eos_classifier.fc1.weight",
    "model.acoustic_tokenizer.decoder.upsample_layers.0.0.conv.conv.weight",
    "model.acoustic_tokenizer.decoder.upsample_layers.1.0.convtr.convtr"
    ".weight",
    "model.acoustic_tokenizer.decoder.stages.0.0.mixer.conv.conv.conv"
    ".weight",
    "model.acoustic_tokenizer.decoder.stages.2.0.ffn.linear1.weight",
    "model.acoustic_tokenizer.decoder.head.conv.conv.weight",
    "model.acoustic_tokenizer.encoder.downsample_layers.0.0.conv.conv"
    ".weight",
    "model.acoustic_tokenizer.encoder.downsample_layers.1.0.conv.conv"
    ".weight",
    "model.acoustic_tokenizer.encoder.stages.0.0.mixer.conv.conv.conv"
    ".weight",
    "model.acoustic_tokenizer.encoder.head.conv.conv.weight",
    "model.speech_scaling_factor",
]


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


def _config(vocab: int = 1024):
    cfg = tiny_tts_config()
    return dataclasses.replace(
        cfg, lm_base=dataclasses.replace(cfg.lm_base, vocab_size=vocab),
        lm_tts=dataclasses.replace(cfg.lm_tts, vocab_size=vocab))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(directory, the seeded model written there) with a byte-level BPE
    tokenizer and non-trivial scaling scalars."""
    d = str(tmp_path_factory.mktemp("vibevoice") / "vv-tiny")
    tts = VibeVoiceTTS(_config(), dtype=torch.float32, seed=5, device="cpu")
    tts.params["speech_scaling_factor"] = torch.tensor(1.5)
    tts.params["speech_bias_factor"] = torch.tensor(0.1)
    write_vibevoice_checkpoint(d, tts)
    return d, tts


def test_names_and_detection(written, tmp_path):
    d, _ = written
    names = set(index_file(os.path.join(d, "model.safetensors")))
    assert not [n for n in EXPECTED_NAMES if n not in names]
    assert detect_vibevoice_checkpoint(d)
    assert not detect_vibevoice_checkpoint(str(tmp_path))


def _tree(params) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in flatten_tree(
        jax.tree.map(np.asarray, params)).items() if ".rope." not in k}


def test_both_loaders_read_the_same_tensors(written):
    d, seeded = written
    port = load_vibevoice(d, torch.float32, device="cpu")
    ref = jax_load(d, dtype=jnp.float32)
    ours = {k: v.numpy() for k, v in flatten_tree(port.params).items()}
    theirs = _tree(ref.params)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert np.array_equal(ours[k], theirs[k]), k
    # the seeded stacks also hold an untied lm_head, which the release
    # layout has no name for and nothing reads
    want = {k: v.numpy() for k, v in flatten_tree(seeded.params).items()}
    assert {k.split(".")[1] for k in set(want) - set(ours)} == {"lm_head"}
    assert all(np.array_equal(ours[k], want[k]) for k in ours)
    for f in dataclasses.fields(port.cfg):
        if not f.name.startswith("lm_"):
            assert getattr(port.cfg, f.name) == getattr(ref.cfg, f.name)
    assert port.cfg.lm_tts.model_prefix == ref.cfg.lm_tts.model_prefix
    assert float(port.params["speech_scaling_factor"]) == 1.5


@pytest.mark.parametrize("text", ["hello world", "",
                                  "Grüße, 世界! 42 times — okay?",
                                  "<|im_start|>user\nhi<|im_end|>"])
def test_token_ids_equal_the_reference(written, text):
    d, _ = written
    port = load_vibevoice(d, torch.float32, device="cpu")
    ref = jax_load(d, dtype=jnp.float32)
    assert port._encode_text(text) == ref._encode_text(text)


def test_loaded_model_speaks_as_the_seeded_one(written, tmp_path):
    d, seeded = written
    port = load_vibevoice(d, torch.float32, device="cpu", max_frames=4)
    voice = str(tmp_path / "voice.safetensors")
    write_voice_prompt(voice, port.cfg, seq=3, seed=2)
    for kw in ({}, {"voice": voice}):
        a = port.generate_speech("hi there", seed=1, **kw)
        seeded.tokenizer = port.tokenizer
        b = seeded.generate_speech("hi there", seed=1, max_frames=4, **kw)
        assert np.array_equal(a.samples, b.samples)


def test_reference_bf16_fails_where_the_port_generates(written):
    """Fault of the reference (ROADMAP §3): a bf16 VibeVoice directory."""
    d, _ = written
    ref = jax_build_audio(d, "bf16")
    with pytest.raises(TypeError):
        ref.generate_speech("hello", max_frames=2, steps=2)
    port = build_audio_model(d, "bf16", device="cpu")
    assert port.params["vae"]["head"]["weight"].dtype == torch.float32
    assert port.params["head"]["t_mlp1"]["weight"].dtype == torch.bfloat16
    out = port.generate_speech("hello", max_frames=2, steps=2)
    assert len(out.samples) == 2 * port.cfg.hop
    assert np.isfinite(out.samples).all()


def test_runtime_builds_and_refuses(written, tmp_path):
    d, _ = written
    demo = build_audio_model("demo:vibevoice", "f32", device="cpu")
    assert isinstance(demo, VibeVoiceTTS) and demo.tokenizer is None
    assert isinstance(build_audio_model(d, "f32", device="cpu"),
                      VibeVoiceTTS)
    with pytest.raises(NotImplementedError, match="14d's remainder"):
        build_audio_model("demo:luxtts", device="cpu")
    lux = tmp_path / "lux"
    lux.mkdir()
    (lux / "config.json").write_text(json.dumps(
        {"model": {"fm_decoder_dim": 64, "fm_decoder_num_layers": 2}}))
    with pytest.raises(NotImplementedError, match="LuxTTS"):
        build_audio_model(str(lux), device="cpu")
    other = tmp_path / "other"
    other.mkdir()
    (other / "config.json").write_text("{}")
    with pytest.raises(ValueError, match="not a demo: alias"):
        build_audio_model(str(other), device="cpu")


@pytest.mark.parametrize("model", ["demo:vibevoice", "dir"])
def test_cli_tts_writes_a_wav(written, tmp_path, model):
    d, _ = written
    out = tmp_path / "speech.wav"
    argv = ["tts", d if model == "dir" else model, "hello there", "--out",
            str(out), "--frames", "3", "--steps", "2", "--cfg-scale", "1.5",
            "--seed", "4", "--dtype", "f32", "--cpu"]
    assert cli.main(argv) == 0
    samples, rate = decode_wav(out.read_bytes())
    assert rate == 24000 and len(samples) == 3 * 16
