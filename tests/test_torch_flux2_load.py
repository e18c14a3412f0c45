"""FLUX.2-klein directories (module 14c's loader) read by both packages:
the port's writer (bench/synth_flux2.py) puts a seeded tiny FLUX.2 with a
Qwen3 encoder on disk in the diffusers layout with the published names;
the JAX loader and the port's read it to the same tensors bit for bit,
the same configs, the same BatchNorm statistics and the same token ids
(the reference reads the tokenizer with `tokenizers`, the port with
utils/bpe.py, both without added special tokens), and the loaded model
equals the seeded one it was written from. Also detection,
runtime.build_image_model (demo:flux2, a FLUX.2 directory; --fp8-native
refused) and `cli image demo:flux2`."""
import dataclasses
import gc
import json
import os

import jax
import numpy as np
import pytest
import torch

from cake_tpu.models.image import load_flux2_image_model as jax_load
from cake_tpu.models.image.flux2_loader import \
    detect_flux2_checkpoint as jax_detect
from cake_tpu.models.image.flux2_loader import \
    infer_flux2_configs as jax_infer
from cake_tpu_torch import cli
from cake_tpu_torch.bench.synth_flux2 import (QWEN_SPECIAL_NAMES,
                                              qwen_tokenizer,
                                              write_flux2_checkpoint)
from cake_tpu_torch.models.image import (Flux2ImageModel,
                                         detect_flux2_checkpoint,
                                         infer_flux2_configs,
                                         load_flux2_image_model,
                                         seeded_flux2, tiny_flux2_config)
from cake_tpu_torch.runtime import build_image_model
from cake_tpu_torch.utils.mapping import flatten_tree
from cake_tpu_torch.utils.safetensors_io import index_file

torch.set_num_threads(1)

ENCODER = dict(architectures=["Qwen3ForCausalLM"], vocab_size=1024,
               hidden_size=32, intermediate_size=64, num_hidden_layers=6,
               num_attention_heads=4, num_key_value_heads=2, head_dim=8,
               rms_norm_eps=1e-6, rope_theta=10000.0,
               max_position_embeddings=128, tie_word_embeddings=True,
               eos_token_id=2)

EXPECTED_NAMES = [
    "x_embedder.weight",
    "time_guidance_embed.timestep_embedder.linear_1.weight",
    "double_stream_modulation_img.linear.weight",
    "single_stream_modulation.linear.weight",
    "transformer_blocks.0.attn.to_q.weight",
    "transformer_blocks.0.attn.add_k_proj.weight",
    "transformer_blocks.0.attn.norm_added_q.weight",
    "transformer_blocks.1.ff_context.linear_in.weight",
    "single_transformer_blocks.0.attn.to_qkv_mlp_proj.weight",
    "single_transformer_blocks.1.attn.to_out.weight",
    "norm_out.linear.weight",
    "proj_out.weight",
]
EXPECTED_VAE_NAMES = [
    "post_quant_conv.weight",
    "decoder.conv_in.weight",
    "decoder.mid_block.resnets.0.norm1.weight",
    "decoder.mid_block.attentions.0.to_q.weight",
    "decoder.mid_block.attentions.0.group_norm.weight",
    "decoder.up_blocks.0.resnets.0.conv1.weight",
    "decoder.up_blocks.0.upsamplers.0.conv.weight",
    "decoder.up_blocks.1.resnets.0.conv_shortcut.weight",
    "decoder.conv_norm_out.weight",
    "decoder.conv_out.weight",
    "bn.running_mean",
]


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


def _cfgs(captures=(1, 2, 4)):
    pipe = tiny_flux2_config()
    return {"flux2": pipe.transformer, "vae": pipe.vae, "encoder": ENCODER,
            "output_layers": captures}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(directory, the seeded model written there, its BatchNorm stats)."""
    d = str(tmp_path_factory.mktemp("flux2") / "klein-tiny")
    model = seeded_flux2(_cfgs(), torch.float32, "cpu", seed=7,
                         max_txt_len=24)
    rng = np.random.default_rng(3)
    ic = model.cfg.transformer.in_channels
    bn = (rng.standard_normal(ic).astype(np.float32) * 0.2,
          rng.uniform(0.5, 1.5, ic).astype(np.float32))
    write_flux2_checkpoint(d, model, bn)
    return d, model, bn


def test_published_names_and_detection(written, tmp_path):
    d, _, _ = written
    tnames = set(index_file(os.path.join(
        d, "transformer", "diffusion_pytorch_model.safetensors")))
    vnames = set(index_file(os.path.join(
        d, "vae", "diffusion_pytorch_model.safetensors")))
    assert not [n for n in EXPECTED_NAMES if n not in tnames]
    assert not [n for n in EXPECTED_VAE_NAMES if n not in vnames]
    with open(os.path.join(d, "model_index.json")) as f:
        assert json.load(f)["_class_name"] == "Flux2Pipeline"
    ours, theirs = detect_flux2_checkpoint(d), jax_detect(d)
    assert ours is not None and theirs is not None
    assert (ours.tokenizer_path, ours.text_encoder_dir) == \
        (theirs.tokenizer_path, theirs.text_encoder_dir)
    assert detect_flux2_checkpoint(str(tmp_path)) is None
    assert jax_detect(str(tmp_path)) is None


def test_configs_equal_the_reference(written):
    d, model, _ = written
    ours = infer_flux2_configs(detect_flux2_checkpoint(d))
    theirs = jax_infer(jax_detect(d))
    for key in ("flux2", "vae"):
        assert dataclasses.asdict(ours[key]) == \
            dataclasses.asdict(theirs[key])
    assert ours["encoder_over"] == theirs["encoder_over"] == \
        {"output_layers": [1, 2, 4]}
    assert ours["flux2"] == model.cfg.transformer
    assert ours["vae"] == model.cfg.vae


def _leaves(tree):
    return {k: np.asarray(v, np.float32) for k, v in
            flatten_tree(jax.tree.map(np.asarray, tree)).items()}


def test_both_loaders_read_the_same_tensors(written):
    d, model, bn = written
    port = load_flux2_image_model(d, torch.float32, max_txt_len=24,
                                  device="cpu")
    ref = jax_load(d, dtype=np.float32, max_txt_len=24)
    for part in ("transformer", "vae"):
        ours = {k: v.numpy() for k, v in
                flatten_tree(port.params[part]).items()}
        theirs = _leaves(ref.params[part])
        assert ours.keys() == theirs.keys(), part
        for k in ours:
            assert np.array_equal(ours[k], theirs[k]), (part, k)
    enc_ours = {k: v.numpy() for k, v in
                flatten_tree(port.text_encoder.params).items()}
    enc_theirs = {k: v for k, v in
                  _leaves(ref.text_encoder.params).items()
                  if not k.startswith("rope")}
    assert enc_ours.keys() == enc_theirs.keys()
    assert all(np.array_equal(enc_ours[k], enc_theirs[k]) for k in enc_ours)
    assert len(port.text_encoder.params["layers"]) == 5
    assert np.array_equal(port.bn_mean.numpy(), bn[0])
    assert np.array_equal(port.bn_std.numpy(), np.asarray(ref.bn_std))
    assert np.array_equal(np.asarray(ref.bn_mean), bn[0])
    assert port.text_encoder.output_layers == \
        ref.text_encoder.output_layers == (1, 2, 4)
    assert port.text_encoder.pad_id == ref.text_encoder.pad_id == \
        1024 - len(QWEN_SPECIAL_NAMES)


@pytest.mark.parametrize("prompt", ["a watercolor fox", "",
                                    "Ein Fuchs im Schnee, 4K — 雪の狐 🚀",
                                    "<|im_end|> inside the prompt " * 4])
def test_token_ids_equal_the_reference(written, prompt):
    d, _, _ = written
    port = load_flux2_image_model(d, torch.float32, max_txt_len=24,
                                  device="cpu")
    ref = jax_load(d, dtype=np.float32, max_txt_len=24)
    ours = port.text_encoder.token_ids(prompt)
    theirs = ref.text_encoder.token_ids(prompt)
    assert np.array_equal(ours[0], theirs[0]) and ours[1] == theirs[1]


def test_loaded_model_equals_the_seeded_one(written):
    d, model, bn = written
    loaded = load_flux2_image_model(d, torch.float32, max_txt_len=24,
                                    device="cpu")
    seeded = Flux2ImageModel(model.cfg, params=model.params,
                             text_encoder=model.text_encoder, bn_stats=bn,
                             dtype=torch.float32, device="cpu")
    want = seeded.generate_image("a fox", 32, 32, steps=2, seed=5)
    got = loaded.generate_image("a fox", 32, 32, steps=2, seed=5)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert torch.equal(loaded.text_encoder("a fox"),
                       model.text_encoder("a fox"))


def test_qwen_tokenizer_places_the_specials():
    spec = qwen_tokenizer()
    ids = {t["content"]: t["id"] for t in spec["added_tokens"]}
    assert ids["<|endoftext|>"] == 151643 and ids["<|im_start|>"] == 151644
    assert ids["</think>"] == 151643 + len(QWEN_SPECIAL_NAMES) - 1
    small = {t["content"]: t["id"] for t in
             qwen_tokenizer(1024)["added_tokens"]}
    assert max(small.values()) == 1023


def test_runtime_builds_flux2(written, tmp_path):
    d, _, _ = written
    demo = build_image_model("demo:flux2", "f32", device="cpu")
    assert isinstance(demo, Flux2ImageModel)
    assert demo.generate_image("x", 16, 16, steps=1).size == (16, 16)
    loaded = build_image_model(d, "f32", device="cpu")
    assert isinstance(loaded, Flux2ImageModel)
    assert loaded.cfg.max_txt_len == 512
    with pytest.raises(ValueError, match="fp8-native"):
        build_image_model(d, "f32", fp8_native=True, device="cpu")
    with pytest.raises(ValueError, match="fp8-native"):
        build_image_model("demo:flux2", "f32", fp8_native=True, device="cpu")


def test_cli_image_flux2_writes_a_png(tmp_path):
    from PIL import Image
    out = tmp_path / "fox.png"
    assert cli.main(["image", "demo:flux2", "a watercolor fox", "--out",
                     str(out), "--width", "40", "--height", "24", "--steps",
                     "2", "--seed", "3", "--dtype", "f32", "--cpu"]) == 0
    assert Image.open(out).size == (40, 24)
    with pytest.raises(SystemExit, match="SD model"):
        cli.main(["image", "demo:flux2", "x", "--out", str(out),
                  "--init-image", str(out), "--cpu", "--dtype", "f32"])
