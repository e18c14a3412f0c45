"""FLUX.1 checkpoints (module 14a's loader) read by both packages: the
port's writer (bench/synth_flux.py) puts the JAX package's seeded tiny
FLUX.1 (tests/test_flux_load.py's components) on disk with BFL's names,
as a ComfyUI bundle and in BFL's split layout, plain, FP8 cast and
scaled FP8; both loaders read it to the same tensors (native FP8 pairs
byte for byte), the same configs and the same text embeddings; native
FP8 generates what dequantized at load generates; a missing tensor, a
shape mismatch and missing encoders fail with the reference's errors.
Also runtime.build_image_model's demo answers (demo:sd and an SD
directory build SD, module 14b; demo:flux2 and a FLUX.2 directory build
FLUX.2, module 14c) and `cli image`."""
import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.image import load_flux_image_model as jax_load
from cake_tpu.models.image.flux import tiny_flux_config as jax_tiny_flux
from cake_tpu.models.image.flux_loader import \
    detect_flux_checkpoint as jax_detect
from cake_tpu.models.image.flux_loader import \
    infer_flux_configs as jax_infer
from cake_tpu.models.image.mmdit import init_mmdit_params as jax_mmdit
from cake_tpu.models.image.vae import init_vae_decoder_params as jax_vae
from cake_tpu.models.text_encoders import (init_clip_params, init_t5_params,
                                           tiny_clip_config, tiny_t5_config)
from cake_tpu_torch import cli
from cake_tpu_torch.bench.synth_flux import write_flux_checkpoint
from cake_tpu_torch.models.image import (detect_flux_checkpoint,
                                         infer_flux_configs,
                                         load_flux_image_model,
                                         mmdit_mapping, vae_decoder_mapping)
from cake_tpu_torch.models.image.flux import tiny_flux_config
from cake_tpu_torch.runtime import build_image_model
from cake_tpu_torch.utils.mapping import flatten_tree
from cake_tpu_torch.utils.safetensors_io import (index_file,
                                                 save_safetensors)
from cake_tpu_torch.utils.weights import tree_from_numpy

torch.set_num_threads(1)

# one name per pattern family, written out (test_flux_load.py's list)
EXPECTED_NAMES = [
    "model.diffusion_model.img_in.weight",
    "model.diffusion_model.time_in.in_layer.bias",
    "model.diffusion_model.vector_in.out_layer.weight",
    "model.diffusion_model.guidance_in.in_layer.weight",
    "model.diffusion_model.double_blocks.0.img_mod.lin.weight",
    "model.diffusion_model.double_blocks.1.txt_attn.qkv.bias",
    "model.diffusion_model.double_blocks.0.img_attn.norm.query_norm.scale",
    "model.diffusion_model.double_blocks.0.txt_mlp.2.weight",
    "model.diffusion_model.single_blocks.1.modulation.lin.bias",
    "model.diffusion_model.single_blocks.0.linear1.weight",
    "model.diffusion_model.single_blocks.0.norm.key_norm.scale",
    "model.diffusion_model.final_layer.adaLN_modulation.1.weight",
    "model.diffusion_model.final_layer.linear.bias",
    "vae.decoder.conv_in.weight",
    "vae.decoder.mid.block_1.norm1.weight",
    "vae.decoder.mid.attn_1.proj_out.bias",
    "vae.decoder.up.1.block.0.conv1.weight",
    "vae.decoder.up.1.upsample.conv.weight",
    "vae.decoder.norm_out.weight",
    "text_encoders.clip_l.transformer.text_model.embeddings."
    "token_embedding.weight",
    "text_encoders.clip_l.transformer.text_model.encoder.layers.0."
    "self_attn.q_proj.weight",
    "text_encoders.clip_l.transformer.text_model.encoder.layers.1."
    "mlp.fc1.bias",
    "text_encoders.clip_l.transformer.text_model.final_layer_norm.weight",
    "text_encoders.t5xxl.transformer.shared.weight",
    "text_encoders.t5xxl.transformer.encoder.block.0.layer.0."
    "SelfAttention.relative_attention_bias.weight",
    "text_encoders.t5xxl.transformer.encoder.block.1.layer.1."
    "DenseReluDense.wi_0.weight",
    "text_encoders.t5xxl.transformer.encoder.final_layer_norm.weight",
]
PROMPT = "a tiny test w1 w2 w3 w41 w7 unknownword"


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


def _cfgs():
    pipe = tiny_flux_config()
    return dict(mmdit=pipe.mmdit, vae=pipe.vae, clip=tiny_clip_config(),
                t5=tiny_t5_config())


def _jax_components():
    pipe = jax_tiny_flux()
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    tree = {"transformer": jax_mmdit(pipe.mmdit, ks[0], jnp.float32),
            "vae": jax_vae(pipe.vae, ks[1], jnp.float32),
            "clip": init_clip_params(tiny_clip_config(), ks[2], jnp.float32),
            "t5": init_t5_params(tiny_t5_config(), ks[3], jnp.float32)}
    return {k: tree_from_numpy(jax.tree.map(np.asarray, v), "cpu",
                               torch.float32) for k, v in tree.items()}


def _write(tmp_path, layout="bundle", fp8=None) -> str:
    d = str(tmp_path / f"{layout}_{fp8}")
    write_flux_checkpoint(d, _cfgs(), _jax_components(), layout, fp8)
    return d


def _flat(tree) -> dict:
    return {k: np.asarray(v).view(np.uint8) if "float8" in str(
        getattr(v, "dtype", "")) else np.asarray(v, np.float32)
        for k, v in flatten_tree(tree).items()}


def _port_flat(tree) -> dict:
    out = {}
    for k, v in flatten_tree(tree).items():
        out[k] = (v.view(torch.uint8).numpy() if v.dtype ==
                  torch.float8_e4m3fn else v.float().numpy())
    return out


def test_bundle_names_and_detection(tmp_path):
    d = _write(tmp_path)
    names = set(index_file(os.path.join(d, "model.safetensors")))
    assert not [n for n in EXPECTED_NAMES if n not in names]
    for detect in (detect_flux_checkpoint, jax_detect):
        ckpt = detect(d)
        assert ckpt.kind == "bundle" and ckpt.clip is not None \
            and ckpt.t5 is not None
    cfgs = _cfgs()
    assert mmdit_mapping(cfgs["mmdit"], "p.") == \
        __import__("cake_tpu.models.image", fromlist=["x"]).mmdit_mapping(
            jax_tiny_flux().mmdit, "p.")
    from cake_tpu.models.image import vae_decoder_mapping as jvm
    assert vae_decoder_mapping(cfgs["vae"], "v.") == \
        jvm(jax_tiny_flux().vae, "v.")


@pytest.mark.parametrize("layout,fp8", [("bundle", None), ("split", None),
                                        ("bundle", "plain"),
                                        ("split", "scaled")])
def test_both_packages_load_the_same(tmp_path, layout, fp8):
    d = _write(tmp_path, layout, fp8)
    ckpt, jckpt = detect_flux_checkpoint(d), jax_detect(d)
    assert ckpt.kind == jckpt.kind == layout
    port_cfgs, jax_cfgs = infer_flux_configs(ckpt), jax_infer(jckpt)
    for k in ("mmdit", "vae", "clip", "t5"):
        assert dataclass_dict(port_cfgs[k]) == dataclass_dict(jax_cfgs[k])
    for native in (False, True):
        port = load_flux_image_model(d, torch.float32, t5_seq_len=16,
                                     fp8_native=native, device="cpu")
        ref = jax_load(d, jnp.float32, t5_seq_len=16, fp8_native=native)
        want = {**_flat(ref.params), **{
            f"enc.{k}": v for k, v in _flat(
                {"clip": ref.text_encoder.params["clip"],
                 "t5": ref.text_encoder.params["t5"]}).items()}}
        got = {**_port_flat(port.params), **{
            f"enc.{k}": v for k, v in _port_flat(
                {"clip": port.text_encoder.params["clip"],
                 "t5": port.text_encoder.params["t5"]}).items()}}
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), k
        n_fp8 = sum(k.endswith(".fp8") for k in got)
        assert n_fp8 == (36 if native and fp8 else 0)
        jtxt, jvec = ref.text_encoder(PROMPT)
        ttxt, tvec = port.text_encoder(PROMPT)
        np.testing.assert_allclose(ttxt.numpy(), np.asarray(jtxt),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tvec.numpy(), np.asarray(jvec),
                                   rtol=1e-5, atol=1e-6)
        del ref


def dataclass_dict(cfg) -> dict:
    import dataclasses
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("fp8", ["plain", "scaled"])
def test_fp8_native_generates_what_at_load_generates(tmp_path, fp8):
    d = _write(tmp_path, "bundle", fp8)
    dense = load_flux_image_model(d, torch.float32, device="cpu")
    native = load_flux_image_model(d, torch.float32, fp8_native=True,
                                   device="cpu")
    a = dense.generate_image("w3 w4", 16, 16, steps=2, seed=1)
    b = native.generate_image("w3 w4", 16, 16, steps=2, seed=1)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    w = native.params["transformer"]["double"][0]["img"]["qkv"]["weight"]
    assert w["fp8"].dtype == torch.float8_e4m3fn
    assert torch.all(w["scale_inv"] == (2.0 if fp8 == "scaled" else 1.0))


def _rewrite(d, edit):
    path = os.path.join(d, "model.safetensors")
    from cake_tpu_torch.utils.safetensors_io import TensorStorage
    with TensorStorage(index_file(path)) as st:
        tensors = {n: st.read(n) for n in st.names()}
    edit(tensors)
    save_safetensors(path, tensors)


def _errors(d) -> tuple[str, str]:
    with pytest.raises(ValueError) as port:
        load_flux_image_model(d, torch.float32, device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_load(d, jnp.float32)
    return str(port.value), str(ref.value)


def test_missing_tensor_and_shape_mismatch_errors(tmp_path):
    d = _write(tmp_path)
    victim = "model.diffusion_model.double_blocks.1.img_attn.qkv.weight"
    _rewrite(d, lambda t: t.pop(victim))
    port, ref = _errors(d)
    assert port == ref and "img_attn.qkv" in port
    d = _write(tmp_path / "shape")
    _rewrite(d, lambda t: t.update({"model.diffusion_model.txt_in.weight":
                                    torch.zeros(3, 3)}))
    port, ref = _errors(d)
    assert "txt_in" in port and port == ref


def test_missing_encoders_error(tmp_path):
    d = _write(tmp_path)
    _rewrite(d, lambda t: [t.pop(n) for n in list(t)
                           if n.startswith("text_encoders.")])
    port, ref = _errors(d)
    assert "text encoders" in port and port == ref
    with pytest.raises(ValueError, match="not a recognizable"):
        load_flux_image_model(str(tmp_path / "nothing"), device="cpu")


def f2_demo_with_encoder():
    """The tiny FLUX.2 with a seeded tiny Qwen3 encoder on the CPU."""
    from cake_tpu_torch.models.image import seeded_flux2, tiny_flux2_config
    pipe = tiny_flux2_config()
    enc = dict(architectures=["Qwen3ForCausalLM"], vocab_size=1024,
               hidden_size=32, intermediate_size=64, num_hidden_layers=4,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=128)
    return seeded_flux2({"flux2": pipe.transformer, "vae": pipe.vae,
                         "encoder": enc, "output_layers": (0, 1, 2)},
                        torch.float32, "cpu", max_txt_len=16)


def test_build_image_model_demo_and_not_ported(tmp_path):
    model = build_image_model("demo:flux", "f32", device="cpu")
    assert np.asarray(model.generate_image("x", 24, 16, steps=1)).shape == \
        (16, 24, 3)
    # module 14b serves SD: demo:sd and a diffusers SD directory
    from cake_tpu_torch.bench import synth_sd
    from cake_tpu_torch.models.image import SDImageModel
    sd_demo = build_image_model("demo:sd", "f32", device="cpu")
    assert isinstance(sd_demo, SDImageModel)
    assert np.asarray(sd_demo.generate_image("x", 16, 16, 1)).shape == \
        (16, 16, 3)
    # module 14c serves FLUX.2: demo:flux2 and a diffusers FLUX.2 directory
    from cake_tpu_torch.models.image import Flux2ImageModel
    f2_demo = build_image_model("demo:flux2", "f32", device="cpu")
    assert isinstance(f2_demo, Flux2ImageModel)
    assert np.asarray(f2_demo.generate_image("x", 16, 16, 1)).shape == \
        (16, 16, 3)
    fam = synth_sd.tiny_family("sd15")
    sd = str(tmp_path / "sd")
    synth_sd.write_sd_checkpoint(sd, fam, synth_sd.seeded_sd(
        fam, torch.float32, "cpu"))
    sd_model = build_image_model(sd, "f32", device="cpu")
    assert isinstance(sd_model, SDImageModel)
    assert sd_model.generate_image("x", 32, 32, 1).size == (32, 32)
    from cake_tpu_torch.bench.synth_flux2 import write_flux2_checkpoint
    f2 = str(tmp_path / "flux2")
    write_flux2_checkpoint(f2, f2_demo_with_encoder())
    f2_model = build_image_model(f2, "f32", device="cpu")
    assert isinstance(f2_model, Flux2ImageModel)
    assert f2_model.generate_image("x", 16, 16, 1).size == (16, 16)
    # a Flux2Pipeline index with no transformer/vae/text_encoder is no
    # FLUX.2 directory, as the reference's sniff says: read as FLUX.1,
    # it is refused
    bare = tmp_path / "flux2_bare"
    bare.mkdir()
    (bare / "model_index.json").write_text(json.dumps(
        {"_class_name": "Flux2Pipeline"}))
    with pytest.raises(ValueError, match="not a recognizable"):
        build_image_model(str(bare), device="cpu")
    d = _write(tmp_path, "split", "plain")
    model = build_image_model(d, "f32", fp8_native=True, device="cpu")
    assert model.params["transformer"]["img_in"]["weight"]["fp8"].dtype == \
        torch.float8_e4m3fn


def test_cli_image_writes_a_png(tmp_path):
    from PIL import Image
    out = tmp_path / "fox.png"
    assert cli.main(["image", "demo:flux", "a watercolor fox", "--out",
                     str(out), "--width", "40", "--height", "24",
                     "--steps", "2", "--seed", "3", "--dtype", "f32",
                     "--cpu"]) == 0
    assert Image.open(out).size == (40, 24)
    d = _write(tmp_path, "bundle", "plain")
    out2 = tmp_path / "ckpt.png"
    assert cli.main(["image", d, "w1 w2", "--out", str(out2), "--width",
                     "16", "--height", "16", "--steps", "1", "--dtype",
                     "f32", "--fp8-native", "--cpu"]) == 0
    assert Image.open(out2).size == (16, 16)
