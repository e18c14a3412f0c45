"""Module 14b's loader against the JAX package's on the CPU: tiny diffusers
directories written from seeded weights with the published tensor names
and config fields (bench/synth_sd.py): SD1.x with 1x1-conv projections
and the new VAE attention names, SD2.x with linear projections, the old
VAE names, v-prediction and a gelu encoder, SDXL with its encoder pair
and time ids, and a decoder-only VAE. Each loads through both loaders to
the same parameters bit for bit; the port's load equals the seeded model
it was written from bit for bit (latents); the vocab.json + merges.txt
tokenizers give the ids of the reference's AutoTokenizer; and the loaded
pipelines, the reference's and the port's, give the same pixels (equal,
or one level apart on under 1% of them) from the reference's noise. The
config reader's errors and fields equal the reference's."""
import dataclasses
import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.image import sd as jsd
from cake_tpu.models.image import sd_loader as jload
from cake_tpu_torch.bench import synth_sd as ss
from cake_tpu_torch.models.image import sd as tsd
from cake_tpu_torch.models.image import sd_loader as tload
from cake_tpu_torch.runtime import build_image_model
from cake_tpu_torch.utils.mapping import flatten_tree

torch.set_num_threads(1)
PROMPTS = ("a red fox, in snow!", "blurry", "")


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


def _write(tmp_path, name, **kw):
    fam = ss.tiny_family(name)
    model = ss.seeded_sd(fam, torch.float32, "cpu", seed=3,
                         encoder=kw.pop("encoder", True))
    d = str(tmp_path / name)
    ss.write_sd_checkpoint(d, fam, model, **kw)
    return d, fam, model


def _same_tree(port: dict, ref: dict) -> None:
    fp, fr = flatten_tree(port), flatten_tree(ref)
    assert set(fp) == set(fr)
    for k, v in fp.items():
        assert np.array_equal(v.numpy(), np.asarray(fr[k])), k


CASES = [("sd15", dict(vae_names="new")),
         ("sd21", dict(vae_names="old")),
         ("sdxl", dict(vae_names="new", proj="conv"))]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_directory_loads_as_the_reference_loads_it(tmp_path, name, kw):
    d, fam, seeded = _write(tmp_path, name, **kw)
    port = build_image_model(d, "f32", device="cpu")
    ref = jload.load_sd_image_model(d, dtype=jnp.float32)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    for part in ("unet", "vae", "vae_enc"):
        _same_tree(port.params[part], ref.params[part])
    encoders = [(port.text_encoder, ref.text_encoder)]
    if name == "sdxl":
        encoders.append((port.text_encoder2, ref.text_encoder2))
        assert port.force_zeros_for_empty_prompt
    for te_port, te_ref in encoders:
        assert dataclasses.asdict(te_port.cfg) == \
            dataclasses.asdict(te_ref.cfg)
        _same_tree(te_port.params, te_ref.params)
        for p in PROMPTS:
            assert te_port.ids(p) == _ref_ids(te_ref, p), p
    # the load equals the seeded model it was written from
    a = seeded.denoise(PROMPTS[0], 32, 32, steps=2, seed=1,
                       negative_prompt=PROMPTS[1])
    b = port.denoise(PROMPTS[0], 32, 32, steps=2, seed=1,
                     negative_prompt=PROMPTS[1])
    assert torch.equal(a, b)
    # the loaded pipelines, from the reference's noise
    want = np.asarray(ref.generate_image(PROMPTS[0], 32, 32, 2, seed=5,
                                         negative_prompt=PROMPTS[1]))
    lh, lw = tsd.latent_size(port.cfg, 32, 32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                         (1, 4, lh, lw), jnp.float32))
    got = np.asarray(port.generate_image(
        PROMPTS[0], 32, 32, 2, negative_prompt=PROMPTS[1],
        noise=torch.from_numpy(noise)))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _ref_ids(te_ref, prompt):
    """The reference SDTextEncoder's ids before its forward."""
    n, eot = te_ref.cfg.max_positions, te_ref.cfg.eot_token_id
    ids = te_ref._hf(prompt)["input_ids"] if te_ref._tok is None \
        else te_ref._tok.encode(prompt).ids
    if len(ids) > n:
        ids = ids[:n]
        ids[-1] = eot
    return ids + [eot] * (n - len(ids))


def test_tokenizer_json_and_a_long_prompt(tmp_path):
    d, _, _ = _write(tmp_path, "sd15", tokenizer="json")
    assert os.path.exists(os.path.join(d, "tokenizer", "tokenizer.json"))
    port = build_image_model(d, "f32", device="cpu")
    ref = jload.load_sd_image_model(d, dtype=jnp.float32)
    long = " ".join(["fox"] * 120)
    for p in PROMPTS + (long,):
        assert port.text_encoder.ids(p) == _ref_ids(ref.text_encoder, p)
    ids = port.text_encoder.ids(long)
    assert len(ids) == 77 and ids[-1] == port.text_encoder.cfg.eot_token_id


def test_decoder_only_vae(tmp_path):
    d, _, _ = _write(tmp_path, "sd15", encoder=False)
    port = build_image_model(d, "f32", device="cpu")
    ref = jload.load_sd_image_model(d, dtype=jnp.float32)
    assert "vae_enc" not in port.params and "vae_enc" not in ref.params
    _same_tree(port.params["vae"], ref.params["vae"])
    with pytest.raises(ValueError, match="no VAE encoder"):
        port.init_latent_from(np.zeros((32, 32, 3), np.uint8), 32, 32)
    assert port.generate_image("x", 32, 32, 1).size == (32, 32)


def test_mappings_equal_the_reference(tmp_path):
    for name in ss.FAMILIES:
        cfg = ss.pipeline_config(ss.FAMILIES[name])
        assert tload.sd_unet_mapping(cfg.unet)[0] == \
            jload.sd_unet_mapping(cfg.unet)[0]
        assert set(tload.sd_unet_mapping(cfg.unet)[1]) == \
            set(jload.sd_unet_mapping(cfg.unet)[1])
        for new in (True, False):
            names = ss._Names(new, "decoder.")
            assert tload.sd_vae_decoder_mapping(names, cfg.vae)[0] == \
                jload.sd_vae_decoder_mapping(names, cfg.vae)[0]
            names = ss._Names(new, "encoder.")
            assert tload.sd_vae_encoder_mapping(names, cfg.vae)[0] == \
                jload.sd_vae_encoder_mapping(names, cfg.vae)[0]


def test_published_configs_read_as_the_reference_reads_them(tmp_path):
    """Every family's published configs at full widths: the same
    pipeline config, and the UNet's parameter count."""
    counts = {}
    for name, fam in ss.FAMILIES.items():
        d = tmp_path / name
        for sub, key in (("unet", "unet"), ("vae", "vae")):
            (d / sub).mkdir(parents=True)
            (d / sub / "config.json").write_text(json.dumps(fam[key]))
        (d / "scheduler").mkdir()
        (d / "scheduler" / "scheduler_config.json").write_text(
            json.dumps(fam["scheduler"]))
        port, ref = (tload.sd_configs_from_dir(str(d)),
                     jload.sd_configs_from_dir(str(d)))
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        shapes = tsd.init_unet_params(port.unet, 0, torch.bfloat16, "meta")
        counts[name] = sum(t.numel() for t in flatten_tree(shapes).values())
    assert ss.pipeline_config(ss.FAMILIES["sd21"]).prediction_type == \
        "v_prediction"
    # published: SD1.5's UNet 0.86 B parameters, SDXL's 2.57 B
    assert abs(counts["sd15"] / 1e9 - 0.86) < 0.01, counts
    assert abs(counts["sdxl"] / 1e9 - 2.57) < 0.01, counts


def test_config_errors_equal_the_reference(tmp_path):
    fam = ss.tiny_family("sd21")
    for change, kind in ((dict(addition_embed_type="image"),
                          NotImplementedError),
                         (dict(attention_head_dim=[2, 4, 8]), ValueError)):
        d = tmp_path / kind.__name__
        for sub, cfg in (("unet", dict(fam["unet"], **change)),
                         ("vae", fam["vae"])):
            (d / sub).mkdir(parents=True)
            (d / sub / "config.json").write_text(json.dumps(cfg))
        with pytest.raises(kind) as want:
            jload.sd_configs_from_dir(str(d))
        with pytest.raises(kind) as got:
            tload.sd_configs_from_dir(str(d))
        assert str(got.value) == str(want.value)
    # no scheduler config: epsilon and SD's betas
    d = tmp_path / "plain"
    for sub in ("unet", "vae"):
        (d / sub).mkdir(parents=True)
        (d / sub / "config.json").write_text(json.dumps(fam[sub]))
    cfg = tload.sd_configs_from_dir(str(d))
    assert (cfg.prediction_type, cfg.beta_start, cfg.beta_end,
            cfg.beta_schedule) == ("epsilon", 0.00085, 0.012,
                                   "scaled_linear")
    with pytest.raises(ValueError, match="not a diffusers SD"):
        tload.load_sd_image_model(str(tmp_path / "nothing"), device="cpu")


def test_demo_sd_and_fp8_refusal():
    model = build_image_model("demo:sd", "f32", device="cpu")
    assert isinstance(model, tsd.SDImageModel)
    assert dataclasses.asdict(model.cfg) == \
        dataclasses.asdict(jsd.tiny_sd_config())
    assert np.asarray(model.generate_image("x", 16, 16, 1)).shape == \
        (16, 16, 3)
    with pytest.raises(ValueError, match="FLUX.1's"):
        build_image_model("demo:sd", fp8_native=True, device="cpu")


def test_cli_image_img2img(tmp_path):
    """`cli image DIR --init-image PNG --strength S` (an RGBA PNG with
    filtered rows, resized from 40 x 28) writes the image; a FLUX model
    refuses --init-image; an unreadable init image exits naming it."""
    from PIL import Image
    from cake_tpu_torch import cli
    from cake_tpu_torch.utils.png import decode_png
    d, _, _ = _write(tmp_path, "sd15")
    init = tmp_path / "init.png"
    rgba = np.random.default_rng(1).integers(0, 256, (28, 40, 4),
                                             dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(init, optimize=True)
    out = tmp_path / "out.png"
    assert cli.main(["image", d, "a fox", "--out", str(out), "--width",
                     "32", "--height", "32", "--steps", "3", "--cpu",
                     "--dtype", "f32", "--init-image", str(init),
                     "--strength", "0.6"]) == 0
    assert decode_png(out.read_bytes()).shape == (32, 32, 3)
    with pytest.raises(SystemExit, match="needs an SD model"):
        cli.main(["image", "demo:flux", "x", "--out", str(out), "--cpu",
                  "--init-image", str(init)])
    (tmp_path / "bad.png").write_bytes(b"GIF89a")
    with pytest.raises(SystemExit, match="bad.png: not a PNG"):
        cli.main(["image", d, "x", "--out", str(out), "--cpu", "--dtype",
                  "f32", "--width", "32", "--height", "32",
                  "--init-image", str(tmp_path / "bad.png")])
