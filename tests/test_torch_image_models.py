"""Module 14a's models against the JAX package on the CPU, the JAX
package's seeded parameters carried across as numpy
(utils/weights.tree_from_numpy): CLIP (hidden, pooled at the first EOT,
penultimate), the T5 encoder and its relative-position buckets (exactly),
the MMDiT (float32, bfloat16, and with native FP8 pairs through the plain
dequant), the VAE decoder, rope_2d / the interleaved rope / the timestep
embedding, and the whole FLUX.1 pipeline with the same (txt, vec) and
initial noise (the port's generator cannot equal jax.random): equal uint8
pixels, or at most one level apart on a few. Tolerances: float32 within
1e-5 relative (each element, or 1e-5 of the output's largest magnitude
for elements near zero), bfloat16 within the golden bar of 2e-2
absolute."""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.image import flux as jflux
from cake_tpu.models.image import mmdit as jmm
from cake_tpu.models.image import vae as jvae
from cake_tpu.models.text_encoders import clip as jclip
from cake_tpu.models.text_encoders import t5 as jt5
from cake_tpu.ops.fp8 import quant_fp8_blockwise
from cake_tpu_torch.models.image import flux as tflux
from cake_tpu_torch.models.image import mmdit as tmm
from cake_tpu_torch.models.image import vae as tvae
from cake_tpu_torch.models.text_encoders import clip as tclip
from cake_tpu_torch.models.text_encoders import t5 as tt5
from cake_tpu_torch.utils.weights import tree_from_numpy

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()

BF16 = dict(rtol=0, atol=2e-2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree, dtype=torch.float32):
    return tree_from_numpy(_np_tree(tree), "cpu", dtype)


def _close(got, want):
    """float32: within 1e-5 relative, or 1e-5 of the largest |want|."""
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_relative_position_buckets_are_exact():
    for q, k, nb, md in ((1, 1, 32, 128), (77, 77, 32, 128),
                         (512, 512, 32, 128), (40, 40, 8, 16),
                         (300, 300, 64, 64)):
        assert np.array_equal(tt5.relative_position_buckets(q, k, nb, md),
                              jt5.relative_position_buckets(q, k, nb, md))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_clip_matches_reference(dtype):
    cfg = jclip.tiny_clip_config()
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    params = jclip.init_clip_params(cfg, jax.random.PRNGKey(2), jdt)
    ported = _port(params, tdt)
    # EOT twice (pooled at the FIRST), padded with EOT, and a row with none
    ids = np.array([[3, 5, 95, 7, 95, 95, 95, 95],
                    [9, 8, 7, 6, 5, 4, 3, 2]], np.int32)
    want = jclip.clip_text_forward(cfg, params, ids)
    got = tclip.clip_text_forward(cfg, ported, torch.from_numpy(ids).long())
    tol = F32 if dtype == "f32" else BF16
    for w, g in zip(want, got):
        assert g.dtype == tdt
        np.testing.assert_allclose(_f32(g), _f32(w), **tol)


def test_clip_with_projection_and_gelu():
    import dataclasses
    cfg = dataclasses.replace(jclip.tiny_clip_config(), hidden_act="gelu",
                              projection_dim=24)
    params = jclip.init_clip_params(cfg, jax.random.PRNGKey(4))
    ids = np.array([[1, 2, 95, 0, 0]], np.int32)
    want = jclip.clip_text_forward(cfg, params, ids)
    got = tclip.clip_text_forward(cfg, _port(params),
                                  torch.from_numpy(ids).long())
    assert got[1].shape == (1, 24)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_f32(g), _f32(w), **F32)
    assert set(tclip.clip_mapping(cfg)) == set(jclip.clip_mapping(cfg))
    assert tclip.clip_mapping(cfg) == jclip.clip_mapping(cfg)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_t5_matches_reference(dtype):
    cfg = jt5.tiny_t5_config()
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    params = jt5.init_t5_params(cfg, jax.random.PRNGKey(3), jdt)
    ids = np.random.default_rng(1).integers(0, 96, (2, 40)).astype(np.int32)
    want = jt5.t5_encode(cfg, params, ids)
    got = tt5.t5_encode(cfg, _port(params, tdt), torch.from_numpy(ids).long())
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "f32" else BF16))
    assert tt5.t5_mapping(cfg, "p.") == jt5.t5_mapping(cfg, "p.")


def test_rope_and_timestep_embedding_match_reference():
    ids = np.asarray(jnp.concatenate([jmm.make_txt_ids(5),
                                      jmm.make_img_ids(3, 4)], axis=1))
    assert np.array_equal(tmm.make_img_ids(3, 4).numpy(),
                          np.asarray(jmm.make_img_ids(3, 4)))
    for axes in ((16, 56, 56), (4, 6, 6)):
        want = jmm.rope_2d(ids, axes, 10000.0)
        got = tmm.rope_2d(torch.from_numpy(ids), axes, 10000.0)
        for w, g in zip(want, got):
            np.testing.assert_allclose(_f32(g), _f32(w), **F32)
    x = np.random.default_rng(0).standard_normal((1, 17, 2, 8), np.float32)
    cos, sin = jmm.rope_2d(ids, (2, 2, 4), 10000.0)
    np.testing.assert_allclose(
        _f32(tmm.apply_rope_interleaved(torch.from_numpy(x),
                                        torch.from_numpy(np.asarray(cos)),
                                        torch.from_numpy(np.asarray(sin)))),
        _f32(jmm.apply_rope_interleaved(x, cos, sin)), **F32)
    # t * 1000 reaches 1000 rad, where one float32 ulp of the argument is
    # 6.1e-5: torch's and XLA's sin / cos may part by that much
    t = np.array([0.0, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(
        _f32(tmm.timestep_embedding(torch.from_numpy(t), 256)),
        _f32(jmm.timestep_embedding(t, 256)), rtol=0, atol=1e-4)


def _mmdit_inputs(cfg, seed=0, s_txt=5, hp=4, wp=4):
    rng = np.random.default_rng(seed)
    return dict(
        img=rng.standard_normal((1, hp * wp, cfg.in_channels), np.float32),
        txt=rng.standard_normal((1, s_txt, cfg.txt_dim), np.float32),
        vec=rng.standard_normal((1, cfg.vec_dim), np.float32),
        img_ids=np.asarray(jmm.make_img_ids(hp, wp)),
        txt_ids=np.asarray(jmm.make_txt_ids(s_txt)),
        t=np.array([0.7], np.float32), g=np.array([3.5], np.float32))


def _run_mmdit(cfg, jparams, tparams, inp, jdt, tdt):
    want = jmm.mmdit_forward(
        cfg, jparams, jnp.asarray(inp["img"], jdt), inp["img_ids"],
        jnp.asarray(inp["txt"], jdt), inp["txt_ids"], inp["t"],
        jnp.asarray(inp["vec"], jdt), inp["g"])
    got = tmm.mmdit_forward(
        cfg, tparams, torch.from_numpy(inp["img"]).to(tdt),
        torch.from_numpy(inp["img_ids"]), torch.from_numpy(inp["txt"]).to(tdt),
        torch.from_numpy(inp["txt_ids"]), torch.from_numpy(inp["t"]),
        torch.from_numpy(inp["vec"]).to(tdt), torch.from_numpy(inp["g"]))
    return want, got


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mmdit_matches_reference(dtype):
    cfg = jflux.tiny_flux_config().mmdit
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    params = jmm.init_mmdit_params(cfg, jax.random.PRNGKey(0), jdt)
    want, got = _run_mmdit(cfg, params, _port(params, tdt),
                           _mmdit_inputs(cfg), jdt, tdt)
    assert got.shape == (1, 16, cfg.in_channels) and got.dtype == tdt
    if dtype == "f32":
        _close(got, want)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


def _fp8_tree(tree):
    """Every 2-D weight as the reference's native pair, quantized by the
    reference's quant_fp8_blockwise."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "weight" and getattr(v, "ndim", 0) == 2:
                w8, s = quant_fp8_blockwise(v)
                out[k] = {"fp8": w8, "scale_inv": s}
            else:
                out[k] = _fp8_tree(v)
        return out
    if isinstance(tree, list):
        return [_fp8_tree(v) for v in tree]
    return tree


def test_mmdit_fp8_native_matches_reference():
    """Native FP8 pairs through the plain dequant (CPU tensors), against
    the reference's fused dequant, with the guidance embedder off too."""
    import dataclasses
    for guidance in (True, False):
        cfg = dataclasses.replace(jflux.tiny_flux_config().mmdit,
                                  guidance_embed=guidance)
        params = _fp8_tree(jmm.init_mmdit_params(cfg, jax.random.PRNGKey(1),
                                                 jnp.float32))
        ported = _port(params)
        assert ported["double"][0]["img"]["qkv"]["weight"]["fp8"].dtype == \
            torch.float8_e4m3fn
        inp = _mmdit_inputs(cfg, seed=2, s_txt=3, hp=2, wp=6)
        want, got = _run_mmdit(cfg, params, ported, inp, jnp.float32,
                               torch.float32)
        _close(got, want)


def test_vae_decoder_matches_reference():
    import dataclasses
    cfg = dataclasses.replace(jflux.tiny_flux_config().vae,
                              channel_mults=(1, 2, 2), num_res_blocks=2)
    params = jvae.init_vae_decoder_params(cfg, jax.random.PRNGKey(5))
    z = np.random.default_rng(3).standard_normal((1, 4, 4, 6), np.float32)
    want = jvae.vae_decode(cfg, params, z)
    got = tvae.vae_decode(cfg, _port(params), torch.from_numpy(z))
    assert got.shape == (1, 3, 16, 24)
    _close(got, want)


class _Fixed:
    """A text encoder answering fixed (txt, vec)."""

    def __init__(self, txt, vec):
        self.txt, self.vec = txt, vec

    def __call__(self, prompt):
        return self.txt, self.vec


@pytest.mark.parametrize("width,height,steps", [(32, 32, 2), (40, 24, 3)])
def test_flux_pipeline_matches_reference(width, height, steps):
    """generate_image end to end in float32, with the reference's
    parameters, the same (txt, vec) and the same initial latent: the
    latent rounded up to even sizes and the image cropped back."""
    cfg = jflux.tiny_flux_config()
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    params = {"transformer": jmm.init_mmdit_params(cfg.mmdit, k1,
                                                   jnp.float32),
              "vae": jvae.init_vae_decoder_params(cfg.vae, k2,
                                                  jnp.float32)}
    rng = np.random.default_rng(width)
    txt = rng.standard_normal((1, 6, cfg.mmdit.txt_dim), np.float32)
    vec = rng.standard_normal((1, cfg.mmdit.vec_dim), np.float32)
    ref = jflux.FluxImageModel(cfg, params=params,
                               text_encoder=_Fixed(jnp.asarray(txt),
                                                   jnp.asarray(vec)))
    want = np.asarray(ref.generate_image("p", width, height, steps,
                                         seed=11))
    lh, lw = tflux.latent_size(cfg, width, height)
    noise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(11), (1, cfg.vae.latent_channels, lh, lw),
        jnp.float32))
    port = tflux.FluxImageModel(
        cfg, params={k: _port(v) for k, v in params.items()},
        text_encoder=_Fixed(torch.from_numpy(txt), torch.from_numpy(vec)),
        device="cpu")
    got = np.asarray(port.generate_image("p", width, height, steps,
                                         noise=torch.from_numpy(noise)))
    assert got.shape == want.shape == (height, width, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, \
        (diff.max(), (diff > 0).mean())
    assert set(port.stats) == {"encode_s", "denoise_s", "steps", "decode_s"}


def test_dummy_encoder_and_seeded_noise_are_deterministic():
    model = tflux.FluxImageModel(tflux.tiny_flux_config(), device="cpu",
                                 seed=3)
    a = np.asarray(model.generate_image("same prompt", 16, 16, 1, seed=4))
    b = np.asarray(model.generate_image("same prompt", 16, 16, 1, seed=4))
    c = np.asarray(model.generate_image("same prompt", 16, 16, 1, seed=5))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    txt, vec = tflux.DummyTextEncoder(32, 32)("x")
    assert txt.shape == (1, 16, 32) and vec.shape == (1, 32)
