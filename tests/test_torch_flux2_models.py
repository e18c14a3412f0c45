"""Module 14c's FLUX.2-klein against the JAX package on the CPU, its seeded
parameters carried across as numpy (utils/weights.flux2_params_from_numpy,
params_from_numpy for the Qwen3 encoder): the image and text ids,
empirical_mu and the schedule (exactly), the double and single blocks and
flux2_forward (float32 within 1e-5 relative, or 1e-5 of the largest
magnitude near zero; bfloat16 within the golden bar of 2e-2), the Qwen3
text encoder's captures (within 1e-5 of the reference's forward_layers
run over each capture segment's own layers) and its padding mask, and a
tiny generate_image from the same initial noise and text (the decoded
image within 1e-4 before quantization, the pixels at most one level
apart).

Fault of the reference (ROADMAP §3): its Flux2TextEncoder runs every
capture segment after the first with the weights of layers 0, 1, ...;
test_reference_encoder_runs_the_wrong_layers shows it departing from the
segment-by-segment run the port equals."""
import gc
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import init_params as jinit_params
from cake_tpu.models import tiny_config as jtiny_config
from cake_tpu.models.common.layers import embed_tokens as jembed
from cake_tpu.models.common.layers import forward_layers as jforward
from cake_tpu.models.image import flux as jflux
from cake_tpu.models.image import flux2 as jf2
from cake_tpu.models.image import mmdit as jmm
from cake_tpu.models.image import vae as jvae
from cake_tpu_torch.models.common.config import tiny_config
from cake_tpu_torch.models.image import flux2 as tf2
from cake_tpu_torch.models.image import mmdit as tmm
from cake_tpu_torch.utils.weights import (flux2_params_from_numpy,
                                          params_from_numpy, tree_from_numpy)

torch.set_num_threads(1)
BF16 = dict(rtol=0, atol=2e-2)


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
    """Within tol relative, or tol of the largest |want|."""
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("seq,steps", [(4096, 20), (64, 4), (8192, 50),
                                       (4300, 4), (4301, 28)])
def test_mu_and_schedule_are_exact(seq, steps):
    mu = tf2.empirical_mu(seq, steps)
    assert mu == jf2.empirical_mu(seq, steps)
    assert np.array_equal(tf2.flux2_schedule(steps, mu),
                          jf2.flux2_schedule(steps, mu))


@pytest.mark.parametrize("hw", [(2, 3), (1, 1), (5, 4)])
def test_ids_are_exact(hw):
    img = tf2.make_img_ids4(*hw, batch=2)
    assert np.array_equal(img.numpy(), np.asarray(jf2.make_img_ids4(*hw, 2)))
    txt = tf2.make_txt_ids4(7, batch=2)
    assert np.array_equal(txt.numpy(), np.asarray(jf2.make_txt_ids4(7, 2)))
    assert tf2.default_output_layers(36) == jf2.default_output_layers(36) \
        == (8, 17, 26)


def _transformer(dtype=jnp.float32, seed=0):
    cfg = jf2.tiny_flux2_config().transformer
    return cfg, jf2.init_flux2_params(cfg, jax.random.PRNGKey(seed), dtype)


def _inputs(cfg, s_img=6, s_txt=5, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((1, s_img, cfg.in_channels)).astype(dtype)
    txt = rng.standard_normal((1, s_txt, cfg.context_in_dim)).astype(dtype)
    return img, txt


def _rope(cfg, s_img_hw=(2, 3), s_txt=5):
    ids = np.concatenate([np.asarray(jf2.make_txt_ids4(s_txt)),
                          np.asarray(jf2.make_img_ids4(*s_img_hw))], 1)
    jc, js = jmm.rope_2d(jnp.asarray(ids), cfg.axes_dims, cfg.theta)
    tc, ts = tmm.rope_2d(torch.from_numpy(ids), cfg.axes_dims, cfg.theta)
    _close(tc, jc)
    _close(ts, js)
    return (jc, js), (tc, ts)


def test_double_and_single_blocks_match_reference():
    cfg, params = _transformer()
    ported = tree_from_numpy(_np(params), "cpu", torch.float32)
    (jc, js), (tc, ts) = _rope(cfg)
    img, txt = _inputs(cfg)
    h = cfg.hidden_size
    rng = np.random.default_rng(4)
    x_img = rng.standard_normal((1, 6, h)).astype(np.float32)
    x_txt = rng.standard_normal((1, 5, h)).astype(np.float32)
    img_mod = (rng.standard_normal((1, 1, 6, h)) * 0.3).astype(np.float32)
    txt_mod = (rng.standard_normal((1, 1, 6, h)) * 0.3).astype(np.float32)
    want = jf2.flux2_double_block(cfg, params["double"][0], x_img, x_txt,
                                  img_mod, txt_mod, jc, js)
    got = tf2.flux2_double_block(
        cfg, ported["double"][0], torch.from_numpy(x_img),
        torch.from_numpy(x_txt), torch.from_numpy(img_mod),
        torch.from_numpy(txt_mod), tc, ts)
    for g, w in zip(got, want):
        _close(g, w)
    x = np.concatenate([x_txt, x_img], 1)
    mod = img_mod[:, :, :3]
    _close(tf2.flux2_single_block(cfg, ported["single"][1],
                                  torch.from_numpy(x), torch.from_numpy(mod),
                                  tc, ts),
           jf2.flux2_single_block(cfg, params["single"][1], x, mod, jc, js))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flux2_forward_matches_reference(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    cfg, params = _transformer(jdt, seed=3)
    ported = tree_from_numpy(_np(params), "cpu", tdt)
    img, txt = _inputs(cfg, seed=5)
    t = np.asarray([0.63], np.float32)
    want = jf2.flux2_forward(
        cfg, params, jnp.asarray(img, jdt), jf2.make_img_ids4(2, 3),
        jnp.asarray(txt, jdt), jf2.make_txt_ids4(5), jnp.asarray(t))
    got = tf2.flux2_forward(
        cfg, ported, torch.from_numpy(img).to(tdt), tf2.make_img_ids4(2, 3),
        torch.from_numpy(txt).to(tdt), tf2.make_txt_ids4(5),
        torch.from_numpy(t))
    assert got.dtype == tdt and got.shape == (1, 6, cfg.in_channels)
    if dtype == "f32":
        _close(got, want)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


ENC_KW = dict(hidden_size=32, intermediate_size=64, num_attention_heads=4,
              num_key_value_heads=2, num_hidden_layers=5)


def _encoder(seed=5):
    jcfg = jtiny_config("qwen3", **ENC_KW)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tcfg = tiny_config("qwen3", **ENC_KW)
    return jcfg, jparams, tcfg, params_from_numpy(tcfg, _np(jparams), "cpu",
                                                  torch.float32)


def _segments(jcfg, jparams, ids, valid_len, captures):
    """The reference's stateless forward_layers over each capture segment
    with that segment's own layers (the reference's upstream semantics:
    one pass over layers 0..max, hidden states kept after each capture)."""
    x = jembed(jcfg, jparams, jnp.asarray(ids))
    outs, lo = [], 0
    for out in captures:
        sub = {"layers": jparams["layers"][lo:out + 1],
               "rope": jparams["rope"]}
        x, _ = jforward(jcfg, sub, x, None, jnp.asarray(0, jnp.int32),
                        layer_range=(lo, out + 1),
                        valid_len=jnp.asarray(valid_len, jnp.int32))
        outs.append(x)
        lo = out + 1
    return jnp.concatenate(outs, axis=-1)


IDS = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)


@pytest.mark.parametrize("captures,valid_len", [((0, 1, 2), 8),
                                                ((1, 2, 4), 5),
                                                ((0, 3, 4), 3)])
def test_encoder_matches_each_segments_own_layers(captures, valid_len):
    jcfg, jparams, tcfg, tparams = _encoder()
    want = _segments(jcfg, jparams, IDS, valid_len, captures)
    enc = tf2.Flux2TextEncoder(tcfg, tparams, max_len=8,
                               output_layers=captures, dtype=torch.float32)
    got = enc.encode_ids(IDS, valid_len)
    assert got.shape == (1, 8, 3 * tcfg.hidden_size)
    _close(got, want)


def test_encoder_holds_only_the_layers_it_runs():
    jcfg, jparams, tcfg, tparams = _encoder()
    want = _segments(jcfg, jparams, IDS, 6, (1, 2, 3))
    cut = dict(tparams, layers=tparams["layers"][:4])
    enc = tf2.Flux2TextEncoder(tcfg, cut, max_len=8, output_layers=(1, 2, 3),
                               dtype=torch.float32)
    _close(enc.encode_ids(IDS, 6), want)
    with pytest.raises(ValueError, match="need 5"):
        tf2.Flux2TextEncoder(tcfg, cut, output_layers=(1, 2, 4))


def test_reference_encoder_runs_the_wrong_layers():
    """Fault of the reference (ROADMAP §3): its captures after the first
    segment depart from the segment-by-segment run (they reuse layers 0,
    1, ...), while the first agrees; the port equals the run."""
    jcfg, jparams, tcfg, tparams = _encoder()
    captures = (0, 1, 2)
    jenc = jf2.Flux2TextEncoder(jcfg, jparams, max_len=8,
                                output_layers=captures, dtype=jnp.float32)
    ref = np.asarray(jenc._encode(jparams, jnp.asarray(IDS),
                                  jnp.asarray(8, jnp.int32)))
    want = np.asarray(_segments(jcfg, jparams, IDS, 8, captures))
    h = jcfg.hidden_size
    assert np.abs(ref[..., :h] - want[..., :h]).max() < 1e-5
    assert np.abs(ref[..., h:] - want[..., h:]).max() > 1e-3
    got = tf2.Flux2TextEncoder(tcfg, tparams, max_len=8,
                               output_layers=captures,
                               dtype=torch.float32).encode_ids(IDS, 8)
    _close(got, want)


def test_encoder_pads_are_invisible():
    """Real-token hidden states do not depend on what the pads are."""
    _, _, tcfg, tparams = _encoder()
    enc = tf2.Flux2TextEncoder(tcfg, tparams, max_len=8,
                               output_layers=(0, 1, 2), dtype=torch.float32)
    a = enc.encode_ids(np.asarray([[1, 2, 3, 9, 9, 9, 9, 9]]), 3)
    b = enc.encode_ids(np.asarray([[1, 2, 3, 7, 7, 7, 7, 7]]), 3)
    assert torch.equal(a[:, :3], b[:, :3])
    assert not torch.allclose(a[:, 3:], b[:, 3:])


class _Text:
    def __init__(self, txt):
        self.txt = txt

    def __call__(self, prompt):
        return self.txt


@pytest.mark.parametrize("side,steps", [(32, 2), (48, 3)])
def test_generate_image_matches_reference(side, steps, monkeypatch):
    pipe = jf2.tiny_flux2_config()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(9), 3)
    jparams = {"transformer": jf2.init_flux2_params(pipe.transformer, k1,
                                                    jnp.float32),
               "vae": jvae.init_vae_decoder_params(pipe.vae, k2,
                                                   jnp.float32)}
    lc = pipe.vae.latent_channels
    jparams["vae"]["post_quant_conv"] = {
        "weight": jax.random.normal(k3, (lc, lc, 1, 1)) * 0.3,
        "bias": jnp.full((lc,), 0.05)}
    ic = pipe.transformer.in_channels
    rng = np.random.default_rng(side)
    bn = (rng.standard_normal(ic).astype(np.float32) * 0.1,
          rng.uniform(0.5, 1.5, ic).astype(np.float32))
    txt = rng.standard_normal((1, 12, pipe.transformer.context_in_dim)) \
        .astype(np.float32)
    jm = jf2.Flux2ImageModel(pipe, params=jparams, text_encoder=_Text(txt),
                             bn_stats=bn, dtype=jnp.float32)
    seen = []
    real_to_pil = jflux.to_pil

    def record(chw):
        seen.append(np.asarray(chw))
        return real_to_pil(chw)
    monkeypatch.setattr(jflux, "to_pil", record)
    want_img = np.asarray(jm.generate_image("x", side, side, steps=steps,
                                            seed=4))
    h_half = w_half = -(-side // (2 * 2 ** (len(pipe.vae.channel_mults)
                                            - 1)))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(4),
                                         (1, h_half * w_half, ic)))
    tm = tf2.Flux2ImageModel(pipe, params=flux2_params_from_numpy(
        _np(jparams), "cpu", torch.float32), bn_stats=bn,
        dtype=torch.float32, device="cpu")
    noise = torch.from_numpy(noise.copy())
    packed = tm.denoise("x", side, side, steps, noise=noise,
                        text=torch.from_numpy(txt))
    image = tm.decode(packed, side, side)[0, :, :side, :side]
    _close(image, seen[0], tol=1e-4)
    got_img = np.asarray(tm.generate_image(
        "x", side, side, steps, noise=noise, text=torch.from_numpy(txt)))
    diff = np.abs(got_img.astype(int) - want_img.astype(int))
    assert got_img.shape == (side, side, 3) and diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_dummy_encoder_and_bf16_pipeline():
    """The random-weight demo: the prompt's CRC32 seeds the context on the
    CPU generator (stable across processes), and the tiny pipeline runs
    in bf16 with a float32 VAE."""
    enc = tf2.DummyFlux2TextEncoder(96, 16)
    a = enc("a fox")
    gen = torch.Generator().manual_seed(zlib.crc32(b"a fox"))
    assert torch.equal(a, torch.randn((1, 16, 96), generator=gen))
    m = tf2.Flux2ImageModel(tf2.tiny_flux2_config(), dtype=torch.bfloat16,
                            device="cpu")
    assert m.params["vae"]["conv_in"]["weight"].dtype == torch.float32
    img = np.asarray(m.generate_image("a fox", 40, 24, steps=2, seed=1,
                                      guidance=9.0, negative_prompt="no"))
    assert img.shape == (24, 40, 3) and img.std() > 0
    assert set(m.stats) == {"encode_s", "denoise_s", "steps", "decode_s"}
