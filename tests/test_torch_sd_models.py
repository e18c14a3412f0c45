"""Module 14b's models against the JAX package on the CPU, the JAX
package's seeded parameters carried across as numpy
(utils/weights.sd_params_from_numpy): DPM-Solver++(2M) over the same
model outputs for every prediction type and schedule, the VAE encoder
(the posterior's mode, and a sample with the same noise), the UNet for
SD1.x (one head count, one attention level), SD2.x (per-level head
counts, attention at every level) and a tiny SDXL (the text_time
embedding, per-level transformer depths) in float32 and bfloat16, and
the pipelines with the same conditioning and the reference's jax.random
noise: txt2img, img2img from an RGBA image (Pillow's convert and resize
against utils/png's), SDXL with an empty negative prompt (the zeros
path) and with one, and the intermediate images. Tolerances: the
scheduler within 1e-6 relative; float32 UNet outputs within 1e-4
relative (each element, or 1e-4 of the output's largest magnitude for
elements near zero); bfloat16 (XLA fuses and rounds in other places
than torch's per-op kernels) within 5e-2 of the output's largest
magnitude, and the mean error within 1e-2 of it; pipeline pixels equal,
or one level apart on under 1% of them. The reference's functions run
under jax.jit, as its pipelines run them."""
import dataclasses
import functools
import gc
import glob
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cake_tpu.models.image import sd as jsd
from cake_tpu.models.image import vae as jvae
from cake_tpu.ops import diffusion as jdiff
from cake_tpu_torch.models.image import sd as tsd
from cake_tpu_torch.models.image import vae as tvae
from cake_tpu_torch.ops import diffusion as tdiff
from cake_tpu_torch.utils.png import decode_png
from cake_tpu_torch.utils.weights import sd_params_from_numpy, \
    tree_from_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=1e-4):
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- the scheduler ------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["scaled_linear", "linear",
                                      "squaredcos_cap_v2"])
@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction",
                                        "sample"])
def test_dpm_solver_matches_reference(schedule, prediction):
    want_s = jdiff.DpmSolverPP.from_betas(schedule=schedule,
                                          prediction_type=prediction)
    rng = np.random.default_rng(len(schedule) + len(prediction))
    for steps in (1, 4, 10):
        # one port solver per sequence; the reference's is reset
        got_s = tdiff.DpmSolverPP.from_betas(schedule=schedule,
                                             prediction_type=prediction)
        assert np.array_equal(got_s.alphas_cumprod, want_s.alphas_cumprod)
        ts = got_s.timesteps(steps)
        assert np.array_equal(ts, want_s.timesteps(steps))
        want_s.reset()
        x = rng.standard_normal((1, 4, 6, 5)).astype(np.float32)
        xw, xg = jnp.asarray(x), torch.from_numpy(x)
        for j, t in enumerate(ts):
            out = rng.standard_normal(x.shape).astype(np.float32)
            t_next = int(ts[j + 1]) if j + 1 < len(ts) else 0
            xw = want_s.step(jnp.asarray(out), int(t), t_next, xw)
            xg = got_s.step(torch.from_numpy(out), int(t), t_next, xg)
            assert xg.dtype == torch.float32
            _close(xg, xw, rel=1e-6)


def test_dpm_solver_keeps_bf16_and_refuses_unknown_schedules():
    s = tdiff.DpmSolverPP.from_betas(prediction_type="epsilon")
    x = torch.randn(1, 4, 4, 4).to(torch.bfloat16)
    out = s.step(x, 999, 500, x)
    out = s.step(x, 500, 0, out)
    assert out.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="sigmoid"):
        tdiff.DpmSolverPP.from_betas(schedule="sigmoid")


# -- the VAE encoder ------------------------------------------------------------

def test_vae_encode_matches_reference():
    cfg = jsd.tiny_sd_config().vae
    p = jvae.init_vae_encoder_params(cfg, jax.random.PRNGKey(5))
    tp = tree_from_numpy(_np(p), "cpu", torch.float32)
    img = np.random.default_rng(0).uniform(-1, 1, (2, 3, 20, 12)) \
        .astype(np.float32)
    want = jax.jit(functools.partial(jvae.vae_encode, cfg))(p, img)
    got = tvae.vae_encode(cfg, tp, torch.from_numpy(img))
    assert got.shape == want.shape == (2, 4, 10, 6)
    _close(got, want, rel=1e-5)
    key = jax.random.PRNGKey(9)
    want = jax.jit(functools.partial(jvae.vae_encode, cfg))(p, img, key)
    noise = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    got = tvae.vae_encode(cfg, tp, torch.from_numpy(img),
                          noise=torch.from_numpy(noise))
    _close(got, want, rel=1e-5)
    gen = torch.Generator().manual_seed(1)
    drawn = tvae.vae_encode(cfg, tp, torch.from_numpy(img), generator=gen)
    assert drawn.shape == got.shape and not torch.equal(drawn, got)


# -- the UNet -----------------------------------------------------------------

def _unet_configs():
    sd1 = jsd.tiny_sd_config().unet
    sd2 = dataclasses.replace(sd1, attn_levels=(0, 1), num_heads=(2, 4),
                              context_dim=48)
    sdxl = dataclasses.replace(sd1, num_heads=(2, 4), context_dim=40,
                               transformer_depth=(1, 2),
                               addition_embed_dim=16 + 6 * 8,
                               addition_time_embed_dim=8)
    return {"sd1": sd1, "sd2": sd2, "sdxl": sdxl}


def _unet_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([0.999, 0.25], np.float32)
    ctx = rng.standard_normal((2, 7, cfg.context_dim)).astype(np.float32)
    added = (rng.standard_normal((2, cfg.addition_embed_dim))
             .astype(np.float32) if cfg.addition_embed_dim else None)
    return x, t, ctx, added


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["sd1", "sd2", "sdxl"])
def test_unet_matches_reference(kind, dtype):
    cfg = _unet_configs()[kind]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    params = jsd.init_unet_params(cfg, jax.random.PRNGKey(3), jdt)
    ported = sd_params_from_numpy({"unet": _np(params), "vae": {}}, "cpu",
                                  tdt)["unet"]
    x, t, ctx, added = _unet_inputs(cfg)
    want = jax.jit(functools.partial(jsd.unet_forward, cfg))(
        params, jnp.asarray(x, jdt), t, jnp.asarray(ctx, jdt),
        None if added is None else jnp.asarray(added, jdt))
    got = tsd.unet_forward(cfg, ported, torch.from_numpy(x).to(tdt),
                           torch.from_numpy(t),
                           torch.from_numpy(ctx).to(tdt),
                           None if added is None
                           else torch.from_numpy(added).to(tdt))
    assert got.shape == x.shape and got.dtype == tdt
    if dtype == "f32":
        _close(got, want)
    else:
        want = _f32(want)
        top = float(np.abs(want).max())
        err = np.abs(_f32(got) - want)
        assert err.max() <= 5e-2 * top and err.mean() <= 1e-2 * top, \
            (err.max() / top, err.mean() / top)


def test_unet_without_structural_nones():
    """A mapped load's tree has no None entries: no "attn" at a level
    without cross-attention, no "down" / "up" at the ends."""
    cfg = _unet_configs()["sd1"]
    params = jsd.init_unet_params(cfg, jax.random.PRNGKey(4))
    ported = sd_params_from_numpy({"unet": _np(params), "vae": {}}, "cpu",
                                  torch.float32)["unet"]

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items()
                    if v is not None and not (isinstance(v, list)
                                              and all(e is None for e in v))}
        if isinstance(node, list):
            return [strip(v) for v in node]
        return node
    stripped = strip(ported)
    assert "attn" not in stripped["down"][0] and \
        "down" not in stripped["down"][-1] and "up" not in stripped["up"][-1]
    x, t, ctx, _ = _unet_inputs(cfg, 1)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert torch.equal(tsd.unet_forward(cfg, stripped, *args),
                       tsd.unet_forward(cfg, ported, *args))
    with pytest.raises(ValueError, match="an SD tree"):
        sd_params_from_numpy({"unet": {}}, "cpu")


def test_upsample_is_bit_equal_to_jax_nearest():
    x = np.random.default_rng(2).standard_normal((1, 3, 5, 7)) \
        .astype(np.float32)
    want = jax.image.resize(x, (1, 3, 10, 14), "nearest")
    got = torch.nn.functional.interpolate(torch.from_numpy(x),
                                          scale_factor=2, mode="nearest")
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- the pipelines ------------------------------------------------------------

class _Enc:
    """A text encoder returning fixed arrays per prompt (the same values
    into both packages): __call__ -> (hidden, pooled), encode3 -> (hidden,
    pooled, penultimate)."""

    def __init__(self, table, wrap):
        self.table, self.wrap = table, wrap

    def encode3(self, prompt):
        return tuple(self.wrap(a) for a in self.table[prompt])

    def __call__(self, prompt):
        return self.encode3(prompt)[:2]


def _table(prompts, seq, width, pooled, seed):
    rng = np.random.default_rng(seed)
    return {p: (rng.standard_normal((1, seq, width)).astype(np.float32),
                rng.standard_normal((1, pooled)).astype(np.float32),
                rng.standard_normal((1, seq, width)).astype(np.float32))
            for p in prompts}


def _pair(kind, prompts, seed=0):
    """(reference model, port model) with the same parameters and text."""
    base = jsd.tiny_sd_config()
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    if kind == "sdxl":
        unet = dataclasses.replace(_unet_configs()["sdxl"])
        cfg = dataclasses.replace(base, unet=unet)
    elif kind == "sd2":
        cfg = dataclasses.replace(base, unet=_unet_configs()["sd2"],
                                  prediction_type="v_prediction")
    else:
        cfg = base
    params = {"unet": jsd.init_unet_params(cfg.unet, k1),
              "vae": jvae.init_vae_decoder_params(cfg.vae, k2),
              "vae_enc": jvae.init_vae_encoder_params(cfg.vae, k3)}
    ported = sd_params_from_numpy(_np(params), "cpu", torch.float32)
    if kind == "sdxl":
        t1 = _table(prompts, 7, 16, 16, seed + 1)
        t2 = _table(prompts, 7, 24, 16, seed + 2)
        ref = jsd.SDXLImageModel(cfg, params, _Enc(t1, jnp.asarray),
                                 _Enc(t2, jnp.asarray))
        port = tsd.SDXLImageModel(cfg, ported, _Enc(t1, torch.from_numpy),
                                  _Enc(t2, torch.from_numpy), device="cpu")
    else:
        t1 = _table(prompts, 7, cfg.unet.context_dim, 1, seed + 1)
        ref = jsd.SDImageModel(cfg, params, _Enc(t1, jnp.asarray))
        port = tsd.SDImageModel(cfg, ported, _Enc(t1, torch.from_numpy),
                                device="cpu")
    return cfg, ref, port


def _noise(cfg, width, height, seed):
    lh, lw = tsd.latent_size(cfg, width, height)
    return torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), (1, cfg.vae.latent_channels, lh, lw),
        jnp.float32)))


def _pixels_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, \
        (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("kind,width,height,steps", [
    ("sd1", 32, 24, 3), ("sd2", 24, 32, 2)])
def test_txt2img_matches_reference(kind, width, height, steps):
    cfg, ref, port = _pair(kind, ("a fox", "blurry"), seed=len(kind))
    want = ref.generate_image("a fox", width, height, steps, guidance=5.0,
                              seed=3, negative_prompt="blurry")
    got = port.generate_image("a fox", width, height, steps, guidance=5.0,
                              negative_prompt="blurry",
                              noise=_noise(cfg, width, height, 3))
    assert got.size == want.size == (width, height)
    _pixels_close(got, want)
    assert set(port.stats) == {"encode_s", "denoise_s", "steps", "decode_s"}


def _rgba_png(h, w, seed) -> tuple[bytes, np.ndarray]:
    rgba = np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                                dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, "PNG", optimize=True)
    return buf.getvalue(), rgba


def test_img2img_matches_reference():
    """An RGBA PNG through Pillow (the reference's convert and resize)
    and through utils/png (the port's), encoded, noised at the strength's
    step and denoised."""
    cfg, ref, port = _pair("sd1", ("a fox", ""), seed=2)
    png, _ = _rgba_png(37, 29, 4)
    want_z = ref.init_latent_from(Image.open(io.BytesIO(png)), 32, 32)
    got_z = port.init_latent_from(decode_png(png), 32, 32)
    _close(got_z, want_z, rel=1e-5)
    want = ref.generate_image("a fox", 32, 32, 5, seed=8, init_image=want_z,
                              strength=0.6)
    got = port.generate_image("a fox", 32, 32, 5, init_image=got_z,
                              strength=0.6, noise=_noise(cfg, 32, 32, 8))
    _pixels_close(got, want)
    assert port.stats["steps"] == 3             # ts[int(5 * 0.4):]
    with pytest.raises(ValueError, match="at least 16x16"):
        port.init_latent_from(np.zeros((8, 8, 3), np.uint8), 8, 8)
    del port.params["vae_enc"]
    with pytest.raises(ValueError, match="no VAE encoder"):
        port.init_latent_from(decode_png(png), 32, 32)


@pytest.mark.parametrize("negative", ["", "ugly"])
def test_sdxl_matches_reference(negative):
    """The empty negative prompt conditions on zeros (force_zeros), a
    given one through both encoders; the time ids' sinusoids at scale 1."""
    cfg, ref, port = _pair("sdxl", ("a fox", "ugly", ""), seed=5)
    want = ref.generate_image("a fox", 32, 24, 2, seed=4,
                              negative_prompt=negative)
    got = port.generate_image("a fox", 32, 24, 2, negative_prompt=negative,
                              noise=_noise(cfg, 32, 24, 4))
    _pixels_close(got, want)
    ctx, added = port._encode_prompt("a fox", negative, 32, 24)
    assert ctx.shape == (2, 7, 40) and added.shape == (2, 16 + 48)
    assert bool((ctx[0] == 0).all()) == (negative == "")


def test_intermediate_images_match_reference(tmp_path, monkeypatch):
    cfg, ref, port = _pair("sd1", ("a fox", ""), seed=6)
    want, got = [], []
    ref.generate_image("a fox", 16, 16, 5, seed=1, intermediate_every=2,
                       on_image=lambda i, im: want.append((i, im)))
    port.generate_image("a fox", 16, 16, 5, intermediate_every=2,
                        on_image=lambda i, im: got.append((i, im)),
                        noise=_noise(cfg, 16, 16, 1))
    assert [i for i, _ in got] == [i for i, _ in want] == [2, 4]
    for (_, g), (_, w) in zip(got, want):
        _pixels_close(g, w)
    monkeypatch.chdir(tmp_path)
    port.generate_image("a fox", 16, 16, 3, intermediate_every=1, seed=2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["sd_intermediate_1.png", "sd_intermediate_2.png"]
    assert decode_png((tmp_path / names[0]).read_bytes()).shape == \
        (16, 16, 3)


def test_trace_dir_writes_a_chrome_trace(tmp_path):
    _, _, port = _pair("sd1", ("a fox", ""), seed=7)
    port.generate_image("a fox", 16, 16, 1, seed=1,
                        trace_dir=str(tmp_path / "trace"))
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::convolution")
               for e in events)


def test_seeded_demo_is_deterministic_and_sizes_are_checked():
    model = tsd.SDImageModel(tsd.tiny_sd_config(), device="cpu", seed=3)
    a = np.asarray(model.generate_image("same", 16, 16, 2, seed=4))
    b = np.asarray(model.generate_image("same", 16, 16, 2, seed=4))
    c = np.asarray(model.generate_image("same", 16, 16, 2, seed=5))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    with pytest.raises(ValueError, match="must divide by 2"):
        model.generate_image("x", 18, 16, 1)
