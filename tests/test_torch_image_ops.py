"""Module 14a's ops against the JAX package on the same seeded numpy
inputs, on the CPU: conv2d (strides, asymmetric padding, dilation,
groups), group_norm, layer_norm, adaln_modulate (float32 within 1e-5
relative; bfloat16 within the golden bar of 2e-2 absolute), the
flow-matching schedule (exactly), the Euler step and CFG combine, the
2x2 patch packing both ways, and the port's PNG encoder and decoder
against Pillow."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.image import vae as jvae
from cake_tpu.ops import activations as jact
from cake_tpu.ops import conv as jconv
from cake_tpu.ops import diffusion as jdiff
from cake_tpu.ops import norms as jnorms
from cake_tpu_torch.models.image import vae as tvae
from cake_tpu_torch.ops import activations as tact
from cake_tpu_torch.ops import conv as tconv
from cake_tpu_torch.ops import diffusion as tdiff
from cake_tpu_torch.ops import norms as tnorms
from cake_tpu_torch.utils.png import RgbImage, decode_png, encode_png

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = 2e-2


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 0, 1, 1), (1, 1, 1, 1), (2, 1, 1, 1), (2, [(0, 1), (0, 1)], 1, 1),
    (1, 2, 2, 1), (1, 1, 1, 2)])
def test_conv2d_matches_reference(stride, padding, dilation, groups):
    rng = np.random.default_rng(stride * 10 + dilation + groups)
    x = _rand(rng, 2, 4, 9, 7)
    w = _rand(rng, 6, 4 // groups, 3, 3)
    b = _rand(rng, 6)
    want = jconv.conv2d(x, w, b, stride=stride, padding=padding,
                        dilation=dilation, groups=groups)
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), stride=stride, padding=padding,
                       dilation=dilation, groups=groups)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_conv2d_bf16_and_no_bias():
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 1, 8, 6, 6), _rand(rng, 8, 8, 1, 1)
    want = jconv.conv2d(_jax_bf16(x), _jax_bf16(w))
    got = tconv.conv2d(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_and_modulation_match_reference(dtype):
    rng = np.random.default_rng(5)
    x4 = _rand(rng, 2, 64, 5, 3) * 3 + 1
    g, bb = _rand(rng, 64), _rand(rng, 64)
    x3, w, b = _rand(rng, 2, 7, 48) * 2, _rand(rng, 48), _rand(rng, 48)
    shift, scale = _rand(rng, 2, 1, 48), _rand(rng, 2, 1, 48)
    if dtype == "f32":
        jx, tx = (lambda a: a), torch.from_numpy
        tol = F32
    else:
        jx, tx = _jax_bf16, (lambda a: torch.from_numpy(a).bfloat16())
        tol = dict(rtol=0, atol=BF16_TOL)
    pairs = [
        (jnorms.group_norm(jx(x4), jx(g), jx(bb), 32),
         tnorms.group_norm(tx(x4), tx(g), tx(bb), 32)),
        (jnorms.group_norm(jx(x4), jx(g), None, 16),
         tnorms.group_norm(tx(x4), tx(g), None, 16)),
        (jnorms.layer_norm(jx(x3), jx(w), jx(b)),
         tnorms.layer_norm(tx(x3), tx(w), tx(b))),
        (jnorms.layer_norm(jx(x3), jx(w), None, eps=1e-6),
         tnorms.layer_norm(tx(x3), tx(w), None, eps=1e-6)),
        (jact.adaln_modulate(jx(x3), jx(shift), jx(scale)),
         tact.adaln_modulate(tx(x3), tx(shift), tx(scale))),
    ]
    for want, got in pairs:
        assert got.dtype == (torch.float32 if dtype == "f32"
                             else torch.bfloat16)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("steps,mu", [(1, 1.15), (4, 1.15), (20, 1.15),
                                      (28, None), (50, 0.5)])
def test_flow_matching_schedule_is_exact(steps, mu):
    want = jdiff.flow_matching_schedule(steps, mu)
    got = tdiff.flow_matching_schedule(steps, mu)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    t = np.linspace(0.1, 1.0, 7)
    assert np.array_equal(tdiff.flux_time_shift(t, 1.15, 1.3),
                          jdiff.flux_time_shift(t, 1.15, 1.3))


def test_euler_step_and_cfg_keep_dtype_and_values():
    rng = np.random.default_rng(9)
    x, v = _rand(rng, 1, 16, 8), _rand(rng, 1, 16, 8)
    ts = tdiff.flow_matching_schedule(4, 1.15)
    for dt, jx, tx in ((torch.float32, lambda a: a, torch.from_numpy),
                       (torch.bfloat16, _jax_bf16,
                        lambda a: torch.from_numpy(a).bfloat16())):
        got = tdiff.flow_matching_euler_step(tx(x), tx(v), float(ts[1]),
                                             float(ts[2]))
        want = jdiff.flow_matching_euler_step(jx(x), jx(v), float(ts[1]),
                                              float(ts[2]))
        assert got.dtype == dt
        tol = F32 if dt == torch.float32 else dict(rtol=0, atol=BF16_TOL)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(
        _np(tdiff.cfg_combine(torch.from_numpy(x), torch.from_numpy(v), 3.5)),
        _np(jdiff.cfg_combine(x, v, 3.5)), **F32)


def test_patches_round_trip_and_match_reference():
    rng = np.random.default_rng(11)
    z = _rand(rng, 2, 4, 6, 10)
    want = np.asarray(jvae.latents_to_patches(z))
    got = tvae.latents_to_patches(torch.from_numpy(z))
    assert np.array_equal(got.numpy(), want)
    back = tvae.patches_to_latents(got, 6, 10)
    assert np.array_equal(back.numpy(), z)
    assert np.array_equal(np.asarray(jvae.patches_to_latents(want, 6, 10)),
                          back.numpy())


@pytest.mark.parametrize("h,w", [(1, 1), (7, 9), (32, 48)])
def test_png_matches_pillow(h, w):
    from PIL import Image
    pix = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
    data = encode_png(pix)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), pix)
    assert np.array_equal(decode_png(data), pix)
    img = RgbImage(pix)
    buf = io.BytesIO()
    img.save(buf)
    assert buf.getvalue() == data and img.size == (w, h)
    with pytest.raises(ValueError):
        decode_png(data[:-20])
    with pytest.raises(ValueError):
        encode_png(pix.astype(np.float32))
