"""The audio stack's operations against the JAX package on the CPU, in
float32: conv1d (groups, stride, padding, dilation), conv_transpose1d
(torch's convention, `padding` cropped), depthwise_conv1d and
rms_norm_channel within 1e-5 relative (or 1e-5 of the largest magnitude
near zero); and utils/wav.py byte for byte: f32_to_pcm16 and encode_wav,
and decode_wav of mono, stereo and odd-sized chunks, refusing what the
reference refuses."""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.ops import conv as jconv
from cake_tpu.ops import norms as jnorms
from cake_tpu.utils import wav as jwav
from cake_tpu_torch.ops import conv as tconv
from cake_tpu_torch.ops import norms as tnorms
from cake_tpu_torch.utils import wav as twav

torch.set_num_threads(1)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cin,cout,k,stride,padding,dilation,groups", [
    (4, 6, 7, 1, 0, 1, 1), (4, 8, 3, 2, 1, 1, 2), (6, 6, 7, 1, 3, 1, 6),
    (3, 5, 4, 3, 2, 2, 1), (8, 4, 10, 5, 0, 1, 4)])
def test_conv1d_matches_reference(cin, cout, k, stride, padding, dilation,
                                  groups):
    x = _rand((2, cin, 37), 1)
    w = _rand((cout, cin // groups, k), 2)
    b = _rand((cout,), 3)
    want = jconv.conv1d(x, w, b, stride, padding, dilation, groups)
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), stride, padding, dilation, groups)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("cin,cout,k,stride,padding", [
    (8, 4, 16, 8, 0), (4, 4, 10, 5, 0), (6, 3, 4, 2, 1), (2, 5, 3, 1, 1),
    (4, 2, 8, 4, 3)])
def test_conv_transpose1d_matches_reference(cin, cout, k, stride, padding):
    x = _rand((1, cin, 9), 4)
    w = _rand((cin, cout, k), 5)
    b = _rand((cout,), 6)
    want = jconv.conv_transpose1d(x, w, b, stride, padding)
    got = tconv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), stride, padding)
    assert got.shape == want.shape == (1, cout, (9 - 1) * stride + k
                                       - 2 * padding)
    _close(got, want)


@pytest.mark.parametrize("padding", [0, 3, 6])
def test_depthwise_conv1d_matches_reference(padding):
    x, w, b = _rand((2, 5, 20), 7), _rand((5, 1, 7), 8), _rand((5,), 9)
    want = jconv.depthwise_conv1d(x, w, b, padding)
    got = tconv.depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), padding)
    _close(got, want)


@pytest.mark.parametrize("axis,dtype", [(1, "f32"), (2, "f32"),
                                        (1, "bf16")])
def test_rms_norm_channel_matches_reference(axis, dtype):
    x, w = _rand((2, 6, 11), 10), _rand((6 if axis == 1 else 11,), 11)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jnorms.rms_norm_channel(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                   1e-6, axis)
    got = tnorms.rms_norm_channel(torch.from_numpy(x).to(tdt),
                                  torch.from_numpy(w).to(tdt), 1e-6, axis)
    assert got.dtype == tdt
    if dtype == "f32":
        _close(got, want)
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("n,rate", [(0, 24000), (1, 24000), (480, 16000),
                                    (4801, 48000)])
def test_wav_encoding_is_byte_identical(n, rate):
    samples = np.sin(np.linspace(0, 30, n)).astype(np.float32) * 1.5
    assert twav.f32_to_pcm16(samples) == jwav.f32_to_pcm16(samples)
    wav = twav.encode_wav(samples, rate)
    assert wav == jwav.encode_wav(samples, rate)
    ours, theirs = twav.decode_wav(wav), jwav.decode_wav(wav)
    assert ours[1] == theirs[1] == rate
    assert np.array_equal(ours[0], theirs[0])


def _chunked(pcm: bytes, channels: int, extra: bytes = b"") -> bytes:
    fmt = struct.pack("<HHIIHH", 1, channels, 22050, 22050 * 2 * channels,
                      2 * channels, 16)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + extra + \
        b"data" + struct.pack("<I", len(pcm)) + pcm
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("channels,extra", [
    (1, b""), (2, b""), (1, b"LIST" + struct.pack("<I", 3) + b"abc\x00")])
def test_wav_decoding_matches_reference(channels, extra):
    pcm = (np.arange(12 * channels, dtype="<i2") * 997).tobytes()
    data = _chunked(pcm, channels, extra)
    ours, theirs = twav.decode_wav(data), jwav.decode_wav(data)
    assert ours[1] == theirs[1] == 22050
    assert np.array_equal(ours[0], theirs[0]) and len(ours[0]) == 12


@pytest.mark.parametrize("data", [b"", b"RIFF0000WAVX", b"NOPE" * 4,
                                  _chunked(b"", 1)[:20]])
def test_wav_refusals_match_reference(data):
    """A truncated `fmt ` chunk is struct.error in both, the rest
    ValueError."""
    with pytest.raises((ValueError, struct.error)) as ours:
        twav.decode_wav(data)
    with pytest.raises((ValueError, struct.error)) as theirs:
        jwav.decode_wav(data)
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)
