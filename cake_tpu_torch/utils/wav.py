"""16-bit PCM WAV encoding and a minimal reader (counterpart of
cake_tpu/utils/wav.py: f32_to_pcm16, encode_wav, decode_wav)."""
from __future__ import annotations

import io
import struct

import numpy as np


def f32_to_pcm16(samples: np.ndarray) -> bytes:
    """f32 samples clipped to [-1, 1], times 32767, truncated to int16
    little-endian."""
    s = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    return (s * 32767.0).astype("<i2").tobytes()


def encode_wav(samples: np.ndarray, sample_rate: int = 24000) -> bytes:
    """Mono f32 [-1, 1] samples -> RIFF/WAVE bytes (PCM, 16 bits)."""
    pcm = f32_to_pcm16(samples)
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(pcm)))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                          sample_rate * 2, 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(pcm)))
    buf.write(pcm)
    return buf.getvalue()


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """RIFF bytes -> (f32 mono samples, sample_rate): 16-bit PCM, channels
    averaged; chunks other than `fmt ` and `data` are skipped."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAV file")
    pos = 12
    pcm = None
    rate = 24000
    channels = 1
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            channels, rate = fmt[1], fmt[2]
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if pcm is None:
        raise ValueError("no data chunk")
    samples = np.frombuffer(pcm, "<i2").astype(np.float32) / 32767.0
    if channels > 1:
        samples = samples.reshape(-1, channels).mean(axis=1)
    return samples, rate
