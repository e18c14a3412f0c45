"""What SD reads from its users without Pillow or `transformers` on the
card's machine, against those libraries here, under hypothesis:
  * utils/bpe.load_tokenizer on a CLIP vocab.json + merges.txt directory
    (SD1.5's tokenizer_config.json, and SDXL's second with pad "!")
    gives the ids of transformers.AutoTokenizer on every case;
  * utils/png.decode_png reads 8-bit grey, grey + alpha, RGB, RGBA and
    palette PNGs with every row filter as Pillow's `convert("RGB")` does,
    pixel for pixel, and refuses 16-bit and interlaced PNGs, JPEG and
    broken files with a ValueError naming what is not read;
  * utils/png.resize_bicubic equals Pillow's default resize byte for
    byte (tolerance 0: the same fixed-point arithmetic)."""
import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from cake_tpu_torch.bench import synth_sd as ss
from cake_tpu_torch.utils.bpe import load_tokenizer
from cake_tpu_torch.utils.png import (SIGNATURE, decode_png, encode_png,
                                      resize_bicubic)

torch.set_num_threads(1)
ALPHABET = ("abcdefghijklmnopqrstuvwxyz" "ABCXYZ" "  \t\n" "!!??.,'-"
            "0123456789" "éÀΩß" "ﬁ" "😀")
SPECIALS = ("<|startoftext|>", "<|endoftext|>", "<|ENDOFTEXT|>", "'s", "'ll")


@pytest.fixture(scope="module", params=["<|endoftext|>", "!"])
def tokenizers(request, tmp_path_factory):
    from transformers import AutoTokenizer
    d = tmp_path_factory.mktemp("tok")
    vocab, merges = ss.clip_vocab_merges(3000, seed=1)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(merges)
    (d / "tokenizer_config.json").write_text(
        json.dumps(ss.tokenizer_config(request.param)))
    return AutoTokenizer.from_pretrained(str(d)), load_tokenizer(str(d))


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.one_of(st.text(ALPHABET, max_size=12),
                          st.sampled_from(SPECIALS)), max_size=8))
def test_clip_vocab_merges_equals_autotokenizer(tokenizers, parts):
    ref, port = tokenizers
    text = "".join(parts)
    assert port.encode(text) == ref(text)["input_ids"], text


def test_merges_past_clips_limit_and_other_classes(tmp_path):
    """The slow tokenizer keeps merges.txt's lines 1..48894; a vocab of
    another class is refused by name."""
    from transformers import AutoTokenizer
    vocab, merges = ss.clip_vocab_merges(49408 + 30, seed=2)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(merges)
    (tmp_path / "tokenizer_config.json").write_text(
        json.dumps(ss.tokenizer_config("<|endoftext|>")))
    ref = AutoTokenizer.from_pretrained(str(tmp_path))
    port = load_tokenizer(str(tmp_path))
    assert len(port.model.merges) == 48894
    last = merges.strip().split("\n")[-1].replace(" ", "")
    for text in ("a lighthouse at dusk", last.replace("</w>", ""),
                 "zzzz qqq xyzzy"):
        assert port.encode(text) == ref(text)["input_ids"]
    (tmp_path / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "GPT2Tokenizer"}))
    with pytest.raises(ValueError, match="GPT2Tokenizer"):
        load_tokenizer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_tokenizer(str(tmp_path / "none"))


# -- PNG ------------------------------------------------------------------------

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(pix: np.ndarray, kinds: list[int]) -> bytes:
    """PNG row filtering with a chosen filter per row (Pillow chooses its
    own, so every filter is written here)."""
    h, w, bpp = pix.shape
    raw = pix.reshape(h, w * bpp).astype(int)
    out = bytearray()
    for y in range(h):
        row, prior = raw[y], raw[y - 1] if y else np.zeros(w * bpp, int)
        k = kinds[y % len(kinds)]
        out.append(k)
        for i in range(w * bpp):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[k]
            out.append((row[i] - pred) % 256)
    return bytes(out)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png(pix, color, kinds, palette=None, depth=8, interlace=0) -> bytes:
    h, w, _ = pix.shape
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    data = zlib.compress(_filter_rows(pix, kinds))
    # the data in two IDAT chunks, as large encoders split it
    out += _chunk(b"IDAT", data[:len(data) // 2]) \
        + _chunk(b"IDAT", data[len(data) // 2:])
    return out + _chunk(b"IEND", b"")


@settings(max_examples=80, deadline=None)
@given(st.sampled_from(sorted(CHANNELS)), st.integers(1, 9),
       st.integers(1, 9),
       st.lists(st.integers(0, 4), min_size=1, max_size=5),
       st.integers(0, 2 ** 31))
def test_decode_png_equals_pillow(color, h, w, kinds, seed):
    rng = np.random.default_rng(seed)
    palette = None
    if color == 3:
        palette = rng.integers(0, 256, (rng.integers(1, 20), 3),
                               dtype=np.uint8)
        pix = rng.integers(0, len(palette), (h, w, 1), dtype=np.uint8)
    else:
        pix = rng.integers(0, 256, (h, w, CHANNELS[color]), dtype=np.uint8)
    data = _png(pix, color, kinds, palette)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = decode_png(data)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_decode_png_refuses_what_it_does_not_read():
    pix = np.zeros((4, 4, 3), np.uint8)
    good = encode_png(pix)
    assert np.array_equal(decode_png(good), pix)
    for data, match in (
            (_png(pix, 2, [0], interlace=1), "interlaced"),
            (_png(np.zeros((4, 4, 6), np.uint8), 2, [0], depth=16),
             "16-bit"),
            (b"\xff\xd8\xff\xe0" + b"\0" * 20, "JPEG"),
            (b"RIFF\0\0\0\0WEBPVP8 ", "WebP"),
            (b"GIF89a", "not a PNG"),
            (good[:-20], "truncated|corrupt|CRC"),
            (good[:30] + b"x" + good[31:], "CRC")):
        with pytest.raises(ValueError, match=match):
            decode_png(data)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="16-bit.*ROADMAP"):
        decode_png(buf.getvalue())


@settings(max_examples=120, deadline=None)
@given(st.integers(1, 48), st.integers(1, 48), st.integers(1, 64),
       st.integers(1, 64), st.integers(0, 2 ** 31))
def test_resize_equals_pillow(h, w, height, width, seed):
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if seed % 2:                   # smooth images as well as noise
        pix = np.sort(pix, axis=int(seed % 4 > 1))
    want = np.asarray(Image.fromarray(pix).resize((width, height)))
    assert np.array_equal(resize_bicubic(pix, width, height), want)
