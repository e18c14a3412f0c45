"""The image encoders' tokenizers, read by the port's one tokenizer.json
reader (utils/bpe.py), against the `tokenizers` library on files the
tests write: the word-level files
of the synthesized FLUX.1 bundles, a CLIP-style BPE (NFC, whitespace
folding and lowercase, CLIP's split regex kept by an inverted Removed
split, byte-level without its regex, `</w>` word suffix, merges learned
here, cls/sep around the ids) and a T5-style Unigram (NFKC, whitespace
split, Metaspace, `</s>` appended, unknown runs fused). Ids equal on fixed
texts and under hypothesis; then the reference's `_ids` padding and
truncation (the end token kept on a cut) equal the port's, decoding the
ids equals the library's (no decoder, BPEDecoder, Metaspace), and what
the reader does not implement (SentencePiece's Precompiled charsmap)
raises."""
import collections
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer

from cake_tpu.models.image.flux_loader import \
    Flux1TextEncoder as JaxTextEncoder
from cake_tpu_torch.models.image.flux_loader import Flux1TextEncoder
from cake_tpu_torch.utils.bpe import (JsonTokenizer, UnsupportedTokenizer,
                                      bytes_to_unicode, word_level_spec)

CORPUS = ("a photograph of an astronaut riding a horse on the moon, "
          "watercolor painting of a red fox in the snow at sunset; "
          "It's 4K, HDR and ultra-detailed! The fox's eyes glow. "
          "Café crème, naïve façade, Übermensch, 東京タワー, дом и сад. "
          "two cats and three dogs 12345 67890 ") * 3
TEXTS = ["a watercolor fox", "", "   ",
         "A PHOTOGRAPH  of\tan ASTRONAUT", "It's the fox's den, isn't it?",
         "HDR 4K 2048x2048 -- ultra!!", "Café   crème naïve",
         "東京タワー at night", "дом и сад", "w1 w2 w3",
         "emoji 🦊🎨 and symbols © ™ ≈", "foxes foxing unfoxed",
         "zzzqqq xylophone", "a" * 50, "tab\there\nnewline", "mixedCASEword"]
CLIP_SPLIT = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
              r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")


def _pair(spec):
    return JsonTokenizer(spec), Tokenizer.from_str(json.dumps(spec))


def _same(port, lib, text):
    assert port.encode(text) == lib.encode(text).ids, text
    assert port.encode(text, add_special_tokens=False) == \
        lib.encode(text, add_special_tokens=False).ids, text


def test_word_level_matches_library():
    port, lib = _pair(word_level_spec(96))
    for text in TEXTS + ["w0 w93 w94 <unk> <eot> w95", "w12,w13.w14"]:
        _same(port, lib, text)


def _clip_spec(n_merges=300):
    b2u = bytes_to_unicode()
    import re
    from cake_tpu_torch.utils.bpe import translate_regex
    rx = re.compile(translate_regex(CLIP_SPLIT))
    text = re.sub(r"\s+", " ", CORPUS).lower()
    words = collections.Counter(
        tuple("".join(b2u[b] for b in w.encode()))
        for w in rx.findall(text))
    seqs = {w[:-1] + (w[-1] + "</w>",): n for w, n in words.items()}
    vocab = {}
    for c in b2u.values():
        vocab.setdefault(c, len(vocab))
    for c in b2u.values():
        vocab.setdefault(c + "</w>", len(vocab))
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for seq, n in seqs.items():
            for a, b in zip(seq, seq[1:]):
                pairs[(a, b)] += n
        if not pairs:
            break
        best = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(f"{best[0]} {best[1]}")
        vocab.setdefault(best[0] + best[1], len(vocab))
        new = {}
        for seq, n in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and (seq[i], seq[i + 1]) == best:
                    out.append(seq[i] + seq[i + 1])
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            new[tuple(out)] = new.get(tuple(out), 0) + n
        seqs = new
    sot, eot = len(vocab), len(vocab) + 1
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = sot, eot
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for c, i in (("<|startoftext|>", sot), ("<|endoftext|>", eot))]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFC"},
            {"type": "Replace", "pattern": {"Regex": r"\s+"},
             "content": " "},
            {"type": "Lowercase"}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": CLIP_SPLIT},
             "behavior": "Removed", "invert": True},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "RobertaProcessing",
                           "sep": ["<|endoftext|>", eot],
                           "cls": ["<|startoftext|>", sot],
                           "trim_offsets": False, "add_prefix_space": False},
        "decoder": {"type": "BPEDecoder", "suffix": "</w>"},
        "model": {"type": "BPE", "dropout": None,
                  "unk_token": "<|endoftext|>",
                  "continuing_subword_prefix": "",
                  "end_of_word_suffix": "</w>", "fuse_unk": False,
                  "byte_fallback": False, "vocab": vocab,
                  "merges": merges}}


CLIP = _pair(_clip_spec())


def test_clip_bpe_matches_library():
    port, lib = CLIP
    for text in TEXTS + ["<|startoftext|>a fox<|endoftext|> more"]:
        _same(port, lib, text)


@settings(max_examples=150, deadline=None)
@given(st.text(alphabet=st.sampled_from(list(
    "abcfoxwtrsEXRT '’!?,.-0123 \t\nçé東дс🦊")), max_size=40))
def test_clip_bpe_matches_library_on_generated_text(text):
    _same(*CLIP, text)


def _unigram_spec():
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.0)]
    words = sorted(set(CORPUS.split()))
    for i, w in enumerate(words[:60]):
        pieces.append(("▁" + w.strip(".,;!"), -5.0 - (i % 7) * 0.5))
    for i, ch in enumerate(sorted(set(CORPUS) - {" "})):
        pieces.append((ch, -8.0 - (i % 5)))
    for i, sub in enumerate(("fo", "ox", "▁fo", "at", "▁a", "er", "es",
                             "ing", "▁th", "he", "ca", "ts", "▁t")):
        pieces.append((sub, -4.0 - i * 0.25))
    seen, vocab = set(), []
    for p, s in pieces:
        if p not in seen:
            seen.add(p)
            vocab.append([p, s])
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, c in enumerate(("<pad>", "</s>", "<unk>"))]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "NFKC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"},
            {"type": "Metaspace", "replacement": "▁",
             "prepend_scheme": "always", "split": True}]},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                        "tokens": ["</s>"]}}},
        "decoder": {"type": "Metaspace", "replacement": "▁",
                    "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab,
                  "byte_fallback": False}}


UNIGRAM = _pair(_unigram_spec())


def test_unigram_matches_library():
    port, lib = UNIGRAM
    for text in TEXTS + ["</s> fox <pad>", "ｆｕｌｌｗｉｄｔｈ ① fox"]:
        _same(port, lib, text)


@settings(max_examples=150, deadline=None)
@given(st.text(alphabet=st.sampled_from(list(
    "abcfoxwtrshingEXRT '!?,.-0123 \t\nçé東дс🦊▁")), max_size=40))
def test_unigram_matches_library_on_generated_text(text):
    _same(*UNIGRAM, text)


@pytest.mark.parametrize("kind", ["word_level", "clip", "unigram"])
def test_decode_matches_library(kind):
    port, lib = {"word_level": _pair(word_level_spec(96)), "clip": CLIP,
                 "unigram": UNIGRAM}[kind]
    for text in TEXTS + ["w3 w7 <unk> zz", "</s> fox <pad>",
                         "<|startoftext|>a fox<|endoftext|>"]:
        ids = lib.encode(text).ids
        assert port.decode(ids) == lib.decode(
            ids, skip_special_tokens=False), text
    n = lib.get_vocab_size()
    odd = [n + 3, 0, 2, 1, n - 1, 10 ** 6, 5]
    assert port.decode(odd) == lib.decode(odd, skip_special_tokens=False)


@pytest.mark.parametrize("text", ["a watercolor fox", "w1 " * 40, ""])
def test_ids_pad_and_truncate_like_the_reference(text):
    port, lib = CLIP
    for length, pad, end in ((77, 49407, 49407), (8, 0, 1), (4, 5, None)):
        want = JaxTextEncoder._ids(None, lib, text, length, pad, end)
        got = Flux1TextEncoder._ids(port, text, length, pad, end)
        assert got.dtype == want.dtype and (got == want).all()


def test_what_is_not_read_raises():
    spec = _unigram_spec()
    for field, value in (
            ("normalizer", {"type": "Precompiled",
                            "precompiled_charsmap": "AAAA"}),
            ("pre_tokenizer", {"type": "Digits"}),
            ("post_processor", {"type": "Nope"}),
            ("truncation", {"max_length": 8})):
        with pytest.raises(UnsupportedTokenizer):
            JsonTokenizer(dict(spec, **{field: value}))
    with pytest.raises(UnsupportedTokenizer, match="Precompiled"):
        JsonTokenizer(dict(spec, normalizer={"type": "Sequence",
                                             "normalizers": [
                                                 {"type": "Precompiled"}]}))
    with pytest.raises(UnsupportedTokenizer, match="model type"):
        JsonTokenizer(dict(spec, model={"type": "WordPiece"}))
