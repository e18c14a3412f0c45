"""A tokenizer from a `tokenizer.json`, in pure Python (the port's
counterpart of the `tokenizers` library that cake_tpu/runtime.py and
cake_tpu/models/image/flux_loader.py call; the card's machine has no
`tokenizers`): the text models' byte-level BPE (GPT-2, Qwen, Llama 3,
o200k) and byte-fallback BPE converted from SentencePiece (Gemma), and
the image encoders' CLIP BPE, T5 Unigram and word-level files. One
pipeline, whose stages and model follow the file's contents.

What it reads, and nothing else (any other construct raises at load and
names its field):
  * model: BPE with `vocab`, `merges` as "a b" strings or ["a", "b"]
    pairs, `ignore_merges`, `unk_token` with or without `fuse_unk`,
    `byte_fallback` (a character with no piece becomes the `<0xNN>`
    tokens of its UTF-8 bytes), `continuing_subword_prefix` and
    `end_of_word_suffix` (CLIP's "" and "</w>"); no dropout. WordLevel
    (`vocab`, `unk_token`). Unigram (`vocab` [[piece, score]], `unk_id`;
    the library's Viterbi: the best total score, ties to the first path
    found, an unknown character scored min - 10 and runs of unknowns
    fused);
  * added_tokens: split out of the raw text before anything else,
    longest first at each position (the library's leftmost-longest
    match), or, `normalized` ones, out of each piece's normalized text;
    tokens without lstrip / rstrip / single_word. Their ids are
    the library's: the model's id, or the next one past the model's vocab
    (a file whose ids leave a gap is renumbered, with a warning, as the
    library renumbers it);
  * normalizer: none, NFC, NFKC, Lowercase, Replace (a string or a regex
    by a string), or a Sequence of them. SentencePiece's `Precompiled`
    charsmap (real T5 files carry one) is refused: no file to hold a
    reading of it against is in the repository;
  * pre_tokenizer: none (the text between added tokens is one word, as
    in Gemma's), ByteLevel (with or without its GPT-2 regex, with or
    without a prefix space), Split (a regex or a string, Isolated or
    Removed, inverted or not), Whitespace, WhitespaceSplit, Metaspace
    (prepend "always" or "never", split), or a Sequence of them;
  * post_processor: ByteLevel (ids unchanged), TemplateProcessing (a
    single sequence between special tokens, as Llama 3's BOS or T5's
    `</s>`) or RobertaProcessing (cls ... sep), or a Sequence of them;
  * decoder: none (the tokens joined by spaces, as the library joins
    them), ByteLevel, BPEDecoder (the word suffix becomes a space),
    Metaspace, or a Sequence of Replace (a string or a regex by a
    string), ByteFallback (a run of `<0xNN>` tokens becomes its UTF-8
    text, or one U+FFFD per byte when the run is not valid UTF-8) and
    Fuse;
  * `truncation` and `padding` null.

A directory with no tokenizer.json but a CLIP `vocab.json` + `merges.txt`
(what released SD and SDXL repositories ship) is read as
`transformers.AutoTokenizer` reads it (`load_tokenizer`, `clip_spec`):
the slow CLIPTokenizer's reading of the files, converted to the fast
pipeline as the library's CLIPConverter converts it.

The library's patterns are Oniguruma regexes. Stdlib `re` lacks
`\\p{..}` classes and reads `\\s` and `\\w` differently, so `translate_regex`
rewrites those escapes into explicit code-point ranges built from
`unicodedata`; possessive quantifiers, atomic groups and scoped flags
`(?i:..)` are `re` syntax since Python 3.11.

Encoding a BPE word applies merges by rank with a heap, the library's
algorithm (lowest rank first, leftmost among equals, stale entries
skipped); every model's words go through a per-word cache.
`decode(ids)` equals the library's `decode(ids, skip_special_tokens=False)`:
ids with no token are dropped; through the ByteLevel decoder a token
whose characters are not all byte-level characters contributes its own
UTF-8, and invalid UTF-8 becomes U+FFFD.
"""
from __future__ import annotations

import functools
import heapq
import json
import logging
import os
import re
import sys
import unicodedata

log = logging.getLogger(__name__)

MAX_CODE_POINT = sys.maxunicode
WORD_CACHE = 10000   # words kept by the per-word cache
UNK_PENALTY = 10.0   # the library's K_UNK_PENALTY (Unigram)

# Unicode White_Space (Oniguruma's \s); str.isspace adds U+001C-001F
WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
               (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
               (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))

GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


class UnsupportedTokenizer(ValueError):
    """A tokenizer.json construct this module does not implement."""


# -- bytes <-> byte-level characters ------------------------------------------


@functools.cache
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of the 256 byte values onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.cache
def unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


# -- Oniguruma classes -> stdlib re -------------------------------------------


@functools.cache
def _categories() -> dict[str, tuple[tuple[int, int], ...]]:
    """General category -> its code-point ranges, from one scan."""
    out: dict[str, list[tuple[int, int]]] = {}
    start, cur = 0, unicodedata.category(chr(0))
    for cp in range(1, MAX_CODE_POINT + 1):
        cat = unicodedata.category(chr(cp))
        if cat != cur:
            out.setdefault(cur, []).append((start, cp - 1))
            start, cur = cp, cat
    out.setdefault(cur, []).append((start, MAX_CODE_POINT))
    return {k: tuple(v) for k, v in out.items()}


def _category_ranges(prefix: str) -> tuple[tuple[int, int], ...]:
    """Code-point ranges whose general category starts with `prefix` ("L",
    "Lu", "N", ...)."""
    return tuple(sorted(r for cat, rs in _categories().items()
                        if cat.startswith(prefix) for r in rs))


def _complement(ranges) -> tuple[tuple[int, int], ...]:
    out, nxt = [], 0
    for lo, hi in sorted(ranges):
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = max(nxt, hi + 1)
    if nxt <= MAX_CODE_POINT:
        out.append((nxt, MAX_CODE_POINT))
    return tuple(out)


def _union(*parts) -> tuple[tuple[int, int], ...]:
    return tuple(sorted(r for p in parts for r in p))


def _escape_ranges(kind: str, arg: str | None):
    """Ranges of one class escape: \\p{X} \\P{X} \\s \\S \\w \\W."""
    if kind in "pP":
        if not re.fullmatch(r"[LMNPSZC][a-z]?", arg):
            raise UnsupportedTokenizer(
                f"pre_tokenizer regex: \\{kind}{{{arg}}} is not a general "
                "category this tokenizer implements")
        r = _category_ranges(arg)
        return r if kind == "p" else _complement(r)
    if kind in "sS":
        return WHITE_SPACE if kind == "s" else _complement(WHITE_SPACE)
    # Oniguruma's \w: letters, marks, decimal digits, connector punctuation
    w = _union(_category_ranges("L"), _category_ranges("M"),
               _category_ranges("Nd"), _category_ranges("Pc"))
    return w if kind == "w" else _complement(w)


def _ranges_src(ranges) -> str:
    out = []
    for lo, hi in ranges:
        out.append(f"\\U{lo:08x}" if lo == hi
                   else f"\\U{lo:08x}-\\U{hi:08x}")
    return "".join(out)


_ESCAPE = re.compile(r"\\(?:([pP])\{\^?([A-Za-z_]+)\}|([pP])([A-Z])|([sSwW]))")


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer.json -> the same pattern for
    stdlib `re`: each \\p{..} / \\P{..} / \\s / \\S / \\w / \\W becomes an
    explicit class of code-point ranges (inlined inside a bracket
    expression, bracketed outside one). Other syntax passes through."""
    out = []
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            m = _ESCAPE.match(pattern, i)
            if m is None:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if "{^" in m.group(0):
                raise UnsupportedTokenizer(
                    f"pre_tokenizer regex: {m.group(0)} is not implemented")
            kind = m.group(1) or m.group(3) or m.group(5)
            arg = m.group(2) or m.group(4)
            src = _ranges_src(_escape_ranges(kind, arg))
            out.append(src if in_class else f"[{src}]")
            i = m.end()
            continue
        if in_class:
            if c == "]":
                in_class = False
        elif c == "[":
            in_class = True
            out.append(c)
            i += 1
            # a leading ^ or ] belongs to the class
            if i < len(pattern) and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < len(pattern) and pattern[i] == "]":
                out.append("\\]")
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


# -- the pipeline's stages ----------------------------------------------------


def _pattern(spec, where: str) -> re.Pattern:
    """A stage's `pattern`, a string or an Oniguruma regex, for `re`."""
    pat = spec.get("pattern") or {}
    if "Regex" in pat:
        return re.compile(translate_regex(pat["Regex"]))
    if "String" in pat:
        return re.compile(re.escape(pat["String"]))
    raise UnsupportedTokenizer(f"{where}: pattern {pat!r}")


def _chain(steps):
    def run(x):
        for f in steps:
            x = f(x)
        return x
    return run


def _normalizer(spec):
    """A function str -> str."""
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind in ("NFC", "NFKC"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return str.lower
    if kind == "Replace":
        rx, new = _pattern(spec, "normalizer Replace"), spec["content"]
        return lambda s: rx.sub(lambda m: new, s)
    if kind == "Sequence":
        return _chain([_normalizer(n) for n in spec.get("normalizers", [])])
    if kind == "Precompiled":
        raise UnsupportedTokenizer(
            "normalizer Precompiled (a SentencePiece charsmap) is not read "
            "by the port yet; write the tokenizer without it")
    raise UnsupportedTokenizer(f"normalizer type {kind!r} is not "
                               "implemented")


def _split(rx: re.Pattern, behavior: str, invert: bool):
    """Split each piece at the matches of rx (or, inverted, at the gaps
    between them); Isolated keeps the delimiters as pieces, Removed drops
    them."""
    if behavior not in ("Isolated", "Removed"):
        raise UnsupportedTokenizer(f"pre_tokenizer Split: behavior "
                                   f"{behavior!r}")

    def run(pieces):
        out = []
        for s in pieces:
            parts, last = [], 0
            for m in rx.finditer(s):
                if m.start() == m.end():
                    continue
                if m.start() > last:
                    parts.append((s[last:m.start()], invert))
                parts.append((m.group(0), not invert))
                last = m.end()
            if last < len(s):
                parts.append((s[last:], invert))
            out.extend(p for p, delim in parts
                       if behavior == "Isolated" or not delim)
        return out
    return run


def _byte_level(spec):
    """Split by GPT-2's regex (unless use_regex is off), then write each
    piece's UTF-8 bytes as byte-level characters."""
    prefix = bool(spec.get("add_prefix_space"))
    isolate = (_split(re.compile(translate_regex(GPT2_PATTERN)), "Isolated",
                      False) if spec.get("use_regex", True) else None)
    b2u = bytes_to_unicode()

    def run(pieces):
        if prefix:
            pieces = [p if p.startswith(" ") else " " + p for p in pieces]
        if isolate is not None:
            pieces = isolate(pieces)
        return ["".join(b2u[b] for b in p.encode("utf-8")) for p in pieces]
    return run


def _metaspace(spec):
    """Spaces become the replacement, which starts the text ("always")
    and every piece."""
    repl = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme") or (
        "always" if spec.get("add_prefix_space", True) else "never")
    if scheme not in ("always", "never"):
        raise UnsupportedTokenizer(f"pre_tokenizer Metaspace: prepend_scheme "
                                   f"{scheme!r}")
    if not spec.get("split", True):
        raise UnsupportedTokenizer("pre_tokenizer Metaspace: split false")

    def run(pieces):
        out = []
        for s in pieces:
            s = s.replace(" ", repl)
            if scheme == "always" and not s.startswith(repl):
                s = repl + s
            start = 0
            for i in range(1, len(s)):
                if s[i] == repl:
                    out.append(s[start:i])
                    start = i
            out.append(s[start:])
        return out
    return run


def _pre_tokenizer(spec):
    """A function list of pieces -> list of pieces (none: the text is one
    word)."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        return _chain([_pre_tokenizer(p)
                       for p in spec.get("pretokenizers", [])])
    if kind == "Split":
        return _split(_pattern(spec, "pre_tokenizer Split"),
                      spec.get("behavior"), bool(spec.get("invert")))
    if kind == "ByteLevel":
        return _byte_level(spec)
    if kind == "Whitespace":
        return _split(re.compile(translate_regex(r"\w+|[^\w\s]+")),
                      "Removed", True)
    if kind == "WhitespaceSplit":
        return _split(re.compile(f"[{_ranges_src(WHITE_SPACE)}]+"),
                      "Removed", False)
    if kind == "Metaspace":
        return _metaspace(spec)
    raise UnsupportedTokenizer(f"pre_tokenizer type {kind!r} is not "
                               "implemented")


def _post_processor(spec):
    """(ids with special tokens on) -> ids."""
    if spec is None:
        return lambda ids: ids
    kind = spec.get("type")
    if kind == "ByteLevel":
        return lambda ids: ids
    if kind == "Sequence":
        return _chain([_post_processor(p)
                       for p in spec.get("processors", [])])
    if kind == "RobertaProcessing":
        cls, sep = spec["cls"][1], spec["sep"][1]
        return lambda ids: [cls, *ids, sep]
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens") or {}
        items = []
        for it in spec.get("single") or []:
            if "Sequence" in it:
                if it["Sequence"].get("id") != "A":
                    raise UnsupportedTokenizer(
                        "post_processor TemplateProcessing: sequence "
                        f"{it['Sequence'].get('id')!r} in single")
                items.append(None)
            elif "SpecialToken" in it:
                name = it["SpecialToken"]["id"]
                if name not in specials:
                    raise UnsupportedTokenizer(
                        f"post_processor TemplateProcessing: {name!r} has no "
                        "special_tokens entry")
                items.append(list(specials[name]["ids"]))
            else:
                raise UnsupportedTokenizer(
                    f"post_processor TemplateProcessing: item {it!r}")

        def template(ids):
            out = []
            for it in items:
                out.extend(ids if it is None else it)
            return out
        return template
    raise UnsupportedTokenizer(f"post_processor type {kind!r} is not "
                               "implemented")


# -- models: one word -> ids --------------------------------------------------


def merge_word(ids: list[int], merges: dict) -> list[int]:
    """Apply BPE merges {(a, b): (rank, merged id)} to a word's symbol
    ids: lowest rank first, leftmost among equals, stale heap entries
    skipped (the library's algorithm)."""
    n = len(ids)
    nxt = list(range(1, n + 1))
    prv = list(range(-1, n - 1))
    alive = [True] * n
    heap = []
    for i in range(n - 1):
        m = merges.get((ids[i], ids[i + 1]))
        if m is not None:
            heap.append((m[0], i, m[1]))
    heapq.heapify(heap)
    while heap:
        _, i, new_id = heapq.heappop(heap)
        if not alive[i] or nxt[i] >= n:
            continue
        j = nxt[i]
        m = merges.get((ids[i], ids[j]))
        if m is None or m[1] != new_id:
            continue                      # a stale entry
        ids[i] = new_id
        alive[j] = False
        nxt[i] = nxt[j]
        if nxt[j] < n:
            prv[nxt[j]] = i
        if prv[i] >= 0:
            m = merges.get((ids[prv[i]], ids[i]))
            if m is not None:
                heapq.heappush(heap, (m[0], prv[i], m[1]))
        if nxt[i] < n:
            m = merges.get((ids[i], ids[nxt[i]]))
            if m is not None:
                heapq.heappush(heap, (m[0], i, m[1]))
    return [t for t, a in zip(ids, alive) if a]


class Bpe:
    def __init__(self, spec: dict):
        if spec.get("dropout"):
            raise UnsupportedTokenizer("model.dropout is not implemented")
        self.vocab: dict[str, int] = dict(spec.get("vocab") or {})
        self.size = len(self.vocab)
        self.tokens = {i: t for t, i in self.vocab.items()}
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.ignore_merges = bool(spec.get("ignore_merges"))
        unk = spec.get("unk_token")
        self.unk_id = self.vocab.get(unk) if unk is not None else None
        self.fuse_unk = bool(spec.get("fuse_unk"))
        # byte value -> its <0xNN> token's id, when the model falls back
        self.byte_ids = ({b: self.vocab.get(f"<0x{b:02X}>")
                          for b in range(256)}
                         if spec.get("byte_fallback") else None)
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ") if isinstance(m, str) else m
            merged = a + b[len(self.prefix):]
            if a not in self.vocab or b not in self.vocab \
                    or merged not in self.vocab:
                raise UnsupportedTokenizer(
                    f"model.merges[{rank}] {m!r}: a token is not in the "
                    "vocab")
            self.merges.setdefault((self.vocab[a], self.vocab[b]),
                                   (rank, self.vocab[merged]))

    def __call__(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        return merge_word(self._symbols(word), self.merges)

    def _symbols(self, word: str) -> list[int]:
        """The word's ids before any merge, in the library's order: a
        character's piece (with the subword prefix when not first and the
        word suffix when last), else its <0xNN> byte tokens
        (byte_fallback, when all exist), else the unknown token, which
        waits for the next known character or the end (fused over a run
        with fuse_unk)."""
        ids: list[int] = []
        unk = False         # an unknown token not yet placed
        last = len(word) - 1
        for n, ch in enumerate(word):
            s = (self.prefix if n else "") + ch \
                + (self.suffix if n == last else "")
            i = self.vocab.get(s)
            if i is not None:
                if unk:
                    ids.append(self.unk_id)
                    unk = False
                ids.append(i)
                continue
            if self.byte_ids is not None:
                bs = [self.byte_ids[b] for b in s.encode("utf-8")]
                if None not in bs:
                    ids.extend(bs)
                    continue
            if self.unk_id is not None:
                if unk and not self.fuse_unk:
                    ids.append(self.unk_id)
                unk = True
        if unk:
            ids.append(self.unk_id)
        return ids


class WordLevel:
    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = dict(spec.get("vocab") or {})
        self.size = len(self.vocab)
        self.tokens = {i: t for t, i in self.vocab.items()}
        self.unk = spec.get("unk_token")

    def __call__(self, word: str) -> list[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk not in self.vocab:
            raise ValueError(f"WordLevel: {word!r} is not in the vocab and "
                             f"the unk token {self.unk!r} is missing")
        return [self.vocab[self.unk]]


class Unigram:
    def __init__(self, spec: dict):
        if spec.get("byte_fallback"):
            raise UnsupportedTokenizer("model.byte_fallback (Unigram) is not "
                                       "implemented")
        pieces = spec.get("vocab") or []
        self.vocab: dict[str, int] = {}
        self.scores: list[float] = []
        for i, (piece, score) in enumerate(pieces):
            self.vocab.setdefault(piece, i)
            self.scores.append(float(score))
        self.size = len(pieces)
        self.tokens = {i: p for i, (p, _) in enumerate(pieces)}
        self.unk_id = spec.get("unk_id")
        self.unk_score = min(self.scores) - UNK_PENALTY
        self.max_len = max((len(p) for p, _ in pieces), default=1)

    def __call__(self, word: str) -> list[int]:
        n = len(word)
        # best[e] = (score, start, id) of the best path ending at char e
        best: list = [None] * (n + 1)
        best[0] = (0.0, None, None)
        for s in range(n):
            base = best[s][0]
            single = False
            for ln in range(1, min(self.max_len, n - s) + 1):
                i = self.vocab.get(word[s:s + ln])
                if i is None:
                    continue
                cand = base + self.scores[i]
                if best[s + ln] is None or cand > best[s + ln][0]:
                    best[s + ln] = (cand, s, i)
                single = single or ln == 1
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: an unknown character and no "
                                     "unk_id")
                cand = base + self.unk_score
                if best[s + 1] is None or cand > best[s + 1][0]:
                    best[s + 1] = (cand, s, self.unk_id)
        out: list[int] = []
        e, in_unk = n, False
        while e > 0:
            _, s, i = best[e]
            if i == self.unk_id:
                if not in_unk:
                    out.append(i)       # a run of unknowns fuses into one
                in_unk = True
            else:
                out.append(i)
                in_unk = False
            e = s
        return out[::-1]


MODELS = {"BPE": Bpe, "WordLevel": WordLevel, "Unigram": Unigram}


# -- the tokenizer ------------------------------------------------------------


class JsonTokenizer:
    """encode / decode of one tokenizer.json (see the module docstring)."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        kind = model.get("type", "BPE")
        if kind not in MODELS:
            raise UnsupportedTokenizer(f"model type {kind!r} is not "
                                       "implemented")
        for field in ("truncation", "padding"):
            if spec.get(field) is not None:
                raise UnsupportedTokenizer(f"{field} is not implemented")
        self.model = MODELS[kind](model)
        self.vocab = self.model.vocab
        self.id_to_token = dict(self.model.tokens)
        self.added: dict[str, int] = {}
        self._normalize = _normalizer(spec.get("normalizer"))
        raw, normed = [], []
        for tok in spec.get("added_tokens") or []:
            for flag in ("lstrip", "rstrip", "single_word"):
                if tok.get(flag):
                    raise UnsupportedTokenizer(
                        f"added_tokens {tok['content']!r}: {flag}")
            i = self._added_id(tok["content"])
            if i != int(tok["id"]):
                log.warning("added token %r: id %s in the file, %d as the "
                            "library assigns it", tok["content"], tok["id"],
                            i)
            self.added[tok["content"]] = i
            self.id_to_token[i] = tok["content"]
            # a `normalized` token is matched in the normalized text,
            # under its own normalized form; the others in the raw text
            (normed if tok.get("normalized") else raw).append(
                tok["content"])
        self._added_normed = {self._normalize(t): self.added[t]
                              for t in normed}
        self._raw_rx = _alternation(raw)
        self._normed_rx = _alternation(self._added_normed)
        self._words = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._post = _post_processor(spec.get("post_processor"))
        self._decode = _decoder(spec.get("decoder"))
        self._cache: dict[str, list[int]] = {}

    def _added_id(self, content: str) -> int:
        """The id the library gives an added token: the model's own id
        when its vocab has it, else the next id past the vocab and the
        added tokens so far (the file's id is not read)."""
        if content in self.vocab:
            return self.vocab[content]
        n = self.model.size
        if not self.added:
            return n
        top = max(self.added.values())
        return top + 1 if top >= n or n == 0 else n

    @classmethod
    def from_file(cls, path: str) -> "JsonTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    # -- encode --------------------------------------------------------------

    def _encode_word(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self.model(word)
            if len(self._cache) >= WORD_CACHE:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def _encode_words(self, normalized: str) -> list[int]:
        ids: list[int] = []
        for word in self._words([normalized] if normalized else []):
            if word:
                ids.extend(self._encode_word(word))
        return ids

    def _encode_text(self, text: str) -> list[int]:
        """A piece between raw added tokens: normalized, then split at
        the normalized added tokens, the rest pre-tokenized and encoded."""
        return _split_added(self._normalize(text), self._normed_rx,
                            self._added_normed, self._encode_words)

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> list[int]:
        ids = _split_added(text, self._raw_rx, self.added,
                           self._encode_text)
        return self._post(ids) if add_special_tokens else ids

    # -- decode --------------------------------------------------------------

    def decode(self, ids) -> str:
        tokens = [t for t in (self.id_to_token.get(int(i)) for i in ids)
                  if t is not None]
        return "".join(self._decode(tokens))


def _alternation(tokens) -> re.Pattern | None:
    """Leftmost-longest match of any of `tokens` (the library's)."""
    if not tokens:
        return None
    return re.compile("|".join(re.escape(t) for t in
                               sorted(tokens, key=len, reverse=True)))


def _split_added(text: str, rx, ids_of: dict, encode) -> list[int]:
    """The ids of the added tokens rx finds in text, and encode(...) of
    the pieces between them."""
    ids: list[int] = []
    last = 0
    if rx is not None:
        for m in rx.finditer(text):
            if m.start() > last:
                ids.extend(encode(text[last:m.start()]))
            ids.append(ids_of[m.group(0)])
            last = m.end()
    if last < len(text):
        ids.extend(encode(text[last:]))
    return ids


# -- CLIP from vocab.json + merges.txt ----------------------------------------

CLIP_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]"
              r"|[^\s\p{L}\p{N}]+")
# the slow CLIPTokenizer reads merges.txt's lines [1, CLIP_MERGES_END):
# the version header is skipped, at most 48894 merges are kept
CLIP_MERGES_END = 49152 - 256 - 2 + 1
CLIP_SPECIALS = (("bos_token", "<|startoftext|>"),
                 ("eos_token", "<|endoftext|>"),
                 ("unk_token", "<|endoftext|>"),
                 ("pad_token", "<|endoftext|>"))


def clip_spec(vocab: dict[str, int], merges_text: str,
              config: dict | None = None) -> dict:
    """The tokenizer.json that transformers' AutoTokenizer builds for a
    CLIP `vocab.json` + `merges.txt` (+ `tokenizer_config.json`, here
    `config`): its slow-to-fast conversion (CLIPConverter) over the slow
    CLIPTokenizer's reading of the files. NFC, runs of whitespace to one
    space and lowercase; CLIP's split regex (its matches kept) then
    ByteLevel (GPT-2's regex, no prefix space); BPE with the "</w>" word
    suffix; <|startoftext|> ... <|endoftext|> around the ids. The special
    tokens become added tokens: bos, eos and unk matched in the
    normalized text (the slow tokenizer wraps them so) unless the config
    says otherwise, pad as the config gives it (a bare string: in the raw
    text), each once, in that order."""
    config = config or {}
    lines = merges_text.strip().split("\n")[1:CLIP_MERGES_END]
    merges: dict[tuple[str, ...], None] = {}
    for n, line in enumerate(lines, 2):
        pair = tuple(line.split())
        if len(pair) != 2:
            raise UnsupportedTokenizer(f"merges.txt line {n}: {line!r}")
        merges.setdefault(pair, None)
    added, specials = [], {}
    for key, default in CLIP_SPECIALS:
        tok = config.get(key, default)
        if isinstance(tok, dict):
            content, normed = tok["content"], tok.get("normalized", True)
        else:
            content, normed = tok, key != "pad_token"
        specials[key] = content
        if content is not None and all(a["content"] != content
                                       for a in added):
            added.append({"content": content, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": normed, "special": True})
    top = len(vocab)
    for a in added:
        if a["content"] in vocab:
            a["id"] = vocab[a["content"]]
        else:
            a["id"], top = top, top + 1
    ids = {a["content"]: a["id"] for a in added}
    bos, eos = specials["bos_token"], specials["eos_token"]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": sorted(added, key=lambda a: a["id"]),
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFC"},
            {"type": "Replace", "pattern": {"Regex": r"\s+"},
             "content": " "},
            {"type": "Lowercase"}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": CLIP_SPLIT},
             "behavior": "Removed", "invert": True},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": True}]},
        "post_processor": {"type": "RobertaProcessing",
                           "sep": [eos, ids[eos]], "cls": [bos, ids[bos]],
                           "trim_offsets": False, "add_prefix_space": False},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None,
                  "unk_token": str(specials["unk_token"]),
                  "continuing_subword_prefix": "",
                  "end_of_word_suffix": "</w>", "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }


def load_tokenizer(directory: str) -> "JsonTokenizer":
    """A directory's tokenizer: its `tokenizer.json`, else a CLIP
    `vocab.json` + `merges.txt` (with `tokenizer_config.json` when there
    is one) as AutoTokenizer reads them."""
    path = os.path.join(directory, "tokenizer.json")
    if os.path.exists(path):
        return JsonTokenizer.from_file(path)
    vocab_path = os.path.join(directory, "vocab.json")
    merges_path = os.path.join(directory, "merges.txt")
    if not (os.path.exists(vocab_path) and os.path.exists(merges_path)):
        raise FileNotFoundError(
            f"no tokenizer.json, nor vocab.json + merges.txt, in {directory}")
    with open(vocab_path, encoding="utf-8") as f:
        vocab = json.load(f)
    with open(merges_path, encoding="utf-8") as f:
        merges = f.read()
    config = {}
    cfg_path = os.path.join(directory, "tokenizer_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as f:
            config = json.load(f)
    cls = config.get("tokenizer_class", "CLIPTokenizer")
    if cls not in ("CLIPTokenizer", "CLIPTokenizerFast"):
        raise UnsupportedTokenizer(
            f"{directory}: vocab.json + merges.txt of a {cls}; only CLIP's "
            "are read without a tokenizer.json")
    return JsonTokenizer(clip_spec(vocab, merges, config))


def word_level_spec(vocab_size: int) -> dict:
    """A tokenizers-format word-level vocabulary: whitespace words `w0`,
    `w1`, ..., then `<unk>` and `<eot>` at the two top ids (the seeded
    image models' and the written FLUX.1 checkpoints' tokenizer; no real
    one is in the repository)."""
    vocab = {f"w{i}": i for i in range(vocab_size - 2)}
    vocab["<unk>"] = vocab_size - 2
    vocab["<eot>"] = vocab_size - 1
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [], "normalizer": None,
            "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
            "decoder": None,
            "model": {"type": "WordLevel", "vocab": vocab,
                      "unk_token": "<unk>"}}


# -- decoders: list of token strings -> list of strings -----------------------


def _byte_level_decode(tokens: list[str]) -> list[str]:
    """Every token's bytes (its own UTF-8 where a character is not a
    byte-level one), as one string; invalid UTF-8 becomes U+FFFD."""
    u2b = unicode_to_bytes()
    out = bytearray()
    for tok in tokens:
        try:
            out.extend([u2b[c] for c in tok])
        except KeyError:
            out.extend(tok.encode("utf-8"))
    return [out.decode("utf-8", errors="replace")]


_BYTE_TOKEN = re.compile(r"<0x([0-9A-Fa-f]{2})>")


def _byte_fallback_decode(tokens: list[str]) -> list[str]:
    """Runs of <0xNN> tokens -> their UTF-8 text, or one U+FFFD per byte
    when the run does not decode (the library's rule)."""
    out: list[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" * len(run))
            run.clear()
    for tok in tokens:
        m = _BYTE_TOKEN.fullmatch(tok) if len(tok) == 6 else None
        if m is not None:
            run.append(int(m.group(1), 16))
        else:
            flush()
            out.append(tok)
    flush()
    return out


def _metaspace_decode(spec):
    """The replacement becomes a space, except in the first token, which
    loses it when the pre-tokenizer prepended one."""
    repl = spec.get("replacement", "▁")
    drop = (spec.get("prepend_scheme") or (
        "always" if spec.get("add_prefix_space", True) else "never")) \
        != "never"
    return lambda tokens: [t.replace(repl, "" if drop and n == 0 else " ")
                           for n, t in enumerate(tokens)]


def _decoder(spec):
    """A function list of tokens -> list of strings, joined by decode."""
    if spec is None:
        return lambda tokens: [" ".join(tokens)]
    kind = spec.get("type")
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "BPEDecoder":
        suffix = spec.get("suffix", "</w>")
        return lambda tokens: [
            t.replace(suffix, "" if n == len(tokens) - 1 else " ")
            for n, t in enumerate(tokens)]
    if kind == "Metaspace":
        return _metaspace_decode(spec)
    if kind == "Replace":
        rx, new = _pattern(spec, "decoder Replace"), spec["content"]
        return lambda tokens: [rx.sub(lambda m: new, t) for t in tokens]
    if kind == "Sequence":
        return _chain([_decoder(d) for d in spec.get("decoders", [])])
    raise UnsupportedTokenizer(f"decoder {kind!r} is not implemented")
