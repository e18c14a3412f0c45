"""BPE from a `tokenizer.json`, in pure Python (the port's counterpart
of the `tokenizers` library that cake_tpu/runtime.py calls; the card's
machine has no `tokenizers`): byte-level BPE (GPT-2, Qwen, Llama 3,
o200k) and the byte-fallback BPE converted from SentencePiece (Gemma).

What it reads, and nothing else (any other construct raises at load and
names its field):
  * model: BPE with `vocab`, `merges` as "a b" strings or ["a", "b"]
    pairs, `ignore_merges`, `unk_token` with or without `fuse_unk`, and
    `byte_fallback` (a character with no piece becomes the `<0xNN>`
    tokens of its UTF-8 bytes); no dropout, no subword prefix or suffix;
  * added_tokens: split out of the raw text before anything else,
    longest first at each position (the library's leftmost-longest
    match); tokens without lstrip / rstrip / single_word. Their ids are
    the library's: the vocab's id, or the next one past the vocab (a
    file whose ids leave a gap is renumbered, with a warning, as the
    library renumbers it);
  * normalizer: none, NFC, Replace (a string by a string, as Gemma's
    " " by "▁"), or a Sequence of them;
  * pre_tokenizer: none (the text between added tokens is one word, as
    in Gemma's), ByteLevel (with or without its GPT-2 regex, with or
    without a prefix space), Split (a regex or a string, behaviour
    Isolated), or a Sequence of them;
  * post_processor: ByteLevel (ids unchanged) or TemplateProcessing (a
    BOS as Llama 3 adds it), or a Sequence of them;
  * decoder: ByteLevel, or a Sequence of Replace (string by string),
    ByteFallback (a run of `<0xNN>` tokens becomes its UTF-8 text, or one
    U+FFFD per byte when the run is not valid UTF-8) and Fuse.

The library's patterns are Oniguruma regexes. Stdlib `re` lacks
`\\p{..}` classes and reads `\\s` and `\\w` differently, so `translate_regex`
rewrites those escapes into explicit code-point ranges built from
`unicodedata`; possessive quantifiers, atomic groups and scoped flags
`(?i:..)` are `re` syntax since Python 3.11.

Encoding a word applies merges by rank with a heap, the library's
algorithm (lowest rank first, leftmost among equals, stale entries
skipped), behind a per-word cache. `decode(ids)` equals the library's
`decode(ids, skip_special_tokens=False)`: ids with no token are dropped;
through the ByteLevel decoder a token whose characters are not all
byte-level characters contributes its own UTF-8, and invalid UTF-8
becomes U+FFFD.
"""
from __future__ import annotations

import functools
import heapq
import json
import logging
import re
import sys
import unicodedata

log = logging.getLogger(__name__)

MAX_CODE_POINT = sys.maxunicode
WORD_CACHE = 10000   # words kept by the per-word cache

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


def _string_pattern(spec, where: str) -> str:
    pat = spec.get("pattern") or {}
    if "String" not in pat:
        raise UnsupportedTokenizer(f"{where} Replace: pattern {pat!r} (only "
                                   "a string is implemented)")
    return pat["String"]


def _normalizer(spec):
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Replace":
        old, new = _string_pattern(spec, "normalizer"), spec["content"]
        return lambda s: s.replace(old, new)
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec.get("normalizers", [])]

        def run(s):
            for f in steps:
                s = f(s)
            return s
        return run
    raise UnsupportedTokenizer(f"normalizer type {kind!r} is not "
                               "implemented")


def _split_isolated(rx: re.Pattern, pieces: list[str]) -> list[str]:
    """Each match and each gap between matches becomes a piece."""
    out = []
    for s in pieces:
        last = 0
        for m in rx.finditer(s):
            if m.start() == m.end():
                continue
            if m.start() > last:
                out.append(s[last:m.start()])
            out.append(m.group(0))
            last = m.end()
        if last < len(s):
            out.append(s[last:])
    return out


def _pre_tokenizer(spec):
    """A function str -> list of words: in byte-level characters, or
    (no pre-tokenizer) the text itself as one word."""
    if spec is None:
        return lambda text: [text] if text else []
    steps = spec.get("pretokenizers") if spec.get("type") == "Sequence" \
        else [spec]
    fns, byte_level = [], False
    for st in steps:
        kind = st.get("type")
        if kind == "Split":
            if st.get("invert"):
                raise UnsupportedTokenizer("pre_tokenizer Split: invert")
            if st.get("behavior") != "Isolated":
                raise UnsupportedTokenizer(
                    f"pre_tokenizer Split: behavior {st.get('behavior')!r}")
            pat = st.get("pattern") or {}
            if "Regex" in pat:
                rx = re.compile(translate_regex(pat["Regex"]))
            elif "String" in pat:
                rx = re.compile(re.escape(pat["String"]))
            else:
                raise UnsupportedTokenizer(f"pre_tokenizer Split: pattern "
                                           f"{pat!r}")
            fns.append(functools.partial(_split_isolated, rx))
        elif kind == "ByteLevel":
            if byte_level:
                raise UnsupportedTokenizer("pre_tokenizer: two ByteLevel")
            byte_level = True
            prefix = bool(st.get("add_prefix_space"))
            rx = (re.compile(translate_regex(GPT2_PATTERN))
                  if st.get("use_regex", True) else None)

            def level(pieces, prefix=prefix, rx=rx):
                if prefix:
                    pieces = [p if p.startswith(" ") else " " + p
                              for p in pieces]
                if rx is not None:
                    pieces = _split_isolated(rx, pieces)
                return pieces
            fns.append(level)
        else:
            raise UnsupportedTokenizer(f"pre_tokenizer type {kind!r} is not "
                                       "implemented")
    if not byte_level:
        raise UnsupportedTokenizer("pre_tokenizer has no ByteLevel step")
    b2u = bytes_to_unicode()

    def run(text: str) -> list[str]:
        pieces = [text]
        for f in fns:
            pieces = f(pieces)
        return ["".join(b2u[b] for b in p.encode("utf-8"))
                for p in pieces if p]
    return run


def _post_processor(spec):
    """(ids with special tokens on) -> ids."""
    if spec is None:
        return lambda ids: ids
    kind = spec.get("type")
    if kind == "ByteLevel":
        return lambda ids: ids
    if kind == "Sequence":
        steps = [_post_processor(p) for p in spec.get("processors", [])]

        def run(ids):
            for f in steps:
                ids = f(ids)
            return ids
        return run
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


# -- the tokenizer ------------------------------------------------------------


class BpeTokenizer:
    """encode / decode of one tokenizer.json (see the module docstring)."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            raise UnsupportedTokenizer(f"model type {model.get('type')!r} is "
                                       "not implemented")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise UnsupportedTokenizer(f"model.{key} is not implemented")
        if model.get("dropout"):
            raise UnsupportedTokenizer("model.dropout is not implemented")
        self.vocab: dict[str, int] = dict(model.get("vocab") or {})
        self.ignore_merges = bool(model.get("ignore_merges"))
        unk = model.get("unk_token")
        self.unk_id = self.vocab.get(unk) if unk is not None else None
        self.fuse_unk = bool(model.get("fuse_unk"))
        # byte value -> its <0xNN> token's id, when the model falls back
        self.byte_ids = ({b: self.vocab.get(f"<0x{b:02X}>")
                          for b in range(256)}
                         if model.get("byte_fallback") else None)
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ") if isinstance(m, str) else m
            if a not in self.vocab or b not in self.vocab \
                    or a + b not in self.vocab:
                raise UnsupportedTokenizer(
                    f"model.merges[{rank}] {m!r}: a token is not in the "
                    "vocab")
            self.merges.setdefault((self.vocab[a], self.vocab[b]),
                                   (rank, self.vocab[a + b]))
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.added: dict[str, int] = {}
        self.special_ids: set[int] = set()
        normalizer = spec.get("normalizer")
        for tok in spec.get("added_tokens") or []:
            for flag in ("lstrip", "rstrip", "single_word"):
                if tok.get(flag):
                    raise UnsupportedTokenizer(
                        f"added_tokens {tok['content']!r}: {flag}")
            if tok.get("normalized") and not tok.get("special") \
                    and normalizer is not None:
                raise UnsupportedTokenizer(
                    f"added_tokens {tok['content']!r}: normalized")
            i = self._added_id(tok["content"])
            if i != int(tok["id"]):
                log.warning("added token %r: id %s in the file, %d as the "
                            "library assigns it", tok["content"], tok["id"],
                            i)
            self.added[tok["content"]] = i
            self.id_to_token[i] = tok["content"]
            if tok.get("special"):
                self.special_ids.add(i)
        self._added_rx = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)
        self._normalize = _normalizer(normalizer)
        self._words = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._post = _post_processor(spec.get("post_processor"))
        self._decode = _decoder(spec.get("decoder"))
        self._cache: dict[str, list[int]] = {}

    def _added_id(self, content: str) -> int:
        """The id the library gives an added token: the model's own id
        when the vocab has it, else the next id past the vocab and the
        added tokens so far (the file's id is not read)."""
        if content in self.vocab:
            return self.vocab[content]
        n = len(self.vocab)
        if not self.added:
            return n
        top = max(self.added.values())
        return top + 1 if top >= n or n == 0 else n

    @classmethod
    def from_file(cls, path: str) -> "BpeTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    # -- encode --------------------------------------------------------------

    def _bpe(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids = self._symbols(word)
        n = len(ids)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, i, new_id = heapq.heappop(heap)
            if not alive[i] or nxt[i] >= n:
                continue
            j = nxt[i]
            m = self.merges.get((ids[i], ids[j]))
            if m is None or m[1] != new_id:
                continue                      # a stale entry
            ids[i] = new_id
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                m = self.merges.get((ids[prv[i]], ids[i]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] < n:
                m = self.merges.get((ids[i], ids[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [t for t, a in zip(ids, alive) if a]

    def _symbols(self, word: str) -> list[int]:
        """The word's ids before any merge, in the library's order: a
        character's piece, else its <0xNN> byte tokens (byte_fallback,
        when all exist), else the unknown token, which waits for the next
        known character or the end (fused over a run with fuse_unk)."""
        ids: list[int] = []
        unk = False         # an unknown token not yet placed
        for ch in word:
            i = self.vocab.get(ch)
            if i is not None:
                if unk:
                    ids.append(self.unk_id)
                    unk = False
                ids.append(i)
                continue
            if self.byte_ids is not None:
                bs = [self.byte_ids[b] for b in ch.encode("utf-8")]
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

    def _encode_word(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._bpe(word)
            if len(self._cache) >= WORD_CACHE:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def _encode_text(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in self._words(self._normalize(text)):
            ids.extend(self._encode_word(word))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> list[int]:
        ids: list[int] = []
        last = 0
        if self._added_rx is not None:
            for m in self._added_rx.finditer(text):
                if m.start() > last:
                    ids.extend(self._encode_text(text[last:m.start()]))
                ids.append(self.added[m.group(0)])
                last = m.end()
        if last < len(text):
            ids.extend(self._encode_text(text[last:]))
        return self._post(ids) if add_special_tokens else ids

    # -- decode --------------------------------------------------------------

    def decode(self, ids) -> str:
        tokens = [t for t in (self.id_to_token.get(int(i)) for i in ids)
                  if t is not None]
        return "".join(self._decode(tokens))


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


def _decoder(spec):
    """A function list of tokens -> list of strings, joined by decode."""
    kind = None if spec is None else spec.get("type")
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Replace":
        old, new = _string_pattern(spec, "decoder"), spec["content"]
        return lambda tokens: [t.replace(old, new) for t in tokens]
    if kind == "Sequence":
        steps = [_decoder(d) for d in spec.get("decoders", [])]

        def run(tokens):
            for f in steps:
                tokens = f(tokens)
            return tokens
        return run
    raise UnsupportedTokenizer(f"decoder {kind!r} is not implemented")
