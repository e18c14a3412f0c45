"""The port's pure-Python tokenizer (cake_tpu_torch/utils/bpe.py) and chat
template (utils/chat_template.py) against the libraries they stand in for.

Four tokenizer.json files are trained here, offline, with `tokenizers`'
BpeTrainer in four styles: Qwen2-like (NFC, a Split regex, ByteLevel
without its regex, merges stored as "a b" strings), GPT-2-like (ByteLevel
with its regex, as OLMo2), Llama-3-like (ignore_merges, a BOS added by
TemplateProcessing) and o200k-like (\\p{Lu}\\p{Lt}\\p{Lm}\\p{Lo}\\p{M}
classes, case-insensitive contractions, possessive quantifiers and an
atomic group, as Phi-4); a fifth, Gemma-like, is built by `tokenizers`
from the vocabulary and merges of bench/synth_checkpoint.py's Gemma
writer (byte fallback to <0xNN> tokens, fuse_unk, a Replace normalizer of
" " by "▁", no pre-tokenizer, a Replace / ByteFallback / Fuse decoder and
a BOS added by TemplateProcessing). On text drawn by `hypothesis` from ASCII, CJK,
emoji, combining marks, whitespace runs (U+001C, which `re` calls space
and Unicode does not, included), embedded special tokens and numerals
outside Nd, encode must equal `tokenizers.Tokenizer.encode` with and
without special tokens, and decode must equal
`decode(ids, skip_special_tokens=False)`, ids outside the vocab included.
The chat template must render as transformers' apply_chat_template, and
the port's chat_prompt_ids must equal both transformers' tokenized
apply_chat_template and the JAX package's CakeTokenizer."""
import json

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                        pre_tokenizers, processors, trainers)

from cake_tpu.runtime import CakeTokenizer as JaxCakeTokenizer
from cake_tpu_torch.bench.synth_checkpoint import (CORPUS, GEMMA_SPECIALS,
                                                   GEMMA_TEMPLATE,
                                                   gemma_tokenizer_json)
from cake_tpu_torch.runtime import CakeTokenizer
from cake_tpu_torch.utils.bpe import JsonTokenizer, UnsupportedTokenizer
from cake_tpu_torch.utils.chat_template import ChatTemplate

QWEN2_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
             r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
              r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
              r"|\s+")
O200K_PAT = (r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*"
             r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
             r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+"
             r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
             r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]++[\r\n/]*+|(?>\s*[\r\n]+)"
             r"|\s+(?!\S)|\s+")

SPECIALS = {
    "qwen2": ["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
    "gpt2": ["<|endoftext|>", "<|pad|>"],
    "llama3": ["<|begin_of_text|>", "<|eot_id|>",
               "<|start_header_id|>", "<|end_header_id|>"],
    "o200k": ["<|endoftext|>", "<|user|>", "<|assistant|>", "<|end|>"],
    "gemma": ["<bos>", "<pad>", "<unk>", "<start_of_turn>", "<end_of_turn>",
              "<eos>"],
}
STYLES = tuple(SPECIALS)

TEXT = CORPUS * 3 + (
    " Don't, I'LL, we've, she'S. ½ ² Ⅻ ٣ ١٢٣ 12345678 ǅemal ʰa Über naïve "
    "é ä 你好世界 🚀🚀 ✓✓ \t\t  \n\n\r\n  ")


def _gemma() -> Tokenizer:
    """A Gemma-style tokenizer built by `tokenizers` itself from the
    Gemma writer's vocabulary (1,000 entries) and merges."""
    spec = gemma_tokenizer_json(vocab_size=1000, text=TEXT)
    m = spec["model"]
    tok = Tokenizer(models.BPE(
        vocab=m["vocab"], merges=[tuple(x) for x in m["merges"]],
        unk_token="<unk>", fuse_unk=True, byte_fallback=True))
    tok.normalizer = normalizers.Replace(" ", "\u2581")
    tok.decoder = decoders.Sequence([decoders.Replace("\u2581", " "),
                                     decoders.ByteFallback(),
                                     decoders.Fuse()])
    tok.add_special_tokens(sorted(GEMMA_SPECIALS,
                                  key=GEMMA_SPECIALS.get))
    tok.post_processor = processors.TemplateProcessing(
        single="<bos> $A", special_tokens=[("<bos>", GEMMA_SPECIALS["<bos>"])])
    return tok


def _train(style: str) -> Tokenizer:
    if style == "gemma":
        return _gemma()
    tok = Tokenizer(models.BPE(ignore_merges=style == "llama3"))
    split = {"qwen2": QWEN2_PAT, "llama3": LLAMA3_PAT, "o200k": O200K_PAT}
    if style == "gpt2":
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                                     use_regex=True)
    else:
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(split[style]), behavior="isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)])
    if style == "qwen2":
        tok.normalizer = normalizers.NFC()
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=700, special_tokens=SPECIALS[style], show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator([TEXT], trainer)
    if style == "llama3":
        bos = "<|begin_of_text|>"
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(
                single=f"{bos} $A", pair=f"{bos} $A {bos} $B",
                special_tokens=[(bos, tok.token_to_id(bos))])])
    else:
        tok.post_processor = processors.ByteLevel(trim_offsets=False)
    return tok


def _spec(tok: Tokenizer, style: str) -> dict:
    spec = json.loads(tok.to_str())
    if style == "qwen2":
        spec["model"]["merges"] = [" ".join(m)
                                   for m in spec["model"]["merges"]]
    return spec


@pytest.fixture(scope="module")
def pairs():
    """style -> (the library's Tokenizer, the port's JsonTokenizer), both
    from the same tokenizer.json text."""
    out = {}
    for style in STYLES:
        spec = _spec(_train(style), style)
        text = json.dumps(spec)
        out[style] = (Tokenizer.from_str(text),
                      JsonTokenizer(json.loads(text)))
    return out


PIECES = ["Hello", " world", "Don't", " I'LL", "'s", "'S", " 你好", "世界",
          "🚀", "👍🏽", "é", "ä", "́", "ǅ", "ʰ", "Ⅻ", "½",
          "²", "٣", "١٢", "12345", " 7", "  ", "\t", "\n", "\r\n", "\n\n",
          "\x1c", " ", "　", "/", "..", "?!", "ß", "İ", "ſ", "K",
          "<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|end|>",
          "<|begin_of_text|>", "<|user|>", "<|pad|>", "<bos>",
          "<start_of_turn>", "<end_of_turn>", "\u2581", " \u2581 ", "€",
          "𝄞"]
ALPHABET = ("abcXYZ019 .,'!\n\t" "你好ひらカナ한글" "🚀👍" "́̈"
            "½²Ⅻ٣" "ǅʰ" "  \x1c" "\u2581€")
texts = st.one_of(
    st.lists(st.sampled_from(PIECES), max_size=24).map("".join),
    st.text(alphabet=ALPHABET, max_size=40))


@pytest.mark.parametrize("style", STYLES)
@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=texts)
def test_encode_decode_match_tokenizers(pairs, style, text):
    lib, port = pairs[style]
    for special in (True, False):
        want = lib.encode(text, add_special_tokens=special).ids
        assert port.encode(text, add_special_tokens=special) == want, \
            (style, special, text)
    ids = lib.encode(text).ids
    assert port.decode(ids) == lib.decode(ids, skip_special_tokens=False)


@pytest.mark.parametrize("style", STYLES)
def test_corpus_and_ids_outside_vocab(pairs, style):
    """The training text itself (long merged words), and ids that have no
    vocab entry (random weights produce them all the time), with partial
    UTF-8 sequences between them."""
    lib, port = pairs[style]
    assert port.encode(TEXT) == lib.encode(TEXT).ids
    n = lib.get_vocab_size()
    ids = lib.encode("你好 🚀 naïve").ids
    mixed = [n + 5, ids[0], 10 ** 6, *ids[1:], n, 0, 255, 128, n - 1]
    assert port.decode(mixed) == lib.decode(mixed,
                                            skip_special_tokens=False)
    for i in mixed:
        assert port.decode([i]) == lib.decode([i],
                                              skip_special_tokens=False)


def test_unsupported_constructs_raise(pairs):
    spec = _spec(_train("gpt2"), "gpt2")
    cases = [("decoder", {"type": "WordPiece"}),
             ("normalizer", {"type": "BertNormalizer"}),
             ("pre_tokenizer", {"type": "Digits"}),
             ("post_processor", {"type": "BertProcessing"}),
             ("normalizer", {"type": "Precompiled",
                             "precompiled_charsmap": "AAAA"})]
    for field, value in cases:
        bad = dict(spec, **{field: value})
        with pytest.raises(UnsupportedTokenizer):
            JsonTokenizer(bad)
    bad = json.loads(json.dumps(spec))
    bad["model"]["dropout"] = 0.1
    with pytest.raises(UnsupportedTokenizer, match="dropout"):
        JsonTokenizer(bad)


def test_byte_fallback_decode_fuses_split_utf8(pairs):
    """<0xNN> runs decode to their UTF-8 text as one piece, however the
    ids are split; a run that is not valid UTF-8 gives one U+FFFD per
    byte, as the library's ByteFallback decoder does; a character with no
    piece encodes to its bytes."""
    lib, port = pairs["gemma"]
    byte = {b: lib.token_to_id(f"<0x{b:02X}>") for b in range(256)}
    euro = [byte[b] for b in "€".encode()]
    ids = lib.encode("a€b𝄞", add_special_tokens=False).ids
    assert port.encode("a€b𝄞", add_special_tokens=False) == ids
    assert euro[0] in ids
    for seq in (euro, euro[:2], [euro[0], lib.token_to_id("a"), euro[2]],
                euro[1:] + euro, [byte[0xFF], byte[0xC3], byte[0xA9]]):
        assert port.decode(seq) == lib.decode(seq,
                                              skip_special_tokens=False)
    assert port.decode(euro) == "€" and port.decode(euro[:2]) == "\ufffd" * 2


# -- chat templates -----------------------------------------------------------

TEMPLATES = {
    "chatml": (
        "{% for message in messages %}{{'<|im_start|>' + message['role'] "
        "+ '\n' + message['content'] + '<|im_end|>' + '\n'}}{% endfor %}"
        "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}"
        "{% endif %}"),
    "llama3": (
        "{{ bos_token }}{% for message in messages %}\n"
        "    {% if message['role'] not in ['system', 'user', 'assistant'] %}"
        "{{ raise_exception('unknown role') }}{% endif %}\n"
        "    {{ '<|start_header_id|>' + message['role'] + "
        "'<|end_header_id|>\n\n' + message['content'] | trim + "
        "'<|eot_id|>' }}\n"
        "{% endfor %}\n"
        "{% if add_generation_prompt %}"
        "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
        "{% endif %}"),
    "phi4": (
        "{% set ns = namespace(n=0) %}{% for message in messages %}"
        "{% set ns.n = ns.n + 1 %}{% if message['role'] == 'system' %}"
        "<|system|>{{ message['content'] }}{{ {'n': ns.n, 'note': 'é✓'} "
        "| tojson }}<|end|>{% elif message['role'] == 'user' %}"
        "<|user|>{{ message['content'] }}<|end|>{% else %}"
        "{% if loop.last %}{% break %}{% endif %}"
        "<|assistant|>{{ message['content'] }}<|end|>{% endif %}"
        "{% endfor %}{% if add_generation_prompt %}<|assistant|>"
        "{% else %}{{ eos_token }}{% endif %}"),
    "gemma": GEMMA_TEMPLATE,
}
CONVERSATIONS = [
    [{"role": "user", "content": "hi"}],
    [{"role": "system", "content": "Be brief. 简短。"},
     {"role": "user", "content": "  What is ½ of 8?  "},
     {"role": "assistant", "content": "4 🚀"},
     {"role": "user", "content": "And Ⅻ?\n"}],
]


def _model_dir(tmp_path, style, template):
    tok = _train(style)
    d = tmp_path / f"{style}-{template}"
    d.mkdir()
    (d / "tokenizer.json").write_text(json.dumps(_spec(tok, style)))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "chat_template": TEMPLATES[template],
        "bos_token": SPECIALS[style][0], "eos_token": SPECIALS[style][-1]}))
    return d


@pytest.mark.parametrize("style,template", [("qwen2", "chatml"),
                                            ("llama3", "llama3"),
                                            ("o200k", "phi4"),
                                            ("gemma", "gemma")])
def test_chat_template_and_prompt_ids_match(tmp_path, style, template):
    """apply_chat equals transformers' apply_chat_template, and the
    port's chat_prompt_ids equal transformers' tokenized
    apply_chat_template and the JAX CakeTokenizer's
    encode_chat_prompt(apply_chat(...)) (no second BOS after a template
    that writes one, as Llama 3's and Gemma's do)."""
    from transformers import PreTrainedTokenizerFast
    d = _model_dir(tmp_path, style, template)
    hf = PreTrainedTokenizerFast.from_pretrained(str(d))
    port = CakeTokenizer(str(d))
    jax_tok = JaxCakeTokenizer(str(d))
    assert jax_tok._hf is not None
    for msgs in CONVERSATIONS:
        want = hf.apply_chat_template(msgs, tokenize=False,
                                      add_generation_prompt=True)
        assert port.apply_chat(msgs) == want
        ids = port.chat_prompt_ids(msgs)
        assert ids == jax_tok.encode_chat_prompt(jax_tok.apply_chat(msgs))
        assert ids == list(hf.apply_chat_template(
            msgs, tokenize=True, add_generation_prompt=True))
        out = port.chat_prompt_ids(msgs)[-5:]
        assert port.decode(out) == jax_tok.decode(out)


def test_template_failures_raise(tmp_path):
    with pytest.raises(ValueError, match="does not compile"):
        ChatTemplate("{% for m in messages %}{{ m['content'] }")
    import jinja2
    t = ChatTemplate(TEMPLATES["llama3"], {"bos_token": "<s>"})
    with pytest.raises(jinja2.TemplateError, match="unknown role"):
        t.render([{"role": "tool", "content": "x"}])
    t = ChatTemplate(GEMMA_TEMPLATE, {"bos_token": "<bos>"})
    with pytest.raises(jinja2.TemplateError, match="must alternate"):
        t.render([{"role": "user", "content": "a"},
                  {"role": "user", "content": "b"}])


def test_no_template_falls_back_to_chatml_and_raw_ids(tmp_path):
    d = tmp_path / "plain"
    d.mkdir()
    (d / "tokenizer.json").write_text(json.dumps(_spec(_train("qwen2"),
                                                       "qwen2")))
    port, jax_tok = CakeTokenizer(str(d)), JaxCakeTokenizer(str(d))
    msgs = CONVERSATIONS[1]
    assert port.apply_chat(msgs) == jax_tok.apply_chat(msgs)
    assert port.chat_prompt_ids(msgs) == \
        jax_tok.encode_chat_prompt(jax_tok.apply_chat(msgs))
    bare = tmp_path / "bare"
    bare.mkdir()
    port, jax_tok = CakeTokenizer(str(bare)), JaxCakeTokenizer(str(bare))
    assert port.encode("11 23 5") == jax_tok.encode("11 23 5") == [11, 23, 5]
    assert port.decode([11, 23]) == jax_tok.decode([11, 23])
    with pytest.raises(RuntimeError):
        port.encode("not ids")


def test_synth_checkpoint_tokenizer_matches_tokenizers():
    """The tokenizer.json that chip_smoke.py's checkpoints carry
    (bench/synth_checkpoint.py) encodes and decodes as `tokenizers` does,
    on the smoke's own chat prompts."""
    import sys
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from cake_tpu_torch.bench import synth_checkpoint as sc
    text = json.dumps(sc.tokenizer_json(sc.QWEN3_SPECIALS))
    lib, port = Tokenizer.from_str(text), JsonTokenizer(json.loads(text))
    tmpl = ChatTemplate(sc.CHATML_TEMPLATE)
    for i in range(5):
        for shared in (False, True):
            prompt = tmpl.render(chip_smoke.chat_body(i, shared=shared)
                                 ["messages"])
            ids = lib.encode(prompt, add_special_tokens=False).ids
            assert port.encode(prompt, add_special_tokens=False) == ids
            assert port.decode(ids) == lib.decode(
                ids, skip_special_tokens=False) == prompt
    assert port.encode(CORPUS) == lib.encode(CORPUS).ids


def test_added_token_ids_follow_the_library():
    """A file whose added-token ids leave a gap after the vocab: the
    library renumbers them (the vocab's next ids, in file order) and so
    does the port."""
    spec = _spec(_train("gpt2"), "gpt2")
    n = len(spec["model"]["vocab"])
    for k, tok in enumerate(spec["added_tokens"]):
        if tok["content"] not in spec["model"]["vocab"]:
            tok["id"] = 5000 + k
    spec["added_tokens"].append(
        {"id": 9999, "content": "<|extra|>", "single_word": False,
         "lstrip": False, "rstrip": False, "normalized": False,
         "special": True})
    text = json.dumps(spec)
    lib, port = Tokenizer.from_str(text), JsonTokenizer(json.loads(text))
    prompt = "a<|extra|>b<|pad|> c<|endoftext|>"
    assert port.encode(prompt) == lib.encode(prompt).ids
    assert lib.token_to_id("<|extra|>") >= n
    ids = lib.encode(prompt).ids + [9999, 5000]
    assert port.decode(ids) == lib.decode(ids, skip_special_tokens=False)
