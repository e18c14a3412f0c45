"""Stop sequences and continuation mode in the port's chat API (the
reference's cake_tpu/api/text.py: MAX_STOPS, _stops_from_request,
apply_stop, StopMatcher, and text_model.py: continuation_prompt_ids):

  * the port's stops_from_request, apply_stop and StopMatcher against the
    reference's under hypothesis: the same emitted text, the same
    `stopped` flag, the same errors;
  * the port's continuation_prompt_ids against the reference's, for the
    flagship's byte tokenizer and for a checkpoint tokenizer;
  * end to end, through the port's HTTP server on a tiny llama carried
    from the JAX package, greedy: `stop` as a string and as a list whose
    earliest match wins gives the reference's apply_stop over the JAX
    model's greedy text with finish_reason "stop", on the JSON and the
    SSE path (whose deltas never carry any part of a stop sequence); a
    stream with no match flushes its held-back tail; every invalid
    `stop`, and "continue" on a user message, answers 400; a
    continuation's tokens equal the JAX model's greedy tokens for the
    reference's continuation ids."""
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cake_tpu.api import text as ref_text
from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.models.common.text_model import \
    continuation_prompt_ids as ref_continuation_ids
from cake_tpu.ops.sampling import SamplingConfig as JaxSampling
from cake_tpu_torch.api import create_app
from cake_tpu_torch.api.text import (MAX_STOPS, StopMatcher, apply_stop,
                                     stops_from_request)
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.serve import ServeEngine
from cake_tpu_torch.tokenizer import ByteTokenizer
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
CTX = 256
MAX_TOKENS = 24

ALPHABET = "ab\n .é€🚀"
pieces = st.text(alphabet=ALPHABET, max_size=4)
stop_lists = st.lists(st.text(alphabet=ALPHABET, min_size=1, max_size=4),
                      max_size=MAX_STOPS)
stop_fields = st.one_of(
    st.none(), st.text(alphabet=ALPHABET, max_size=3),
    st.lists(st.one_of(st.text(alphabet=ALPHABET, max_size=3),
                       st.integers(0, 3), st.none()), max_size=6),
    st.integers(), st.dictionaries(st.text(max_size=2), st.integers(),
                                   max_size=1))


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:          # compared: type and message
        return (type(e).__name__, str(e))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(stop=stop_fields)
def test_stops_from_request_matches_reference(stop):
    body = {} if stop is None else {"stop": stop}
    assert MAX_STOPS == ref_text.MAX_STOPS
    assert _outcome(stops_from_request, body) == \
        _outcome(ref_text._stops_from_request, body)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(text=st.text(alphabet=ALPHABET, max_size=30), stops=stop_lists)
def test_apply_stop_matches_reference(text, stops):
    assert apply_stop(text, stops) == ref_text.apply_stop(text, stops)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(parts=st.lists(pieces, max_size=12), stops=stop_lists)
def test_stop_matcher_matches_reference(parts, stops):
    """Fed the same pieces, both matchers emit the same text piece by
    piece and agree on `stopped`; what they emit joins to apply_stop of
    the whole text, and never holds any part of a stop sequence past a
    match."""
    port, ref = StopMatcher(stops), ref_text.StopMatcher(stops)
    out = []
    for p in parts:
        got = port.feed(p)
        assert got == ref.feed(p)
        assert port.stopped == ref.stopped
        out.append(got)
    tail = port.flush()
    assert tail == ref.flush()
    text, matched = apply_stop("".join(parts), stops)
    assert "".join(out) + tail == text
    assert port.stopped == matched


def _messages(partial: str) -> list[dict]:
    return [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Name a GPU, 🚀 please."},
            {"role": "assistant", "content": partial, "continue": True}]


@pytest.mark.parametrize("partial", ["", "The H100", "naïve € \n"])
def test_continuation_ids_byte_tokenizer(partial):
    tok = ByteTokenizer(im_start_id=256, im_end_id=257)
    msgs = _messages(partial)
    assert tok.continuation_prompt_ids(msgs) == \
        ref_continuation_ids(tok, msgs)
    # the history keeps its assistant header and the turn stays open
    ids = tok.continuation_prompt_ids(msgs)
    assert ids[:len(tok.chat_prompt_ids(msgs[:-1]))] == \
        tok.chat_prompt_ids(msgs[:-1])
    assert 257 not in ids[len(tok.chat_prompt_ids(msgs[:-1])):]


@pytest.mark.parametrize("partial", ["", "The H100", "naïve € \n"])
def test_continuation_ids_checkpoint_tokenizer(tmp_path, partial):
    """A byte-level BPE with a ChatML template, as test_torch_runtime.py
    builds it: the port's CakeTokenizer against the reference's (its
    tokenizers / transformers build)."""
    from cake_tpu.runtime import CakeTokenizer as RefCakeTokenizer
    from cake_tpu_torch.bench import synth_checkpoint as sc
    from cake_tpu_torch.runtime import CakeTokenizer
    d = str(tmp_path / "tiny-qwen3")
    config = dict(architectures=["Qwen3ForCausalLM"], vocab_size=800,
                  hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  rms_norm_eps=1e-6, max_position_embeddings=512,
                  tie_word_embeddings=True, eos_token_id=[797, 798])
    sc.write_model(d, config, sc.model_params(config, 3, torch.float32))
    sc.write_tokenizer(d, {"<|endoftext|>": 797, "<|im_start|>": 796,
                           "<|im_end|>": 798}, n_merges=200)
    msgs = _messages(partial)
    ref = RefCakeTokenizer(d)
    assert ref._hf is not None      # the template, not the ChatML fallback
    want = ref_continuation_ids(ref, msgs)
    assert CakeTokenizer(d).continuation_prompt_ids(msgs) == want


# -- end to end over HTTP -----------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """A tiny llama with a byte tokenizer behind the port's server, the
    JAX model it was carried from, and every request the engine took."""
    over = dict(vocab_size=258, max_position_embeddings=CTX)
    jm = JaxTextModel(jax_tiny_config("llama", **over), dtype=jnp.float32,
                      max_cache_len=CTX, seed=11)
    cfg = tiny_config("llama", **over)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tok = ByteTokenizer(im_start_id=256, im_end_id=257)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   tokenizer=tok, dtype=torch.float32, device="cpu",
                   max_cache_len=CTX)
    eng = ServeEngine(tm, slots=2, max_queue=8, ctx_len=CTX)
    submitted = []
    submit = eng.submit
    eng.submit = lambda *a, **k: submitted.append(submit(*a, **k)) or \
        submitted[-1]
    app = create_app(tm, eng, tok, port=0).start()
    yield jm, tm, app, submitted
    app.stop(drain_s=1)


def _post(url, body):
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _sse(raw: bytes) -> tuple[list[str], str]:
    """(content deltas, finish_reason) of an SSE body."""
    events = [ln[6:] for ln in raw.decode().splitlines()
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
    assert chunks[0]["delta"] == {"role": "assistant"}
    return ([c["delta"]["content"] for c in chunks[1:-1]],
            chunks[-1]["finish_reason"])


CHAT = [{"role": "user", "content": "Tell me about the card."}]


@pytest.fixture(scope="module")
def greedy_text(served):
    """The JAX model's greedy content for CHAT and its token ids."""
    jm, tm, _, _ = served
    ids = tm.tokenizer.chat_prompt_ids(CHAT)
    toks, _ = jm.generate(ids, max_new_tokens=MAX_TOKENS,
                          sampling=JaxSampling(temperature=0.0), spec=False)
    ended = tm.cfg.is_eos(toks[-1])
    content = tm.tokenizer.decode(toks[:-1] if ended else toks)
    return content, toks


def _stop_cases(content: str) -> dict:
    """Two stop sequences of the greedy content, by first occurrence: an
    early one, and a later one listed first (so that the earliest match,
    not the first listed, has to win). Each is two characters with no
    replacement character (random weights emit stray bytes)."""
    firsts = sorted({content.index(content[i:i + 2]): content[i:i + 2]
                     for i in range(2, len(content) - 1)
                     if "\ufffd" not in content[i:i + 2]}.items())
    firsts = [(i, w) for i, w in firsts if i >= 2]
    assert len(firsts) >= 2, f"no stop sequences in {content!r}"
    (_, early), (_, late) = firsts[0], firsts[-1]
    return {"string": early, "list": [late, early]}


@pytest.mark.parametrize("form", ["string", "list"])
def test_stop_json_and_sse_equal_reference(served, greedy_text, form):
    _, _, app, submitted = served
    content, _ = greedy_text
    stop = _stop_cases(content)[form]
    want, matched = ref_text.apply_stop(
        content, [stop] if isinstance(stop, str) else stop)
    assert matched and len(want) < len(content)
    body = {"messages": CHAT, "temperature": 0, "max_tokens": MAX_TOKENS,
            "stop": stop}
    status, raw = _post(app.url, body)
    assert status == 200, raw
    resp = json.loads(raw)
    assert resp["choices"][0]["message"]["content"] == want
    assert resp["choices"][0]["finish_reason"] == "stop"
    assert submitted[-1].result.get("error") is None
    status, raw = _post(app.url, {**body, "stream": True})
    assert status == 200
    deltas, finish = _sse(raw)
    assert "".join(deltas) == want and finish == "stop"
    for s in ([stop] if isinstance(stop, str) else stop):
        assert s not in "".join(deltas)


def test_sse_without_match_flushes_held_tail(served, greedy_text):
    """A stop sequence that never matches holds back len - 1 characters
    at a time; the stream still ends with every character."""
    _, _, app, _ = served
    content, toks = greedy_text
    stop = "zq\x07|"
    assert stop not in content
    body = {"messages": CHAT, "temperature": 0, "max_tokens": MAX_TOKENS,
            "stop": [stop], "stream": True}
    status, raw = _post(app.url, body)
    assert status == 200
    deltas, finish = _sse(raw)
    assert "".join(deltas) == content
    ended = len(toks) < MAX_TOKENS or served[1].cfg.is_eos(toks[-1])
    assert finish == ("stop" if ended else "length")


@pytest.mark.parametrize("stop", [
    ["a", "b", "c", "d", "e"], ["ok", ""], ["ok", 3], 5, {"x": 1}, [None]],
    ids=["five", "empty", "not_str", "int", "dict", "none_in_list"])
@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_invalid_stop_answers_400(served, stop, stream):
    _, _, app, _ = served
    body = {"messages": CHAT, "temperature": 0, "max_tokens": 4,
            "stop": stop, "stream": stream}
    status, raw = _post(app.url, body)
    assert status == 400 and "stop" in json.loads(raw)["error"]
    with pytest.raises(ValueError):
        ref_text._stops_from_request(body)


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_continue_on_user_tail_answers_400(served, stream):
    _, _, app, _ = served
    msgs = [{"role": "user", "content": "hi", "continue": True}]
    status, raw = _post(app.url, {"messages": msgs, "max_tokens": 4,
                                  "stream": stream})
    assert status == 400 and "continue" in json.loads(raw)["error"]


def test_continuation_equals_jax_greedy(served, greedy_text):
    """A partial assistant turn (the first half of the greedy content) is
    continued from the reference's continuation ids: the engine's prompt
    is those ids and its tokens are the JAX model's greedy tokens for
    them."""
    jm, tm, app, submitted = served
    content, _ = greedy_text
    msgs = CHAT + [{"role": "assistant", "content": content[:6],
                    "continue": True}]
    ids = ref_continuation_ids(tm.tokenizer, msgs)
    want, _ = jm.generate(ids, max_new_tokens=12,
                          sampling=JaxSampling(temperature=0.0), spec=False)
    status, raw = _post(app.url, {"messages": msgs, "temperature": 0,
                                  "max_tokens": 12})
    assert status == 200, raw
    req = submitted[-1]
    assert req.prompt_ids == ids
    assert req.result["tokens"] == want
    ended = tm.cfg.is_eos(want[-1])
    assert json.loads(raw)["choices"][0]["message"]["content"] == \
        tm.tokenizer.decode(want[:-1] if ended else want)
