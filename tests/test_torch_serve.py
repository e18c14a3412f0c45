"""The port's serve engine and HTTP server on a tiny CPU model: concurrent
greedy requests equal the sequential path token for token, and a JSON
chat and an SSE chat through the stdlib server (urllib client) equal the
JAX TextModel's greedy tokens for the same carried weights; the SSE
chunks join to the JSON content, a character split over byte tokens
going out whole (TextStream, also held here against a Gemma-style
byte-fallback tokenizer)."""
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu_torch.api import create_app
from cake_tpu_torch.api.text import TextStream
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import QueueFull, ServeEngine
from cake_tpu_torch.tokenizer import ByteTokenizer
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
GREEDY = SamplingConfig(temperature=0.0)
# bytes 0-255 plus the two ChatML markers: every id has its own text
VOCAB = 258


@pytest.fixture(scope="module")
def models():
    over = dict(vocab_size=VOCAB, max_position_embeddings=512)
    jm = JaxTextModel(jax_tiny_config("qwen3", **over), dtype=jnp.float32,
                      seed=7)
    cfg = tiny_config("qwen3", **over)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tok = ByteTokenizer(im_start_id=256, im_end_id=257)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   tokenizer=tok, dtype=torch.float32, device="cpu")
    return jm, tm


def test_engine_concurrent_equals_sequential(models):
    """Three slots, four requests: chunked admission (256-token chunks:
    flash fresh, flash append, masked tails) interleaved with batched
    decode gives each request exactly its sequential greedy tokens."""
    _, tm = models
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, 256, n)]
               for n in (300, 480, 40, 270)]
    want = [tm.generate(p, max_new_tokens=12)[0] for p in prompts]
    eng = ServeEngine(tm, slots=3, ctx_len=512, prefill_chunk=256)
    try:
        reqs = [eng.submit(p, 12, GREEDY) for p in prompts]
        for r in reqs:
            assert r.wait(120)
        assert [r.result["tokens"] for r in reqs] == want
        assert [r.result["stats"]["prefill_chunks"] for r in reqs] == \
            [2, 2, 1, 2]
        assert eng.health()["slots_busy"] == 0
    finally:
        eng.close()


def test_engine_backpressure_and_cancel(models):
    _, tm = models
    eng = ServeEngine(tm, slots=1, max_queue=1, ctx_len=512)
    try:
        with pytest.raises(ValueError):
            eng.submit(list(range(600)), 4, GREEDY)       # over ctx
        reqs = []
        with pytest.raises(QueueFull):
            for _ in range(5):
                reqs.append(eng.submit([5] * 40, 200, GREEDY))
        for r in reqs:
            r.cancel()
        for r in reqs:
            assert r.wait(60)
        assert eng.health()["slots_busy"] == 0
    finally:
        eng.close()


def _post(url, body):
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_http_chat_json_and_sse_match_jax(models, monkeypatch):
    import cake_tpu.ops.flash as fl
    orig = fl.flash_attention
    monkeypatch.setattr(fl, "flash_enabled", lambda: True)
    monkeypatch.setattr(fl, "flash_attention",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jm, tm = models
    tok = tm.tokenizer
    messages = [{"role": "system", "content": "You are terse. " * 16},
                {"role": "user", "content": "Tell me about flash kernels."}]
    ids = tok.chat_prompt_ids(messages)
    assert len(ids) > 256                # two chunks: fresh flash + tail
    want, _ = jm.generate(ids, max_new_tokens=10, spec=False)
    eng = ServeEngine(tm, slots=2, ctx_len=512)
    submitted = []
    submit = eng.submit
    eng.submit = lambda *a, **k: submitted.append(submit(*a, **k)) or \
        submitted[-1]
    app = create_app(tm, eng, tok, port=0).start()
    try:
        body = {"messages": messages, "temperature": 0, "max_tokens": 10}
        status, raw = _post(app.url, body)
        resp = json.loads(raw)
        assert status == 200
        ended = tm.cfg.is_eos(want[-1])
        assert resp["usage"] == {
            "prompt_tokens": len(ids), "completion_tokens": len(want),
            "total_tokens": len(ids) + len(want),
            "tokens_per_second": resp["usage"]["tokens_per_second"]}
        assert resp["choices"][0]["finish_reason"] == \
            ("stop" if ended else "length")
        content_ids = want[:-1] if ended else want
        assert resp["choices"][0]["message"]["content"] == \
            tok.decode(content_ids)
        status, raw = _post(app.url, {**body, "stream": True})
        events = [ln[6:] for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")]
        assert status == 200 and events[-1] == "[DONE]"
        chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
        assert chunks[0]["delta"] == {"role": "assistant"}
        streamed = [c["delta"]["content"] for c in chunks[1:-1]]
        # one chunk per token, but a character split over tokens goes out
        # whole with its last one; the chunks join to the JSON content
        ts = TextStream(tok)
        want_chunks = [d for d in map(ts.push, content_ids) if d]
        assert streamed == want_chunks + ([ts.flush()] if ts.pending else [])
        assert "".join(streamed) == tok.decode(content_ids)
        assert chunks[-1]["finish_reason"] == ("stop" if ended else "length")
        assert [r.result["tokens"] for r in submitted] == [want, want]
        with urllib.request.urlopen(app.url + "/health", timeout=30) as r:
            assert json.loads(r.read())["engine"]["alive"]
        with urllib.request.urlopen(app.url + "/v1/models", timeout=30) as r:
            assert json.loads(r.read())["data"][0]["id"]
    finally:
        app.stop()


def test_text_stream_fuses_characters_split_over_tokens():
    """Byte-fallback tokens of one character (€ = three <0xNN> tokens, 𝄞
    four) come out as one delta with the last of them; the deltas join to
    the whole decode, and none holds a replacement character."""
    from cake_tpu_torch.bench.synth_checkpoint import gemma_tokenizer_json
    from cake_tpu_torch.utils.bpe import JsonTokenizer
    tok = JsonTokenizer(gemma_tokenizer_json(vocab_size=1000))
    text = "a€b 𝄞 naïve 你好"
    ids = tok.encode(text, add_special_tokens=False)
    assert len(ids) > len(text)           # bytes of characters with no piece
    ts = TextStream(tok)
    deltas = [d for d in map(ts.push, ids) if d] + [ts.flush()]
    assert "".join(deltas) == tok.decode(ids) == text
    assert not any("\ufffd" in d for d in deltas)
    assert "€" in deltas and "𝄞" in deltas
    # a byte run that never completes is let out after MAX_PENDING tokens
    byte = tok.vocab["<0xE2>"]
    ts = TextStream(tok)
    out = [ts.push(byte) for _ in range(TextStream.MAX_PENDING)]
    assert out[:-1] == [""] * 3 and out[-1] == "\ufffd" * 4
