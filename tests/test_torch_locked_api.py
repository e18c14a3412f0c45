"""The locked one-request path of the port's chat API (api/state.py and
the fallback in api/text.py; the reference's _chat_blocking,
_chat_stream and run_generation_streamed), served for a model the engine
does not serve: an offloaded tiny Qwen3-MoE (module 10b) and a resident
one with CAKE_SERVE_SLOTS=0, both carried from the JAX package, beside
an engine server of the same weights:

  * JSON and SSE answers carry the JAX model's greedy text, and the same
    content, usage and finish_reason as the engine path's answer;
  * concurrent requests are served one at a time (a counter inside
    generate never sees two), each with the greedy answer;
  * `stop` trims the JSON answer and ends the stream at the match, and
    `"continue"` continues the partial turn, as on the engine path;
  * the tenant quota answers 429 as on the engine path; /health and
    /metrics answer with no engine, and a draining server refuses a new
    chat with 503."""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.api import text as ref_text
from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny
from cake_tpu.models.common.layers import init_params as jax_init
from cake_tpu.ops.sampling import SamplingConfig as JaxSampling
from cake_tpu.utils.export import params_to_hf_tensors as jax_export
from cake_tpu.utils.safetensors_io import save_safetensors as jax_save
from cake_tpu_torch.api import create_app
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common.offload_model import OffloadedTextModel
from cake_tpu_torch.serve import ServeEngine
from cake_tpu_torch.serve.admission import AdmissionPlane, TenantRegistry
from cake_tpu_torch.serve.engine import maybe_engine
from cake_tpu_torch.tokenizer import ByteTokenizer
from cake_tpu_torch.utils import params_from_numpy
from cake_tpu_torch.utils.loaders import load_model_params

torch.set_num_threads(1)
CTX = 256
MAX_TOKENS = 16
CHAT = [{"role": "user", "content": "Tell me about the card."}]
OVER = dict(vocab_size=258, max_position_embeddings=CTX)


class _Counting:
    """Wraps a model's generate with a count of generations in flight,
    keeping the most it ever saw."""

    def __init__(self, model):
        self.model, self.active, self.most = model, 0, 0
        self.lock = threading.Lock()
        inner = model.generate

        def generate(*a, **k):
            with self.lock:
                self.active += 1
                self.most = max(self.most, self.active)
            try:
                return inner(*a, **k)
            finally:
                with self.lock:
                    self.active -= 1
        model.generate = generate


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"offload", "slots_0", "engine"} -> (server, counter or None), the
    JAX model, and the byte tokenizer."""
    d = str(tmp_path_factory.mktemp("moe"))
    jcfg = jax_tiny("qwen3_moe", **OVER)
    params = jax_init(jcfg, jax.random.PRNGKey(4), jnp.float32)
    jax_save(f"{d}/model.safetensors", jax_export(jcfg, params))
    with open(f"{d}/config.json", "w") as f:
        json.dump({}, f)
    jm = JaxTextModel(jcfg, params=params, dtype=jnp.float32,
                      max_cache_len=CTX)
    cfg = tiny_config("qwen3_moe", **OVER)
    tok = ByteTokenizer(im_start_id=256, im_end_id=257)
    om = OffloadedTextModel(cfg, load_model_params(
        cfg, d, torch.float32, "cpu", expert_offload=True, expert_lru_size=3),
        tokenizer=tok, dtype=torch.float32, device="cpu", max_cache_len=CTX)
    tree = jax.tree_util.tree_map(np.asarray, params)

    def resident():
        return TextModel(cfg, params_from_numpy(cfg, tree, "cpu",
                                                torch.float32),
                         tokenizer=tok, dtype=torch.float32, device="cpu",
                         max_cache_len=CTX)
    locked = resident()
    assert maybe_engine(om) is None
    assert maybe_engine(locked, {"CAKE_SERVE_SLOTS": "0"}) is None
    engine_model = resident()
    apps = {"offload": (create_app(om, None, tok, port=0), _Counting(om)),
            "slots_0": (create_app(locked, None, tok, port=0),
                        _Counting(locked)),
            "engine": (create_app(engine_model, ServeEngine(
                engine_model, slots=2, max_queue=8, ctx_len=CTX), tok,
                port=0), None)}
    for app, _ in apps.values():
        app.start()
    yield apps, jm, tok
    for app, _ in apps.values():
        app.stop(drain_s=5)


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _sse(raw: bytes) -> tuple[str, str]:
    """(content, finish_reason) of an SSE body."""
    events = [ln[6:] for ln in raw.decode().splitlines()
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
    assert chunks[0]["delta"] == {"role": "assistant"}
    return ("".join(c["delta"]["content"] for c in chunks[1:-1]),
            chunks[-1]["finish_reason"])


def _answer(app, body) -> dict:
    """content and finish_reason (and usage, JSON only) of one chat."""
    status, raw = _post(app.url, body)
    assert status == 200, raw
    if body.get("stream"):
        content, finish = _sse(raw)
        return {"content": content, "finish": finish}
    r = json.loads(raw)
    return {"content": r["choices"][0]["message"]["content"],
            "finish": r["choices"][0]["finish_reason"], "usage": {
                k: r["usage"][k] for k in ("prompt_tokens",
                                           "completion_tokens",
                                           "total_tokens")}}


@pytest.fixture(scope="module")
def greedy(servers):
    """The JAX model's greedy content of CHAT."""
    _, jm, tok = servers
    toks, _ = jm.generate(tok.chat_prompt_ids(CHAT), max_new_tokens=MAX_TOKENS,
                          sampling=JaxSampling(temperature=0.0), spec=False)
    ended = jm.cfg.is_eos(toks[-1])
    return tok.decode(toks[:-1] if ended else toks)


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
@pytest.mark.parametrize("which", ["offload", "slots_0"])
def test_locked_answer_equals_jax_and_engine(servers, greedy, which, stream):
    apps, _, _ = servers
    body = {"messages": CHAT, "temperature": 0, "max_tokens": MAX_TOKENS,
            "stream": stream}
    got = _answer(apps[which][0], body)
    assert got == _answer(apps["engine"][0], body)
    assert got["content"] == greedy


@pytest.mark.parametrize("which", ["offload", "slots_0"])
def test_concurrent_requests_never_overlap(servers, greedy, which):
    apps, _, _ = servers
    app, counter = apps[which]
    counter.most = 0
    results = [None] * 3

    def chat(i):
        results[i] = _answer(app, {"messages": CHAT, "temperature": 0,
                                   "max_tokens": MAX_TOKENS,
                                   "stream": i == 1})
    threads = [threading.Thread(target=chat, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a locked request hung"
    assert counter.most == 1
    assert [r["content"] for r in results] == [greedy] * 3


def _stop_of(content: str) -> str:
    """A two-character stop sequence first found past the third
    character (random weights emit stray bytes: none with U+FFFD)."""
    for i in range(3, len(content) - 1):
        piece = content[i:i + 2]
        if "�" not in piece and content.index(piece) == i:
            return piece
    raise AssertionError(f"no stop sequence in {content!r}")


@pytest.mark.parametrize("case", ["stop_json", "stop_sse", "continue"])
@pytest.mark.parametrize("which", ["offload", "slots_0"])
def test_stop_and_continue_equal_engine_path(servers, greedy, which, case):
    apps, _, _ = servers
    if case == "continue":
        messages = CHAT + [{"role": "assistant", "content": greedy[:5],
                            "continue": True}]
        body = {"messages": messages, "temperature": 0, "max_tokens": 8}
    else:
        stop = _stop_of(greedy)
        want, matched = ref_text.apply_stop(greedy, [stop])
        assert matched
        body = {"messages": CHAT, "temperature": 0,
                "max_tokens": MAX_TOKENS, "stop": stop,
                "stream": case == "stop_sse"}
    got = _answer(apps[which][0], body)
    engine = _answer(apps["engine"][0], body)
    if case == "stop_json":
        # the locked path trims; the engine cancels at the match, so its
        # completion counts fewer tokens
        got.pop("usage")
        engine.pop("usage")
    assert got == engine
    if case != "continue":
        assert got["content"] == want and got["finish"] == "stop"


def test_tenant_quota_health_metrics_and_drain(servers):
    apps, _, tok = servers
    app, counter = apps["offload"]
    limited = create_app(counter.model, None, tok, port=0, plane=AdmissionPlane(
        TenantRegistry("limited:rps=0.001,burst=1"))).start()
    try:
        body = {"messages": CHAT, "temperature": 0, "max_tokens": 2}
        head = {"X-Cake-Tenant": "limited"}
        assert _post(limited.url, body, head)[0] == 200
        status, raw = _post(limited.url, body, head)
        assert status == 429 and b"tenant" in raw
        with urllib.request.urlopen(limited.url + "/health", timeout=30) as r:
            h = json.loads(r.read())
        assert r.status == 200 and h["status"] == "ok" and "engine" not in h
        assert h["device"] == {"platform": "cpu"}
        with urllib.request.urlopen(limited.url + "/metrics",
                                    timeout=30) as r:
            assert b"cake_generations_total" in r.read()
        limited.state.draining = True
        status, raw = _post(limited.url, {"messages": CHAT}, {})
        assert status == 503
    finally:
        limited.stop(drain_s=5)
