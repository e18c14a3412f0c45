"""The port's HTTP server with the admission and metrics planes (api/qos.py,
api/obs_routes.py, api/text.py) on a tiny CPU model carried from the JAX
package:

  * every new route: /metrics (text exposition, bounded endpoint labels),
    /api/v1/trace (409 while the recorder is off; serve.step,
    serve.prefill_chunk and api.chat_prompt spans once on; ?clear=1),
    /api/v1/requests and /api/v1/requests/<id> (the enqueue -> admit ->
    prefill_chunk -> first_token -> finish timeline, ?format=perfetto,
    404), /api/v1/slo (histograms with exemplar ids), /api/v1/flight
    (?n=), and /health's device block;
  * X-Cake-Request-Id adopted as the request id and echoed (JSON and
    SSE), the completion id an alias of it, the chat's greedy tokens the
    JAX model's;
  * the refusals with their headers, on the blocking and the SSE path:
    429 tenant_quota (the body the JAX package's TenantQuotaExceeded
    gives), 429 for a full class lane with the class-aware Retry-After
    the JAX package computes, 503 + Retry-After for the queue deadline,
    504 for the request deadline (the SSE path's pre-commit mapping
    through a stand-in engine: a real stream commits once admitted), 400
    for an unknown class; each deadline counter moves by exactly one per
    expiry, a 504 frees its slot, and a tenant's inflight lease is
    released exactly once whatever the outcome.
Engines are paced with the fault hook's delay_ms where a test needs a
slot held; every wait has a timeout and every server is stopped."""
import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.serve.admission import classes as jcls
from cake_tpu.serve.admission import tenants as jten
from cake_tpu_torch import obs
from cake_tpu_torch.api import create_app
from cake_tpu_torch.api.text import decode_text
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import (RequestDeadlineExceeded, ServeEngine,
                                  faults)
from cake_tpu_torch.serve.admission import AdmissionPlane, TenantRegistry
from cake_tpu_torch.tokenizer import ByteTokenizer
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
VOCAB = 258
CTX = 256
GREEDY = SamplingConfig(temperature=0.0)


@pytest.fixture(autouse=True)
def _clean():
    was = obs.RECORDER.enabled
    yield
    faults.clear()
    obs.RECORDER.enabled = was


@pytest.fixture(scope="module")
def models():
    over = dict(vocab_size=VOCAB, max_position_embeddings=CTX)
    jm = JaxTextModel(jax_tiny_config("qwen3", **over), dtype=jnp.float32,
                      seed=3)
    cfg = tiny_config("qwen3", **over)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   tokenizer=ByteTokenizer(im_start_id=256, im_end_id=257),
                   dtype=torch.float32, device="cpu", max_cache_len=CTX)
    return jm, tm


class Server:
    def __init__(self, tm, plane=None, **engine_kw):
        engine_kw.setdefault("slots", 2)
        self.engine = ServeEngine(tm, ctx_len=CTX, **engine_kw)
        self.app = create_app(tm, self.engine, tm.tokenizer, port=0,
                              plane=plane).start()
        self.url = self.app.url

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.app.stop(drain_s=1.0)

    def get(self, path):
        try:
            with urllib.request.urlopen(self.url + path, timeout=60) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def chat(self, headers=None, stream=False, **body):
        payload = {"messages": [{"role": "user", "content": "hello"}],
                   "temperature": 0, "max_tokens": 4, "stream": stream,
                   **body}
        req = urllib.request.Request(
            self.url + "/v1/chat/completions",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()


def _hold(server, n=200, **kw):
    """A directly submitted request that holds a slot (paced by the
    caller's delay_ms), decoding before this returns."""
    r = server.engine.submit([5, 6, 7, 8], max_new_tokens=n,
                             sampling=GREEDY, **kw)
    deadline = time.monotonic() + 60
    while not r.tokens:
        assert time.monotonic() < deadline, "holder never decoded"
        time.sleep(0.002)
    return r


def _released(reg, tenant, timeout=10.0):
    """The tenant's inflight count once the handler has given its lease
    back. The lease is released in the chat handler's `finally`, after
    the error body is written (as in the reference), so a client can read
    the response before that thread gets there: wait for it, up to
    `timeout` seconds, then return what it reads."""
    deadline = time.monotonic() + timeout
    while reg.inflight_of(tenant) and time.monotonic() < deadline:
        time.sleep(0.005)
    return reg.inflight_of(tenant)


def test_routes_and_trace_id_adoption(models):
    jm, tm = models
    obs.RECORDER.disable()
    with Server(tm) as s:
        status, _, body = s.get("/api/v1/trace")
        assert status == 409 and "disabled" in json.loads(body)["error"]
        obs.RECORDER.enable()
        obs.RECORDER.clear()
        replays0 = s.engine.prefill.replays
        status, hdrs, raw = s.chat({"X-Cake-Request-Id": "trace-abc"})
        assert status == 200 and hdrs["X-Cake-Request-Id"] == "trace-abc"
        resp = json.loads(raw)
        prompt = tm.tokenizer.chat_prompt_ids(
            [{"role": "user", "content": "hello"}])
        want, _ = jm.generate(prompt, max_new_tokens=4, spec=False)
        assert s.engine.health()["slots_busy"] == 0
        # the timeline, by the adopted id and by the completion id
        status, _, raw = s.get("/api/v1/requests/trace-abc")
        tl = json.loads(raw)
        assert status == 200 and tl["request_id"] == "trace-abc"
        kinds = [e["kind"] for e in tl["events"]]
        order = [kinds.index(k) for k in ("received", "enqueue", "admit",
                                          "prefill_chunk", "prefill_done",
                                          "first_token", "finish")]
        assert order == sorted(order), kinds
        fin = tl["events"][-1]
        assert fin["outcome"] == "ok" and fin["tokens"] == len(want)
        assert [e["qos"] for e in tl["events"] if e["kind"] == "admit"] == \
            ["interactive"]
        status, _, raw = s.get(f"/api/v1/requests/{resp['id']}")
        assert status == 200 and json.loads(raw)["request_id"] == \
            "trace-abc"
        status, _, raw = s.get("/api/v1/requests/trace-abc?format=perfetto")
        assert {e["name"] for e in json.loads(raw)["traceEvents"]} >= \
            {"enqueue", "admit", "finish"}
        assert s.get("/api/v1/requests/nope")[0] == 404
        status, _, raw = s.get("/api/v1/requests")
        assert "trace-abc" in json.loads(raw)["requests"]
        # spans: one serve.prefill_chunk per prefill replay, the handler's
        # prompt span, the scheduler's steps
        status, _, raw = s.get("/api/v1/trace?clear=1")
        evs = json.loads(raw)["traceEvents"]
        names = [e["name"] for e in evs]
        assert names.count("serve.prefill_chunk") == \
            s.engine.prefill.replays - replays0 > 0
        assert "serve.step" in names and "api.chat_prompt" in names
        assert all(e["args"]["request_id"] == "trace-abc" for e in evs
                   if e["name"] in ("serve.prefill_chunk",
                                    "api.chat_prompt"))
        assert len(obs.RECORDER) == 0
        # the SSE path echoes the id too
        status, hdrs, raw = s.chat({"X-Cake-Request-Id": "trace-sse"},
                                   stream=True)
        assert status == 200 and hdrs["X-Cake-Request-Id"] == "trace-sse"
        assert raw.decode().rstrip().endswith("data: [DONE]")
        # /metrics: the chat's histograms and bounded endpoint labels
        assert s.get("/nope/a")[0] == 404
        status, hdrs, raw = s.get("/metrics")
        text = raw.decode()
        assert status == 200 and hdrs["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        for series in ("cake_serve_ttft_seconds_count{outcome=\"ok\"}",
                       "cake_serve_qos_ttft_seconds_count{qos="
                       "\"interactive\",outcome=\"ok\"}",
                       "cake_serve_itl_seconds_bucket",
                       "cake_serve_e2e_seconds_sum",
                       'endpoint="unmatched",status="404"',
                       'endpoint="/v1/chat/completions",status="200"'):
            assert series in text, series
        assert "/nope/a" not in text
        # /api/v1/slo: exemplars link a bucket to a request id
        status, _, raw = s.get("/api/v1/slo")
        slo = json.loads(raw)
        ok = [x for x in slo["cake_serve_ttft_seconds"]["series"]
              if x["labels"] == {"outcome": "ok"}][0]
        assert ok["count"] >= 2
        assert any(e["exemplar"] in ("trace-abc", "trace-sse")
                   or e["exemplar"].startswith("chatcmpl-")
                   for e in ok["exemplars"].values())
        # /api/v1/flight
        status, _, raw = s.get("/api/v1/flight?n=2")
        fl = json.loads(raw)
        assert status == 200 and fl["count"] == 2 and \
            fl["capacity"] == s.engine.flight.capacity
        assert json.loads(s.get("/api/v1/flight?n=bogus")[2])["count"] >= 2
        # /health keeps its body and adds the device block
        status, _, raw = s.get("/health")
        h = json.loads(raw)
        assert status == 200 and h["status"] == "ok"
        assert h["device"] == {"platform": "cpu"}
        assert h["engine"]["queue_by_class"] == {
            "interactive": 0, "standard": 0, "batch": 0}
    # greedy tokens of the adopted chat are the JAX model's
    assert resp["usage"]["completion_tokens"] == len(want)
    ended = tm.cfg.is_eos(want[-1])
    assert resp["choices"][0]["message"]["content"] == decode_text(
        tm.tokenizer, want[:-1] if ended else want)


def test_tenant_quota_429_on_both_paths(models):
    _, tm = models
    clock = [50.0]
    reg = TenantRegistry("t1:rps=1,burst=1;t2:inflight=1",
                         clock=lambda: clock[0])
    throttled = obs.SERVE_TENANT_THROTTLES.value(tenant="t1", reason="rate")
    with Server(tm, plane=AdmissionPlane(reg)) as s:
        assert s.chat({"X-Cake-Tenant": "t1"})[0] == 200
        want = jten.TenantQuotaExceeded("t1", "rate", retry_after_s=1)
        for stream in (False, True):
            status, hdrs, raw = s.chat({"X-Cake-Tenant": "t1"},
                                       stream=stream)
            assert status == 429 and hdrs["Retry-After"] == "1"
            assert hdrs["Content-Type"] == "application/json"
            assert json.loads(raw) == want.body()
        assert obs.SERVE_TENANT_THROTTLES.value(
            tenant="t1", reason="rate") == throttled + 2
        # another tenant, and anonymous requests, are unaffected
        assert s.chat({"X-Cake-Tenant": "t9"})[0] == 200
        assert s.chat()[0] == 200
        clock[0] += 1.0                      # refills one token
        assert s.chat({"X-Cake-Tenant": "t1"}, stream=True)[0] == 200
        # an unknown class is a 400, before any quota is charged
        status, _, raw = s.chat({"X-Cake-QoS": "gold"})
        assert status == 400 and "unknown QoS class" in \
            json.loads(raw)["error"]
        assert _released(reg, "t1") == 0


def test_class_lane_full_429_with_class_aware_retry_after(models):
    _, tm = models
    faults.install("delay_ms=20")
    with Server(tm, slots=1, max_queue=4,
                qos_bounds={"batch": 1}) as s:
        holder = _hold(s)
        queued = s.engine.submit([9, 9, 9], max_new_tokens=2,
                                 sampling=GREEDY, qos="batch")
        weights = s.engine.queue.weights
        for stream in (False, True):
            status, hdrs, raw = s.chat({"X-Cake-QoS": "batch"},
                                       stream=stream)
            assert status == 429
            assert int(hdrs["Retry-After"]) == \
                jcls.retry_after_for(1, "batch", weights)
            assert json.loads(raw)["qos"] == "batch"
        # the interactive lane stays open: that chat queues and answers
        out = {}
        th = threading.Thread(target=lambda: out.update(r=s.chat()))
        th.start()
        deadline = time.monotonic() + 30
        while s.engine.queue.depth_of("interactive") == 0 and \
                th.is_alive():
            assert time.monotonic() < deadline
            time.sleep(0.005)
        holder.cancel()
        queued.cancel()
        th.join(120)
        assert out["r"][0] == 200


def test_queue_deadline_503_on_both_paths(models):
    _, tm = models
    before = obs.SERVE_QUEUE_TIMEOUTS.value()
    faults.install("delay_ms=20")
    reg = TenantRegistry("t2:inflight=1")
    with Server(tm, plane=AdmissionPlane(reg), slots=1,
                queue_deadline_s=0.3) as s:
        holder = _hold(s)
        for stream in (False, True):
            status, hdrs, raw = s.chat({"X-Cake-Tenant": "t2"},
                                       stream=stream)
            assert status == 503 and int(hdrs["Retry-After"]) >= 1
            assert hdrs["Content-Type"] == "application/json"
            assert "expired in admission queue" in json.loads(raw)["error"]
            # the inflight lease came back: the next chat is not a 429
            assert _released(reg, "t2") == 0
        assert obs.SERVE_QUEUE_TIMEOUTS.value() == before + 2
        assert not holder.done.is_set()
        holder.cancel()
        assert holder.wait(60)
        assert s.chat({"X-Cake-Tenant": "t2"})[0] == 200
        assert obs.SERVE_QUEUE_TIMEOUTS.value() == before + 2


def test_request_deadline_504_frees_the_slot(models):
    _, tm = models
    before = obs.SERVE_REQUEST_TIMEOUTS.value()
    faults.install("delay_ms=20")
    reg = TenantRegistry("t3:inflight=1")
    with Server(tm, plane=AdmissionPlane(reg), slots=1,
                request_deadline_s=0.5) as s:
        t0 = time.monotonic()
        status, hdrs, raw = s.chat({"X-Cake-Tenant": "t3",
                                    "X-Cake-Request-Id": "late-1"},
                                   max_tokens=200)
        took = time.monotonic() - t0
        assert status == 504 and "deadline" in json.loads(raw)["error"]
        assert took < 30
        assert obs.SERVE_REQUEST_TIMEOUTS.value() == before + 1
        assert s.engine.health()["slots_busy"] == 0
        assert _released(reg, "t3") == 0
        kinds = [e["kind"] for e in
                 json.loads(s.get("/api/v1/requests/late-1")[2])["events"]]
        assert kinds[-1] == "finish" and "first_token" in kinds
        faults.clear()
        # the freed slot takes the next chat at once
        assert s.chat({"X-Cake-Tenant": "t3"})[0] == 200
        assert obs.SERVE_REQUEST_TIMEOUTS.value() == before + 1


class _DoneEngine:
    """A stand-in engine whose every request has already failed with
    `err` before admission (what the SSE path's pre-commit check sees)."""

    def __init__(self, err):
        self.err = err

    def submit(self, prompt_ids, request_id=None, **kw):
        req = SimpleNamespace(id=request_id, admitted=threading.Event(),
                              done=threading.Event(),
                              result={"error": self.err},
                              wait=lambda timeout=None: True)
        req.done.set()
        return req

    def drain(self, timeout=None):
        return True

    def close(self):
        pass


def test_sse_precommit_maps_the_request_deadline_to_504(models):
    _, tm = models
    err = RequestDeadlineExceeded(3.0, 2.0)
    app = create_app(tm, _DoneEngine(err), tm.tokenizer, port=0).start()
    try:
        for stream in (True, False):
            req = urllib.request.Request(
                app.url + "/v1/chat/completions", data=json.dumps(
                    {"messages": [{"role": "user", "content": "x"}],
                     "stream": stream}).encode())
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=60)
            assert ei.value.code == 504
            assert ei.value.headers["Content-Type"] == "application/json"
            assert json.loads(ei.value.read())["error"] == str(err)
    finally:
        app.stop(drain_s=0.1)
