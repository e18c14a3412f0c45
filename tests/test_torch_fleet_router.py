"""The port's fleet router (fleet/router.py on fleet/http.py) against the
JAX package's aiohttp router, scenario by scenario.

One standard-library fake replica, written here, stands behind both: a
ThreadingHTTPServer that answers JSON and SSE chats (a role chunk, one
content chunk per token "tok<i>" under a replica-scoped completion id,
a finish chunk, [DONE]), continuation mode with the continuation-chars
handshake, /health, and the reference FakeReplica's behaviours (a 500,
a 429, a hang, a slow stream, an abrupt sever after N content chunks, a
continuation that re-emits the splice boundary). Its SSE is chunked, so
a sever is a truncated body to both routers' clients. For each router
scenario of the reference's tests/test_fleet.py, the same client steps
run against each router over fresh fakes, and the statuses, bodies (the
one field that names the client library's exception masked), SSE
events, router timelines, the replica every attempt reached, the
registry's membership and the fleet counter deltas are equal.

The fake also plays module 15b's replica half: /health advertises a
KV-share chain inventory, the X-Cake-KV-Peers directory and the
X-Cake-KV-Resume header an attempt carries are recorded (the directory's
URLs by replica name), /api/v1/kv/stream/<rid> answers a parked blob (or
404) and stages a posted one (or fails), and a resume leg that adopts a
staged blob answers X-Cake-KV-Resumed and replays the stream from token
0. The KV-share scenarios (directory injection and its retraction on an
eject, a migration shipped / source_miss / ship_error, the cumulative
strip) and the closed loop's views run through both routers alike.

Port-only cases: a close-delimited replica (the port's own HTTP/1.0
answer) whose EOF before [DONE] is a break and after it a clean end; the
views of module 15b's switches; and, end to end, the port's router in
front of two port replicas (a 2-layer qwen3 in float32 on the CPU behind
real api/server.py servers) with one replica's stream broken by a fault
plan: the spliced content equals the unbroken greedy stream, and equals
the JAX router in front of two JAX replicas with the same weights; and
the same two port replicas with the KV-share tier on, one drained
mid-stream: its swap blob moves to the other, and the body equals the
unbroken stream."""
import asyncio
import base64
import gc
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from cake_tpu import fleet as ref_fleet
from cake_tpu import obs as ref_obs
from cake_tpu.fleet import faults as ref_faults
from cake_tpu_torch import fleet, obs
from cake_tpu_torch.fleet import faults
from cake_tpu_torch.fleet.http import request

SYSTEM = {"role": "system", "content": "You are a terse assistant. " * 4}
PASSTHROUGH = ("X-Cake-QoS", "X-Cake-Tenant", "Authorization")
KV_PEERS, KV_RESUME, KV_RESUMED = ("X-Cake-KV-Peers", "X-Cake-KV-Resume",
                                   "X-Cake-KV-Resumed")


@pytest.fixture(autouse=True)
def _collect_reference_engines():
    """JAX models and engines built here are collected after each test."""
    yield
    gc.collect()


# -- the fake replica ---------------------------------------------------------

class FakeReplica:
    """Canned `serve` stand-in on the standard library (see the module
    docstring). `framing`: "chunked" (a sever truncates the body) or
    "close" (HTTP/1.0-style close-delimited SSE, as the port's replicas
    answer)."""

    N_TOKS = 4

    def __init__(self, name: str, framing: str = "chunked"):
        self.name = name
        self.framing = framing
        self.mode = "ok"
        self.break_after = 2
        self.served = []            # prompts this replica admitted
        self.continuations = []     # partial contents it spliced
        self.headers = []           # passthrough headers per request
        self.release = threading.Event()
        # module 15b: the advertised chains, the parked blob answer of
        # GET /api/v1/kv/stream/<rid> (None = 404), the status a posted
        # blob gets, and the blobs staged here by rid
        self.chains = []
        self.park = None
        self.ship_status = 200
        self.staged = {}
        self.names = {}             # peer base URL -> replica name
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, status, obj, extra=None):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Connection", "close")
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)
                self.close_connection = True

            def do_GET(self):
                if self.path == "/health":
                    engine = {"alive": True, "slots": 2, "queue_depth": 0}
                    if fake.chains:
                        engine["kvshare"] = {"chains": list(fake.chains),
                                             "parked": 0, "inbound": 0}
                    return self._json(200, {"engine": engine})
                if self.path.startswith("/api/v1/kv/stream/"):
                    if fake.park is None:
                        return self._json(404, {"error": "not parked"})
                    data = fake.park
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-cake-kv-blob")
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.write(data)
                    self.close_connection = True
                    return
                if self.path == "/v1/models":
                    return self._json(200, {"object": "list", "data": [
                        {"id": f"model-{fake.name}", "object": "model"}]})
                if self.path == "/metrics":
                    data = b"cake_serve_queue_depth 0\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.write(data)
                    self.close_connection = True
                    return
                return self._json(404, {"error": "not found"})

            def _write(self, data: bytes):
                if fake.framing == "chunked":
                    data = b"%x\r\n" % len(data) + data + b"\r\n"
                self.wfile.write(data)
                self.wfile.flush()

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n)
                self.close_connection = True
                if self.path.startswith("/api/v1/kv/stream/"):
                    rid = self.path.rsplit("/", 1)[1]
                    if fake.ship_status == 200:
                        fake.staged[rid] = raw
                    return self._json(fake.ship_status, {"rid": rid})
                body = json.loads(raw)
                seen = {h: self.headers.get(h) for h in PASSTHROUGH
                        if self.headers.get(h)}
                peers = self.headers.get(KV_PEERS)
                if peers is not None:
                    seen["kv_peers"] = sorted(
                        (fake.names.get(p["u"], p["u"]), sorted(p["k"]))
                        for p in json.loads(peers)["p"])
                resume = self.headers.get(KV_RESUME)
                if resume:
                    seen["kv_resume"] = resume in fake.staged
                fake.headers.append(
                    seen | {"rid": bool(self.headers.get("X-Cake-Request-Id"))})
                if fake.mode == "http500":
                    return self._json(500, {"error": "boom"})
                if fake.mode == "http429":
                    return self._json(429, {"error": "queue full"},
                                      {"Retry-After": "3"})
                if fake.mode == "hang":
                    fake.release.wait(20)
                msgs = body["messages"]
                start = 0
                cont = bool(msgs and msgs[-1].get("continue"))
                adopted = bool(resume) and resume in fake.staged
                if adopted:
                    # an adopted blob replays the stream from token 0
                    cont = False
                    fake.served.append("adopted:" + msgs[-1]["content"])
                elif cont:
                    partial = msgs[-1]["content"]
                    fake.continuations.append(partial)
                    start = partial.count("tok")
                    if fake.mode == "overlap_resume" and start > 0:
                        start -= 1
                if not adopted:
                    fake.served.append(msgs[-1]["content"])
                if not body.get("stream"):
                    return self._json(200, {
                        "id": "x", "object": "chat.completion",
                        "served_by": fake.name,
                        "choices": [{"index": 0, "message": {
                            "role": "assistant", "content": "hi"},
                            "finish_reason": "stop"}]})
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                if fake.framing == "chunked":
                    self.send_header("Transfer-Encoding", "chunked")
                self.send_header("Connection", "close")
                if cont:
                    self.send_header(
                        "X-Cake-Continuation-Chars",
                        str(len("".join(f"tok{i}" for i in range(start)))))
                if adopted:
                    self.send_header(KV_RESUMED, "1")
                self.end_headers()

                def chunk(delta, finish=None):
                    return b"data: " + json.dumps({
                        "id": f"chatcmpl-{fake.name}", "created": 1000,
                        "choices": [{"index": 0, "delta": delta,
                                     "finish_reason": finish}],
                    }).encode() + b"\n\n"
                last = 12 if fake.mode == "slow_stream" else fake.N_TOKS
                try:
                    self._write(chunk({"role": "assistant"}))
                    for i in range(start, last):
                        if fake.mode == "slow_stream":
                            time.sleep(0.05)
                        if fake.mode == "abrupt" \
                                and i - start >= fake.break_after:
                            return          # close without the end
                        self._write(chunk({"content": f"tok{i}"}))
                    if fake.mode == "abrupt" \
                            and last - start <= fake.break_after:
                        return              # eat the finish / [DONE]
                    self._write(chunk({}, "stop"))
                    self._write(b"data: [DONE]\n\n")
                    if fake.framing == "chunked":
                        self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    @property
    def url(self) -> str:
        return "http://127.0.0.1:%d" % self.httpd.server_address[1]

    def stop(self):
        self.release.set()
        self.httpd.shutdown()
        self.httpd.server_close()


# -- the two routers ----------------------------------------------------------

def _policy(mod, **kw):
    base = dict(eject_fails=3, err_window=16, err_rate=0.5,
                degraded_ttft_ms=0.0, eject_s=0.05, replica_inflight=0)
    base.update(kw)
    return mod.MembershipPolicy(**base)


class Env:
    """One router (the port's or the reference's) over fresh fakes, and
    the client steps a scenario takes against it."""

    def __init__(self, kind: str, n: int, framing: str = "chunked",
                 **router_kw):
        self.kind = kind
        self.pkg = fleet if kind == "port" else ref_fleet
        self.obs = obs if kind == "port" else ref_obs
        self.faults = faults if kind == "port" else ref_faults
        self.replicas = [FakeReplica(f"r{i}", framing) for i in range(n)]
        for rep in self.replicas:
            rep.names = {r.url: r.name for r in self.replicas}
        self.registry = self.pkg.ReplicaRegistry(_policy(self.pkg))
        for rep in self.replicas:
            self.registry.add(rep.name, rep.url)
        kw = dict(retries=2, backoff_s=0.001, probe_s=30.0, hedge_ms=0.0)
        kw.update(router_kw)
        self.router = self.pkg.FleetRouter(self.registry, **kw)
        self.rids = []

    async def start(self):
        app = self.pkg.create_router_app(self.router)
        if self.kind == "port":
            host, port = await app.start("127.0.0.1", 0)
            self._app = app
            self.url = f"http://{host}:{port}"
        else:
            from aiohttp.test_utils import TestServer
            self._server = TestServer(app)
            await self._server.start_server()
            self.url = str(self._server.make_url("")).rstrip("/")
        self.before = counters(self.obs)

    async def stop(self):
        self.faults.clear()
        for rep in self.replicas:
            rep.release.set()
        if self.kind == "port":
            await self._app.stop()
        else:
            await self._server.close()
        for rep in self.replicas:
            rep.stop()

    async def post(self, body, headers=None, path="/v1/chat/completions",
                   keep_rid=True):
        r = await asyncio.wait_for(request(
            "POST", self.url + path, json_body=body, headers=headers), 30)
        async with r:
            data = await asyncio.wait_for(r.read(), 30)
            # hold the connection until the router's handler has returned:
            # aiohttp cancels a handler whose client has gone, which would
            # race its last bookkeeping (the `done` event) against our close
            for _ in range(200 if r.content_type == "text/event-stream"
                           else 0):
                if not self.router.inflight:
                    break
                await asyncio.sleep(0.01)
        rid = r.headers.get("X-Cake-Request-Id")
        if rid and keep_rid:
            self.rids.append(rid)
        return r.status, r.headers, data

    async def get(self, path):
        r = await asyncio.wait_for(request("GET", self.url + path), 30)
        async with r:
            return r.status, await r.read()

    def owner(self):
        return next(rep for rep in self.replicas if rep.served)

    def other(self, owner):
        return next(rep for rep in self.replicas if rep is not owner)

    def events(self, rid):
        tl = self.router.timelines.get(rid)
        return [] if tl is None else [
            {k: v for k, v in e.items() if k not in ("t_ms", "ttfb_ms")}
            for e in tl["events"]]


COUNTED = ("FLEET_SHEDS", "FLEET_PROXIED", "FLEET_RETRIES", "FLEET_HEDGES",
           "FLEET_STREAM_RESUMES", "FLEET_EJECTS", "FLEET_READMITS",
           "FLEET_KV_MIGRATIONS", "FLEET_SCALE_ACTIONS")


def counters(o) -> dict:
    out = {}
    for name in COUNTED:
        m = getattr(o, name)
        for ls in (m.labelsets() if m.labelnames else [{}]):
            out[(name, tuple(sorted(ls.items())))] = m.value(**ls)
    return out


def _deltas(env) -> dict:
    after = counters(env.obs)
    return {k: v - env.before.get(k, 0.0) for k, v in after.items()
            if v - env.before.get(k, 0.0)}


def _sse_events(data: bytes) -> list:
    out = []
    for line in data.decode().split("\n\n"):
        if not line.startswith("data: "):
            continue
        payload = line[6:]
        out.append(payload if payload.strip() == "[DONE]"
                   else json.loads(payload))
    return out


def _content(events) -> str:
    return "".join(e["choices"][0]["delta"].get("content") or ""
                   for e in events if isinstance(e, dict) and "choices" in e)


def _mask(obj):
    """The exception text the client libraries word differently."""
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in ("last", "message") else _mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def answer(status, headers, data) -> dict:
    ctype = (headers.get("Content-Type") or "").split(";")[0]
    if ctype == "text/event-stream":
        body = _sse_events(data)
    else:
        try:
            body = json.loads(data)
        except ValueError:
            body = data.decode()
    return {"status": status, "retry_after": headers.get("Retry-After"),
            "body": _mask(body)}


def _chat(content="hello", stream=False, **kw):
    return {"messages": [SYSTEM, {"role": "user", "content": content}],
            "max_tokens": 8, "temperature": 0.0, "stream": stream, **kw}


# -- scenarios (tests/test_fleet.py's, one client script each) ----------------

async def sc_proxy_and_stickiness(env):
    out = []
    for turn in range(4):
        out.append(answer(*await env.post(
            _chat("same convo"), headers={"X-Cake-QoS": "batch",
                                          "X-Cake-Tenant": "acme",
                                          "Authorization": "Bearer k"})))
    served = sorted(len(r.served) for r in env.replicas)
    assert served == [0, 0, 4], served
    return out


async def sc_failover_and_eject(env):
    out = [answer(*await env.post(_chat("convo A")))]
    owner = env.owner()
    owner.mode = "http500"
    for _ in range(8):
        out.append(answer(*await env.post(_chat("convo A"))))
    assert all(a["status"] == 200 for a in out)
    assert env.registry.get(owner.name).snapshot()["state"] == "ejected"
    return out


async def sc_retry_budget_503(env):
    for rep in env.replicas:
        rep.mode = "http500"
    a = answer(*await env.post(_chat()))
    assert a["status"] == 503 and a["body"]["attempts"] == 3
    assert a["body"]["shed_by"] == "router"
    return a


async def sc_first_byte_deadline(env):
    out = [answer(*await env.post(_chat("convo A")))]
    owner = env.owner()
    owner.mode = "hang"
    t0 = time.monotonic()
    out.append(answer(*await env.post(_chat("convo A"))))
    out.append(answer(*await env.post(_chat("convo A", stream=True))))
    bounded = time.monotonic() - t0 < 5.0
    owner.release.set()
    assert bounded and out[-1]["body"][-1] == "[DONE]"
    return out, bounded


async def sc_shed_429(env):
    env.replicas[0].mode = "hang"
    first = asyncio.ensure_future(env.post(_chat("first")))
    await asyncio.sleep(0.2)
    shed = answer(*await env.post(_chat("second")))
    served_during = len(env.replicas[0].served)
    env.replicas[0].mode = "ok"
    env.replicas[0].release.set()
    done = answer(*await first)
    assert shed["status"] == 429 and shed["body"]["shed_by"] == "router"
    return shed, done, served_during


async def sc_no_routable_replica(env):
    for _ in range(3):
        env.registry.get("r0").record_result(False, transport=True)
    a = answer(*await env.post(_chat()))
    assert a["status"] == 503
    return a


async def sc_replica_429_no_eject(env):
    for rep in env.replicas:
        rep.mode = "http429"
    a = answer(*await env.post(_chat()))
    assert a["status"] == 503
    return a


async def sc_pre_token_failover_mid_stream_error(env):
    out = [answer(*await env.post(_chat("s convo", stream=True)))]
    owner = env.owner()
    owner.mode = "http500"
    out.append(answer(*await env.post(_chat("s convo", stream=True))))
    owner.mode = "ok"
    env.faults.install(f"replica={owner.name};break_stream_after=2")
    a = answer(*await env.post(_chat("s convo", stream=True)))
    env.faults.clear()
    err = next(e["error"] for e in a["body"] if isinstance(e, dict)
               and "error" in e)
    assert err["type"] == "replica_stream_broken"
    assert err["resume"]["chunks_relayed"] == 2
    tok = json.loads(base64.urlsafe_b64decode(err["resume"]["resume_token"]))
    assert tok["tokens_generated"] == 1
    out.append(a)
    return out


async def sc_health_and_fleet_views(env):
    status, models = await env.get("/v1/models")
    assert status == 200 and json.loads(models)["data"][0]["id"] in (
        "model-r0", "model-r1")
    out = [await env.get("/health"), await env.get("/fleet")]
    status, metrics = await env.get("/metrics")
    assert b"cake_fleet_replicas" in metrics
    for name in ("r0", "r1"):
        for _ in range(3):
            env.registry.get(name).record_result(False, transport=True)
    out.append(await env.get("/health"))
    views = []
    for status, data in out:
        body = json.loads(data)
        for rep in (body.get("fleet") or body)["replicas"]:
            for wall in ("base_url", "state_age_s", "warm_age_s",
                         "partition_s"):
                rep.pop(wall)
        views.append((status, body))
    assert views[-1][0] == 503
    status, models = await env.get("/v1/models")    # nothing routable now
    assert status == 503
    return views, (status, json.loads(models))


async def sc_client_disconnect(env):
    env.replicas[0].mode = "slow_stream"
    r = await request("POST", env.url + "/v1/chat/completions",
                      json_body=_chat("bye", stream=True))
    got = b""
    async for piece in r.iter_any():
        got += piece
        if len(got) >= 16:
            break
    r.close()
    await asyncio.sleep(1.0)
    snap = env.registry.get("r0").snapshot()
    assert snap["state"] == "healthy" and snap["inflight"] == 0
    return r.status, {k: snap[k] for k in ("state", "consec_fails",
                                           "ejects", "inflight")}


async def sc_json_hedge(env):
    out = [answer(*await env.post(_chat("hedge convo")))]
    owner = env.owner()
    env.faults.install(f"replica={owner.name};stall_ms=1500")
    t0 = time.monotonic()
    out.append(answer(*await env.post(_chat("hedge convo"))))
    fast = time.monotonic() - t0 < 1.0
    env.faults.clear()
    assert fast and env.other(owner).served
    return out, fast


async def sc_stream_hedge(env):
    out = [answer(*await env.post(_chat("hs convo", stream=True)))]
    owner = env.owner()
    env.faults.install(f"replica={owner.name};stall_ms=1500")
    t0 = time.monotonic()
    out.append(answer(*await env.post(_chat("hs convo", stream=True))))
    fast = time.monotonic() - t0 < 1.0
    env.faults.clear()
    assert fast and _content(out[-1]["body"]) == "tok0tok1tok2tok3"
    return out, fast


async def sc_round_robin(env):
    out = [answer(*await env.post(_chat("same convo"))) for _ in range(6)]
    assert all(r.served for r in env.replicas)
    return out


async def sc_splice_resume_byte_identical(env):
    base = answer(*await env.post(_chat("heal convo", stream=True)))
    owner = env.owner()
    owner.mode = "abrupt"
    healed = answer(*await env.post(_chat("heal convo", stream=True)))
    assert _content(healed["body"]) == _content(base["body"]) \
        == "tok0tok1tok2tok3"
    assert env.other(owner).continuations == ["tok0tok1"]
    kinds = [e["kind"] for e in env.events(env.rids[-1])]
    for k in ("commit", "stream_broken", "stream_resume", "resume_spliced",
              "done"):
        assert k in kinds, (k, kinds)
    return base, healed


async def sc_overlap_strip(env):
    await env.post(_chat("ov convo", stream=True))
    owner = env.owner()
    owner.mode = "abrupt"
    env.other(owner).mode = "overlap_resume"
    a = answer(*await env.post(_chat("ov convo", stream=True)))
    assert _content(a["body"]) == "tok0tok1tok2tok3"
    spliced = next(e for e in env.events(env.rids[-1])
                   if e["kind"] == "resume_spliced")
    assert spliced["overlap_chars"] == len("tok1")
    return a


async def sc_resume_budget_exhausted(env):
    await env.post(_chat("ex convo", stream=True))
    owner = env.owner()
    other = env.other(owner)
    owner.mode = other.mode = "abrupt"
    other.break_after = 1
    a = answer(*await env.post(_chat("ex convo", stream=True)))
    assert _content(a["body"]) == "tok0tok1tok2"
    err = next(e["error"] for e in a["body"] if isinstance(e, dict)
               and "error" in e)
    assert err["resume"]["resumes_attempted"] == 1
    return a


async def sc_client_disconnect_during_resume(env):
    await env.post(_chat("cd convo", stream=True))
    owner = env.owner()
    other = env.other(owner)
    owner.mode = "abrupt"
    other.mode = "slow_stream"
    r = await request("POST", env.url + "/v1/chat/completions",
                      json_body=_chat("cd convo", stream=True))
    got = b""
    async for piece in r.iter_any():
        got += piece
        if len(got) >= 16:
            break
    await asyncio.sleep(0.2)
    r.close()
    await asyncio.sleep(1.0)
    snap = env.registry.get(other.name).snapshot()
    assert snap["state"] == "healthy" and snap["inflight"] == 0
    return {k: snap[k] for k in ("state", "consec_fails", "ejects",
                                 "inflight")}


async def sc_sampled_resume_flagged(env):
    body = _chat("sa convo", stream=True, temperature=0.8)
    await env.post(body)
    env.owner().mode = "abrupt"
    a = answer(*await env.post(body))
    ev = next(e for e in env.events(env.rids[-1])
              if e["kind"] == "stream_resume")
    assert ev.get("sampled") is True
    return a, ev


async def sc_break_after_complete(env):
    await env.post(_chat("bf convo", stream=True))
    owner = env.owner()
    owner.mode = "abrupt"
    owner.break_after = FakeReplica.N_TOKS
    a = answer(*await env.post(_chat("bf convo", stream=True,
                                     max_tokens=FakeReplica.N_TOKS)))
    chunks = [e for e in a["body"] if isinstance(e, dict)]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert not env.other(owner).continuations
    return a


async def sc_kv_directory_and_retraction(env):
    """Every attempt carries the OTHER replicas' mirrored inventories; an
    ejected peer's is retracted (no header at all once nothing is left),
    and the probe that follows a stale answer retracts it too."""
    env.replicas[0].chains = ["aa", "bb"]
    env.replicas[1].chains = ["cc"]
    await env.router._probe_once()
    out = [answer(*await env.post(_chat("kv convo")))]
    owner = env.owner()
    other = env.other(owner)
    out.append(answer(*await env.post(_chat("kv convo", stream=True))))
    for _ in range(3):
        env.registry.get(other.name).record_result(False, transport=True)
    out.append(answer(*await env.post(_chat("kv convo"))))
    other.chains = []
    owner.chains = []
    await env.router._probe_once()
    return out, [r.snapshot()["state"] for r in env.registry.replicas()]


async def sc_kv_migration_shipped(env):
    """A break on a replica that parked the stream's blob: the router
    ships it to the survivor, whose leg carries X-Cake-KV-Resume, adopts
    it and replays from token 0; the relay strips everything the client
    already has, by cumulative position."""
    base = answer(*await env.post(_chat("mig convo", stream=True)))
    owner = env.owner()
    other = env.other(owner)
    owner.mode = "abrupt"
    owner.park = b"CAKEKV-parked-blob"
    healed = answer(*await env.post(_chat("mig convo", stream=True)))
    assert _content(healed["body"]) == _content(base["body"])
    assert list(other.staged.values()) == [b"CAKEKV-parked-blob"]
    kinds = [e["kind"] for e in env.events(env.rids[-1])]
    assert kinds.index("stream_broken") < kinds.index("kv_migrate") \
        < kinds.index("resume_spliced") < kinds.index("done")
    return base, healed


async def sc_kv_migration_source_miss(env):
    await env.post(_chat("miss convo", stream=True))
    owner = env.owner()
    owner.mode = "abrupt"
    healed = answer(*await env.post(_chat("miss convo", stream=True)))
    assert _content(healed["body"]) == "tok0tok1tok2tok3"
    assert env.other(owner).continuations == ["tok0tok1"]
    return healed


async def sc_kv_migration_ship_error(env):
    await env.post(_chat("ship convo", stream=True))
    owner = env.owner()
    owner.mode = "abrupt"
    owner.park = b"CAKEKV-parked-blob"
    env.other(owner).ship_status = 500
    healed = answer(*await env.post(_chat("ship convo", stream=True)))
    assert _content(healed["body"]) == "tok0tok1tok2tok3"
    return healed


async def sc_autoscale_views(env):
    """The closed loop on with no spawn template: its decisions ring,
    policy and lifecycle view, and the telemetry body's summary."""
    await env.router._probe_once()
    out = []
    for path in ("/api/v1/fleet/autoscale", "/api/v1/fleet/telemetry"):
        status, data = await env.get(path)
        body = json.loads(data)
        body = body if "decisions" in body else body["autoscale"]
        out.append((status, _mask_clock(body)))
    return out


def _mask_clock(obj):
    """Ages and clock-derived figures masked."""
    if isinstance(obj, dict):
        return {k: ("<clock>" if k in ("age_s", "since_last_action_s",
                                       "high_for_s", "warm_age_s")
                    else _mask_clock(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask_clock(v) for v in obj]
    return obj


SCENARIOS = {
    "kv_directory_and_retraction": (sc_kv_directory_and_retraction, 2,
                                    {"kvshare": True}),
    "kv_migration_shipped": (sc_kv_migration_shipped, 2, {"kvshare": True}),
    "kv_migration_source_miss": (sc_kv_migration_source_miss, 2,
                                 {"kvshare": True}),
    "kv_migration_ship_error": (sc_kv_migration_ship_error, 2,
                                {"kvshare": True}),
    "autoscale_views": (sc_autoscale_views, 2, {"autoscale": True}),
    "proxy_and_stickiness": (sc_proxy_and_stickiness, 3, {}),
    "failover_and_eject": (sc_failover_and_eject, 2, {}),
    "retry_budget_503": (sc_retry_budget_503, 3, {}),
    "first_byte_deadline": (sc_first_byte_deadline, 2,
                            {"first_byte_timeout_s": 0.25, "retries": 3}),
    "shed_429": (sc_shed_429, 1, {"max_inflight": 1}),
    "no_routable_replica": (sc_no_routable_replica, 1, {}),
    "replica_429_no_eject": (sc_replica_429_no_eject, 2, {}),
    "pre_token_failover_mid_stream_error": (
        sc_pre_token_failover_mid_stream_error, 2, {"stream_resumes": 0}),
    "health_and_fleet_views": (sc_health_and_fleet_views, 2, {}),
    "client_disconnect": (sc_client_disconnect, 1, {}),
    "json_hedge": (sc_json_hedge, 2, {"hedge_ms": 30.0}),
    "stream_hedge": (sc_stream_hedge, 2, {"hedge_ms": 30.0}),
    "round_robin": (sc_round_robin, 2, {"affinity": False}),
    "splice_resume_byte_identical": (sc_splice_resume_byte_identical, 2,
                                     {}),
    "overlap_strip": (sc_overlap_strip, 2, {}),
    "resume_budget_exhausted": (sc_resume_budget_exhausted, 2,
                                {"stream_resumes": 1}),
    "client_disconnect_during_resume": (
        sc_client_disconnect_during_resume, 2, {}),
    "sampled_resume_flagged": (sc_sampled_resume_flagged, 2, {}),
    "break_after_complete": (sc_break_after_complete, 2, {}),
}


def _run(kind, name):
    fn, n, kw = SCENARIOS[name]

    async def main():
        env = Env(kind, n, **kw)
        await env.start()
        try:
            result = await fn(env)
            # the relay's last bookkeeping lands after the client's read
            for _ in range(200):
                if not env.router.inflight:
                    break
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.05)
            return {
                "result": result,
                "timelines": [env.events(r) for r in env.rids],
                "served": {r.name: list(r.served) for r in env.replicas},
                "continuations": {r.name: list(r.continuations)
                                  for r in env.replicas},
                "headers": {r.name: list(r.headers) for r in env.replicas},
                "membership": {
                    r.name: {k: r.snapshot()[k] for k in (
                        "state", "ejects", "readmits", "consec_fails",
                        "inflight", "eject_evidence")}
                    for r in env.registry.replicas()},
                "counters": _deltas(env),
            }
        finally:
            await env.stop()
    return asyncio.run(main())


def _norm(obs_):
    """Counter keys by metric and labels, as comparable tuples."""
    return json.loads(json.dumps(obs_, default=str))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference_router(name):
    ref = _run("jax", name)
    ours = _run("port", name)
    ref["counters"] = sorted((k, v) for k, v in ref["counters"].items())
    ours["counters"] = sorted((k, v) for k, v in ours["counters"].items())
    assert _norm(ours) == _norm(ref)


# -- port-only: close-delimited replicas, views, refusals ----------------------

def test_close_delimited_eof_before_done_is_a_break():
    """The port's replicas close-delimit their SSE: an EOF before [DONE]
    splices like a severed connection, one after [DONE] is a clean end
    (no resume, no failure recorded)."""
    async def main():
        env = Env("port", 2, framing="close")
        await env.start()
        try:
            base = answer(*await env.post(_chat("cl convo", stream=True)))
            assert base["body"][-1] == "[DONE]"
            owner = env.owner()
            assert env.registry.get(owner.name).snapshot()[
                "consec_fails"] == 0
            owner.mode = "abrupt"
            healed = answer(*await env.post(_chat("cl convo", stream=True)))
            assert _content(healed["body"]) == "tok0tok1tok2tok3"
            assert env.other(owner).continuations == ["tok0tok1"]
            assert healed["body"][-1] == "[DONE]"
            return _deltas(env)
        finally:
            await env.stop()
    deltas = asyncio.run(main())
    assert deltas[("FLEET_STREAM_RESUMES", (("outcome", "ok"),))] == 1


def test_views_refusals_and_stitched_timeline():
    async def main():
        env = Env("port", 2)
        await env.start()
        try:
            status, body = await env.get("/api/v1/fleet/autoscale")
            assert (status, json.loads(body)) == (200, {"enabled": False})
            s1, a = await env.get("/fleet")
            s2, b = await env.get("/api/v1/fleet")
            assert s1 == s2 == 200
            assert [r["name"] for r in json.loads(a)["replicas"]] \
                == [r["name"] for r in json.loads(b)["replicas"]]
            status, body = await env.get("/api/v1/fleet/telemetry")
            assert status == 200 and json.loads(body)["cycles"] >= 1
            status, _, data = await env.post(_chat("tl convo"))
            rid = env.rids[-1]
            assert rid.startswith("trace-")
            status, body = await env.get("/api/v1/requests/" + rid)
            tiers = json.loads(body)["tiers"]
            assert tiers[0]["tier"] == "router"
            kinds = [e["kind"] for e in tiers[0]["events"]]
            assert kinds[:2] == ["route", "attempt"] and kinds[-1] == "done"
            status, body = await env.get("/api/v1/requests")
            assert rid in json.loads(body)["requests"]
            assert (await env.get("/nope"))[0] == 404
            status, _, data = await env.post({"messages": []})
            assert status == 400
            env.router.draining = True
            status, headers, _ = await env.post(_chat())
            assert status == 503 and headers.get("Retry-After")
        finally:
            await env.stop()
    asyncio.run(main())
    # module 15b's switches build the loop and the tier (they were
    # refused before the port took them over)
    reg = fleet.ReplicaRegistry(_policy(fleet))
    router = fleet.FleetRouter(reg, autoscale=True, kvshare=True)
    assert router.kvshare and router.autoscaler.policy.enabled
    assert router.lifecycle is router.autoscaler.lifecycle
    assert router._kv_peers(type("R", (), {"name": "x"})()) is None


def test_unported_knobs_refused(monkeypatch):
    """CAKE_SCALE and CAKE_KVSHARE, once refused by name, now switch the
    closed loop and the KV-share tier on; an explicit flag wins over the
    knob, and unset leaves both off."""
    def build(**kw):
        return fleet.FleetRouter(fleet.ReplicaRegistry(_policy(fleet)), **kw)
    for knob in ("CAKE_SCALE", "CAKE_KVSHARE"):
        monkeypatch.delenv(knob, raising=False)
    off = build()
    assert off.autoscaler is None and off.lifecycle is None
    assert not off.kvshare
    monkeypatch.setenv("CAKE_SCALE", "1")
    monkeypatch.setenv("CAKE_KVSHARE", "1")
    monkeypatch.setenv("CAKE_SCALE_MIN", "2")
    on = build()
    assert on.autoscaler is not None and on.kvshare
    assert on.autoscaler.policy.min_replicas == 2
    assert build(autoscale=False, kvshare=False).autoscaler is None
    monkeypatch.setenv("CAKE_SCALE", "0")
    assert build(autoscale=True).autoscaler.policy.enabled


# -- end to end: real replicas of both packages --------------------------------

CTX = 256
E2E_TOKENS = 24


def _weights():
    """A 2-layer qwen3 (the flagship's family) in float32 with a byte
    vocabulary, seeded in JAX, its lm_head cut to ASCII: a greedy stream
    is then plain text the byte tokenizer re-encodes to the same ids,
    which a splice needs (stray bytes decode to U+FFFD)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cake_tpu.models import tiny_config as jax_tiny_config
    from cake_tpu.models.common.layers import init_params
    over = dict(vocab_size=258, max_position_embeddings=CTX,
                num_hidden_layers=2, tie_word_embeddings=False)
    jcfg = jax_tiny_config("qwen3", **over)
    params = init_params(jcfg, jax.random.PRNGKey(5), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    head = np.array(tree["lm_head"]["weight"])
    vocab_axis = head.shape.index(258)
    head[(slice(None),) * vocab_axis + (slice(128, None),)] = 0.0
    tree["lm_head"]["weight"] = head
    return over, jcfg, tree


def _port_replicas(over, tree):
    import torch
    from cake_tpu_torch.api import create_app
    from cake_tpu_torch.models import TextModel, tiny_config
    from cake_tpu_torch.serve import ServeEngine
    from cake_tpu_torch.tokenizer import ByteTokenizer
    from cake_tpu_torch.utils import params_from_numpy
    torch.set_num_threads(1)
    cfg = tiny_config("qwen3", **over)
    tok = ByteTokenizer(im_start_id=256, im_end_id=257)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   tokenizer=tok, dtype=torch.float32, device="cpu",
                   max_cache_len=CTX)
    return [create_app(tm, ServeEngine(tm, slots=2, max_queue=8,
                                       ctx_len=CTX), tok, port=0).start()
            for _ in range(2)]


async def _jax_replicas(jcfg, tree):
    import jax.numpy as jnp
    from aiohttp.test_utils import TestServer
    from cake_tpu.api import ApiState, create_app
    from cake_tpu.models import TextModel as JaxTextModel
    from cake_tpu_torch.tokenizer import ByteTokenizer
    tok = ByteTokenizer(im_start_id=256, im_end_id=257)
    jm = JaxTextModel(jcfg, params=tree, tokenizer=tok, dtype=jnp.float32,
                      max_cache_len=CTX)
    servers = []
    for i in range(2):
        srv = TestServer(create_app(ApiState(model=jm, tokenizer=tok,
                                             model_id=f"j{i}")))
        await srv.start_server()
        servers.append(srv)
    return servers


E2E_CHAT = {"messages": [{"role": "system", "content": "Answer in ASCII."},
                         {"role": "user", "content": "Tell me about GPUs."}],
            "max_tokens": E2E_TOKENS, "temperature": 0.0, "stream": True}


async def _through_router(pkg, fault_mod, urls, plan_after):
    """(unbroken content, spliced content, the broken owner) through a
    router of package `pkg` over replicas at `urls`."""
    registry = pkg.ReplicaRegistry(_policy(pkg))
    for i, url in enumerate(urls):
        registry.add(f"r{i}", url)
    router = pkg.FleetRouter(registry, retries=2, backoff_s=0.001,
                             probe_s=30.0, hedge_ms=0.0)
    app = pkg.create_router_app(router)
    if pkg is fleet:
        host, port = await app.start("127.0.0.1", 0)
        base, stop = f"http://{host}:{port}", app.stop
    else:
        from aiohttp.test_utils import TestServer
        srv = TestServer(app)
        await srv.start_server()
        base, stop = str(srv.make_url("")).rstrip("/"), srv.close
    try:
        async def stream():
            r = await request("POST", base + "/v1/chat/completions",
                              json_body=E2E_CHAT)
            async with r:
                return _sse_events(await asyncio.wait_for(r.read(), 300))
        whole = await stream()
        key = pkg.affinity_key(pkg.conversation_head(E2E_CHAT["messages"]),
                               64)
        owner = pkg.rank_replicas(key, ["r0", "r1"])[0]
        fault_mod.install(f"replica={owner};break_stream_after="
                          f"{plan_after};break_times=1")
        try:
            spliced = await stream()
        finally:
            fault_mod.clear()
        kinds = [e["kind"] for e in
                 router.timelines.get(router.timelines.ids()[-1])["events"]]
        assert "stream_broken" in kinds and "resume_spliced" in kinds
        assert whole[-1] == spliced[-1] == "[DONE]"
        assert not any("error" in e for e in spliced if isinstance(e, dict))
        return _content(whole), _content(spliced), owner
    finally:
        await stop()


def test_end_to_end_splice_equals_unbroken_and_reference():
    over, jcfg, tree = _weights()
    apps = _port_replicas(over, tree)
    try:
        ours = asyncio.run(_through_router(fleet, faults,
                                           [a.url for a in apps], 8))
    finally:
        for a in apps:
            a.stop(drain_s=1)

    async def ref_side():
        servers = await _jax_replicas(jcfg, tree)
        try:
            return await _through_router(
                ref_fleet, ref_faults,
                [str(s.make_url("")).rstrip("/") for s in servers], 8)
        finally:
            for s in servers:
                await s.close()
    ref = asyncio.run(ref_side())
    whole, spliced, owner = ours
    assert len(whole) >= 12 and whole.isascii()
    assert spliced == whole                 # byte-identical splice
    assert ref == ours                      # and the reference's fleet


@pytest.mark.parametrize("how", ["begin_drain", "stop", "late_replay"])
def test_end_to_end_drained_stream_migrates(monkeypatch, how):
    """Two paged port replicas with the KV-share tier on behind the
    port's router: the owner is drained after 8 content chunks, its
    stream's swap blob moves to the other replica, which adopts it and
    continues; the client's body equals the unbroken stream, with no
    error event, and the router counts one shipped migration. `how` the
    owner drains: its engine's begin_drain (begin_drain); its server's
    stop, as SIGTERM stops `cli serve` (stop: the router fetches the
    parked blob 1 s late, after the engine's drain alone has ended, and
    the routes are still up for it); or begin_drain with the
    adopting replica's wait on the admission held until it has decoded
    one token past the blob's record (late_replay: the replay is that
    record alone, so no token reaches the client twice)."""
    import torch
    from cake_tpu_torch.api import create_app
    from cake_tpu_torch.models import TextModel, tiny_config
    from cake_tpu_torch.serve import ServeEngine
    from cake_tpu_torch.tokenizer import ByteTokenizer
    from cake_tpu_torch.utils import params_from_numpy
    monkeypatch.setenv("CAKE_KVSHARE", "1")
    # a loaded test host must not turn the blob hops into a timeout
    monkeypatch.setenv("CAKE_KVSHARE_FETCH_TIMEOUT_S", "30")
    torch.set_num_threads(1)
    over, _, tree = _weights()
    cfg = tiny_config("qwen3", **over)
    tok = ByteTokenizer(im_start_id=256, im_end_id=257)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   tokenizer=tok, dtype=torch.float32, device="cpu",
                   max_cache_len=CTX)
    apps = [create_app(tm, ServeEngine(
        tm, slots=2, max_queue=8, ctx_len=CTX, prefill_chunk=16,
        kv_blocks=64, kv_block_tokens=8, prefix_cache_mb=8), tok,
        port=0).start() for _ in range(2)]
    assert all(a.state.kvshare is not None for a in apps)
    shipped0 = obs.FLEET_KV_MIGRATIONS.value(outcome="shipped")
    key = fleet.affinity_key(
        fleet.conversation_head(E2E_CHAT["messages"]), 64)
    owner = int(fleet.rank_replicas(key, ["r0", "r1"])[0][1])
    held = []
    if how == "late_replay":
        target = apps[1 - owner].state.engine
        plain_wait = target.wait

        def wait(req, event=None):
            plain_wait(req, event)
            if event is req.admitted and req.stats.get("kv_migrated"):
                n, deadline = len(req.tokens), time.monotonic() + 60
                while len(req.tokens) <= n and not req.done.is_set() \
                        and time.monotonic() < deadline:
                    time.sleep(0.002)
                held.append((req.replayed, n, len(req.tokens)))
        monkeypatch.setattr(target, "wait", wait)
    stopping = []

    def drain_owner():
        if how == "stop":
            th = threading.Thread(target=apps[owner].stop,
                                  kwargs={"drain_s": 30})
            th.start()
            stopping.append(th)
        else:
            apps[owner].state.engine.begin_drain()

    async def main():
        registry = fleet.ReplicaRegistry(_policy(fleet))
        for i, a in enumerate(apps):
            registry.add(f"r{i}", a.url)
        router = fleet.FleetRouter(registry, retries=2, backoff_s=0.001,
                                   probe_s=30.0, hedge_ms=0.0, kvshare=True)
        if how == "stop":
            plain_migrate = router._migrate_stream

            async def late_migrate(*args):
                await asyncio.sleep(1.0)
                return await plain_migrate(*args)
            router._migrate_stream = late_migrate
        app = fleet.create_router_app(router)
        host, port = await app.start("127.0.0.1", 0)
        base = f"http://{host}:{port}"

        async def stream(drain_at=None):
            r = await request("POST", base + "/v1/chat/completions",
                              json_body=E2E_CHAT)
            data = b""
            async with r:
                async for piece in r.iter_any():
                    data += piece
                    if drain_at and data.count(b'"content"') >= drain_at:
                        drain_owner()
                        drain_at = None
            return _sse_events(data)
        try:
            whole = await stream()
            moved = await stream(drain_at=8)
            kinds = [(e["kind"], e.get("outcome")) for e in
                     router.timelines.get(router.timelines.ids()[-1])[
                         "events"]]
            return whole, moved, kinds
        finally:
            await app.stop()
    try:
        whole, moved, kinds = asyncio.run(main())
    finally:
        for th in stopping:
            th.join(60)
        for i, a in enumerate(apps):
            if not (how == "stop" and i == owner):
                a.stop(drain_s=1)
    assert whole[-1] == moved[-1] == "[DONE]"
    assert not any("error" in e for e in moved if isinstance(e, dict))
    assert len(_content(whole)) >= 12
    assert _content(moved) == _content(whole)
    names = [k for k, _ in kinds]
    assert ("kv_migrate", "shipped") in kinds, kinds
    assert names.index("stream_broken") < names.index("kv_migrate") \
        < names.index("resume_spliced") < names.index("done"), kinds
    assert obs.FLEET_KV_MIGRATIONS.value(outcome="shipped") == shipped0 + 1
    if how == "stop":
        assert not stopping[0].is_alive()
        assert apps[owner].state.kvshare.unclaimed() == 0
    if how == "late_replay":
        # one adoption, whose answer began only after a token past the
        # blob's record had been decoded
        [(replayed, n, after)] = held
        assert 0 < replayed <= n < after


# -- port-only: the standard-library HTTP layer (fleet/http.py) ---------------

def test_http_layer_bodies_routes_and_cancellation():
    """The client reads sized, chunked and close-delimited bodies and
    raises IncompleteBody (a ConnectionError) on a sized or chunked body
    cut short; the server answers 404 / 405, a 100 Continue when asked,
    and cancels a handler whose client closes its connection."""
    import socket
    from cake_tpu_torch.fleet.http import (App, IncompleteBody,
                                           json_response)

    def raw_server(payloads):
        """A socket server answering each connection with the next raw
        payload, then closing."""
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(8)

        def run():
            for data in payloads:
                conn, _ = srv.accept()
                conn.recv(65536)
                conn.sendall(data)
                conn.close()
            srv.close()
        threading.Thread(target=run, daemon=True).start()
        return "http://127.0.0.1:%d" % srv.getsockname()[1]

    head = b"HTTP/1.1 200 OK\r\n"
    url = raw_server([
        head + b"Content-Length: 5\r\n\r\nhello",
        head + b"Transfer-Encoding: chunked\r\n\r\n3\r\nabc\r\n2\r\nde\r\n"
               b"0\r\n\r\n",
        head + b"\r\nuntil the end",
        head + b"Content-Length: 9\r\n\r\nshort",
        head + b"Transfer-Encoding: chunked\r\n\r\n5\r\nabc"])

    async def client_side():
        got = []
        for _ in range(5):
            r = await request("GET", url + "/x")
            async with r:
                try:
                    got.append((await r.read(), r.close_delimited))
                except IncompleteBody as e:
                    assert isinstance(e, ConnectionError)
                    got.append("incomplete")
        return got
    assert asyncio.run(client_side()) == [
        (b"hello", False), (b"abcde", False), (b"until the end", True),
        "incomplete", "incomplete"]

    state = {}

    async def slow(req):
        state["started"] = True
        try:
            await asyncio.sleep(30)
        except asyncio.CancelledError:
            state["cancelled"] = True
            raise
        return json_response({})

    async def echo(req):
        return json_response({"len": len(req.body),
                              "rid": req.match_info.get("rid")})

    async def server_side():
        app = App()
        app.add_get("/slow", slow)
        app.add_post("/echo/{rid}", echo)
        host, port = await app.start("127.0.0.1", 0)
        base = f"http://{host}:{port}"
        try:
            out = []
            for method, path in (("GET", "/nope"), ("GET", "/echo/a")):
                r = await request(method, base + path)
                async with r:
                    out.append(r.status)
            r = await request("POST", base + "/echo/a7", data=b"x" * 2000,
                              headers={"Expect": "100-continue"})
            async with r:
                out.append((r.status, json.loads(await r.read())))
            r_reader, r_writer = await asyncio.open_connection(host, port)
            r_writer.write(b"GET /slow HTTP/1.1\r\nHost: x\r\n\r\n")
            await r_writer.drain()
            for _ in range(100):
                if state.get("started"):
                    break
                await asyncio.sleep(0.01)
            r_writer.close()
            for _ in range(100):
                if state.get("cancelled"):
                    break
                await asyncio.sleep(0.01)
            return out
        finally:
            await app.stop()
    out = asyncio.run(server_side())
    assert out[:2] == [404, 405]
    # the 100 Continue comes first; the client reads past it
    assert out[2] == (200, {"len": 2000, "rid": "a7"})
    assert state == {"started": True, "cancelled": True}
