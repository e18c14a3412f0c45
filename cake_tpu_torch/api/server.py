"""HTTP front end on the standard library (counterpart of
cake_tpu/api/server.py):

  POST /v1/chat/completions     chat (JSON + SSE), api/text.py
  POST /v1/images/generations   image generation (b64_json or PNG),
  POST /api/v1/image            and its legacy raw-PNG form, api/images.py
  GET  /v1/models               model list
  GET  /health                  the engine's health (prefix_cache, paged
                                kv_pool, the supervisor's counts) and the
                                device block; 503 "degraded" while the
                                engine is dead, wedged or DOWN. With no
                                engine, the device block and status; a
                                cluster master's workers, 503 while one
                                is stale or quarantined
  GET  /metrics                 Prometheus text exposition
  GET  /api/v1/trace            Chrome-trace JSON of recorded spans
  GET  /api/v1/requests         recent traced request ids
  GET  /api/v1/requests/{rid}   one request's lifecycle timeline
                                (?format=perfetto for Chrome-trace)
  GET  /api/v1/slo              TTFT/ITL/e2e histograms + exemplar ids
  GET  /api/v1/flight           flight recorder ring on demand (?n=K)
  GET  /api/v1/topology         a cluster master's nodes and stage chain

Every request counts into cake_api_requests_total{endpoint, status} and
cake_api_request_seconds{endpoint}, the endpoint being the route's
canonical pattern ("unmatched" for any other path), as the reference's
middleware records them. A ThreadingHTTPServer gives each connection a
thread; those threads only submit to the engine and wait on its queues,
so no aiohttp is needed.

A model the engine does not serve (`engine` None: an offloaded MoE
model, or CAKE_SERVE_SLOTS=0) is served one request at a time under
`AppState.lock` (api/state.py). Shutdown drains for CAKE_DRAIN_TIMEOUT_S
(30 s, the reference's): new chats and images answer 503 while the engine
finishes its requests, or while the locked path's one generation ends,
and then the admission plane's job lane gets what is left of the same
budget (at least 2 s) to finish its queued and running image jobs.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from ..obs import API_REQUEST_SECONDS, API_REQUESTS, now
from . import obs_routes
from .images import images_generations
from .text import chat_completions

log = logging.getLogger("cake_tpu_torch.api")


DEFAULT_DRAIN_TIMEOUT_S = 30.0     # the reference's CAKE_DRAIN_TIMEOUT_S


def drain_timeout_s(env) -> float:
    """The shutdown drain budget: CAKE_DRAIN_TIMEOUT_S, else 30 s."""
    raw = env.get("CAKE_DRAIN_TIMEOUT_S")
    return float(raw) if raw else DEFAULT_DRAIN_TIMEOUT_S


@dataclass
class AppState:
    model: object
    engine: object              # None: the locked one-request path
    tokenizer: object
    model_id: str = "cake-tpu-torch"
    plane: object = None        # serve/admission: AdmissionPlane
    # one generation at a time on the locked path
    lock: threading.Lock = field(default_factory=threading.Lock)
    draining: bool = False      # shutting down: new chats answer 503
    image_model: object = None  # models/image: FluxImageModel, or None
    # SD's debugging surface, set by the OPERATOR (`cli serve
    # --sd-intermediate-every / --sd-trace-dir`), never by a request body:
    # both write files on the server
    sd_intermediate_every: int = 0
    sd_trace_dir: str | None = None


class _Handler(BaseHTTPRequestHandler):
    server_version = "cake-tpu-torch"
    _route = (None, 0.0)        # (endpoint, start) until it is counted

    @property
    def state(self) -> AppState:
        return self.server.state

    def log_message(self, fmt, *args):      # route through logging
        log.debug("%s " + fmt, self.address_string(), *args)

    def send_response(self, code, message=None):
        self._status = code
        super().send_response(code, message)

    def send_json(self, obj, status: int = 200,
                  headers: dict | None = None) -> None:
        self.send_body(json.dumps(obj).encode(), status, "application/json",
                       headers)

    def send_body(self, data: bytes, status: int, content_type: str,
                  headers: dict | None = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        # counted before the body goes out: a client that reads /metrics
        # right after this response finds it there
        self._count()
        self.wfile.write(data)

    def _count(self) -> None:
        """Count the route being answered once, by endpoint and status."""
        endpoint, t0 = self._route
        if endpoint is not None:
            self._route = (None, t0)
            API_REQUESTS.inc(endpoint=endpoint, status=str(self._status))
            API_REQUEST_SECONDS.observe(now() - t0, endpoint=endpoint)

    def _measured(self, endpoint: str, fn) -> None:
        """Run a route, counting it by endpoint and status (a streamed
        answer when it ends)."""
        self._route = (endpoint, now())
        self._status = 500
        try:
            fn()
        finally:
            self._count()

    def do_GET(self):
        url = urlsplit(self.path)
        query = parse_qs(url.query, keep_blank_values=True)
        route, args, endpoint = None, (), "unmatched"
        if url.path in obs_routes.GET_ROUTES:
            route, endpoint = obs_routes.GET_ROUTES[url.path], url.path
        elif url.path.startswith(obs_routes.REQUEST_PREFIX) \
                and len(url.path) > len(obs_routes.REQUEST_PREFIX):
            route = obs_routes.request_timeline
            args = (url.path[len(obs_routes.REQUEST_PREFIX):],)
            endpoint = obs_routes.REQUEST_PREFIX + "{rid}"
        elif url.path == "/v1/models":
            endpoint = url.path

        def answer():
            if route is not None:
                status, body, ctype = route(self.state, query, *args)
                if ctype is None:
                    return self.send_json(body, status)
                return self.send_body(body.encode(), status, ctype)
            if endpoint == "/v1/models":
                return self.send_json({"object": "list", "data": [{
                    "id": self.state.model_id, "object": "model",
                    "owned_by": "cake-tpu-torch"}]})
            return self.send_json({"error": "not found"}, 404)
        self._measured(endpoint, answer)

    def do_POST(self):
        if self.path == "/v1/chat/completions":
            return self._measured(
                self.path, lambda: chat_completions(self, self.state))
        if self.path in ("/v1/images/generations", "/api/v1/image"):
            return self._measured(
                self.path, lambda: images_generations(self, self.state))
        return self._measured(
            "unmatched", lambda: self.send_json({"error": "not found"}, 404))


class ApiServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, state: AppState, host: str = "127.0.0.1",
                 port: int = 8080):
        super().__init__((host, port), _Handler)
        self.state = state
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ApiServer":
        """Serve on a background thread (in-process use and tests)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="cake-torch-http")
        self._thread.start()
        return self

    def stop(self, drain_s: float | None = None) -> None:
        """Drain for up to drain_s seconds (None: CAKE_DRAIN_TIMEOUT_S),
        stop serving, close the engine. With no engine, the drain waits
        for the locked path's generation in flight."""
        state = self.state
        budget = drain_timeout_s(os.environ) if drain_s is None else drain_s
        t0 = now()
        state.draining = True
        if state.plane is not None:
            state.plane.begin_drain()
        if state.engine is not None:
            if not state.engine.drain(budget):
                log.warning("drain timed out after %.1fs; failing the "
                            "remaining requests", budget)
        elif state.lock.acquire(timeout=budget):
            state.lock.release()
        else:
            log.warning("drain timed out after %.1fs with a generation in "
                        "flight", budget)
        if state.plane is not None:
            # one budget: the job lane gets what the engine left
            if not state.plane.drain(max(budget - (now() - t0), 2.0)):
                log.warning("image jobs still running after the drain")
            state.plane.close()
        if self._thread is not None:
            # shutdown() waits for serve_forever, which only a started
            # server runs
            self.shutdown()
            self._thread.join(timeout=5)
        self.server_close()
        if state.engine is not None:
            state.engine.close()


def create_app(model, engine, tokenizer, host: str = "127.0.0.1",
               port: int = 8080, model_id: str = "cake-tpu-torch",
               plane=None, image_model=None, sd_intermediate_every: int = 0,
               sd_trace_dir: str | None = None) -> ApiServer:
    """`engine`: a ServeEngine, or None for the locked one-request path
    (serve/engine.py: maybe_engine). `plane`: the admission plane (tenant
    policies); None builds one from CAKE_QOS_TENANTS at the first
    request. `image_model`: what /v1/images/generations serves, with SD's
    intermediate images every `sd_intermediate_every` steps and its
    profiler trace into `sd_trace_dir`."""
    return ApiServer(AppState(model, engine, tokenizer, model_id, plane,
                              image_model=image_model,
                              sd_intermediate_every=sd_intermediate_every,
                              sd_trace_dir=sd_trace_dir), host, port)
