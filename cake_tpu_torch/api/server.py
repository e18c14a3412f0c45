"""HTTP front end on the standard library (counterpart of
cake_tpu/api/server.py): `POST /v1/chat/completions`, `GET /v1/models`
and `GET /health` (the engine's health, with its `prefix_cache`, in paged
mode its `kv_pool` block, and the supervisor's counts; 503 "degraded"
while the engine is dead, wedged or DOWN, as the reference's
api/obs_routes.py answers). A ThreadingHTTPServer gives each connection a
thread; those threads only submit to the engine and wait on its queues,
so no aiohttp is needed.
"""
from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .text import chat_completions

log = logging.getLogger("cake_tpu_torch.api")

# the coarse wedge fallback for an engine without a watchdog: work pending
# and no scheduler iteration for this long (the reference's)
ENGINE_WEDGED_S = 120.0


@dataclass
class AppState:
    model: object
    engine: object
    tokenizer: object
    model_id: str = "cake-tpu-torch"


class _Handler(BaseHTTPRequestHandler):
    server_version = "cake-tpu-torch"

    @property
    def state(self) -> AppState:
        return self.server.state

    def log_message(self, fmt, *args):      # route through logging
        log.debug("%s " + fmt, self.address_string(), *args)

    def send_json(self, obj, status: int = 200,
                  headers: dict | None = None) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/health":
            h = self.state.engine.health()
            busy = h["slots_busy"] or h["queue_depth"]
            h["wedged"] = bool(h["wedged"]) or bool(
                busy and h["last_step_age_s"] > ENGINE_WEDGED_S)
            degraded = not h["alive"] or h["wedged"] or "down" in h
            status = ("degraded" if degraded
                      else "unavailable" if h["draining"] else "ok")
            return self.send_json({"status": status, "engine": h},
                                  200 if status == "ok" else 503)
        if self.path == "/v1/models":
            return self.send_json({"object": "list", "data": [{
                "id": self.state.model_id, "object": "model",
                "owned_by": "cake-tpu-torch"}]})
        return self.send_json({"error": "not found"}, 404)

    def do_POST(self):
        if self.path == "/v1/chat/completions":
            return chat_completions(self, self.state)
        return self.send_json({"error": "not found"}, 404)


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

    def stop(self, drain_s: float = 10.0) -> None:
        """Drain the engine, stop serving, close the engine."""
        self.state.engine.drain(drain_s)
        self.shutdown()
        self.server_close()
        self.state.engine.close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def create_app(model, engine, tokenizer, host: str = "127.0.0.1",
               port: int = 8080, model_id: str = "cake-tpu-torch"
               ) -> ApiServer:
    return ApiServer(AppState(model, engine, tokenizer, model_id), host, port)
