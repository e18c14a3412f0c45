"""Image generation endpoints (counterpart of cake_tpu/api/images.py):
OpenAI's POST /v1/images/generations (b64_json, or a raw PNG with
response_format "png") and the legacy POST /api/v1/image (a raw PNG),
for the standard-library server in server.py.

Each request becomes a GenerationJob admitted under a QoS class (default
`batch`; X-Cake-QoS or the body's `qos`, clamped by the tenant's
ceiling) through the admission plane's job lane: visible in the queue
gauges and in the request's timeline (enqueue -> admit -> finish), under
the tenant's quota and the drain. The job checks in between diffusion
steps, so a client that goes away stops it at the next step, and queued
interactive chat is never held behind a long step loop. `n` (1-4) images
are generated in turn from seeds seed, seed + 1, ...; sizes are
WIDTHxHEIGHT up to CAKE_IMAGE_MAX_SIZE (2048) a side. `init_image_b64`
(img2img) is SD's, and FLUX answers 400, as the reference does.
"""
from __future__ import annotations

import base64
import json
import os
import time

from ..obs import TRACE_HEADER
from .qos import adopt_job_request_id, resolve_admission, run_admitted_job

DEFAULT_MAX_SIZE = 2048         # the reference's CAKE_IMAGE_MAX_SIZE


def parse_size(s: str) -> tuple[int, int]:
    """WIDTHxHEIGHT, each side positive and at most CAKE_IMAGE_MAX_SIZE;
    raises ValueError with the reference's message otherwise."""
    try:
        w, h = s.lower().split("x")
        w, h = int(w), int(h)
    except Exception:
        raise ValueError("size must be WIDTHxHEIGHT")
    limit = int(os.environ.get("CAKE_IMAGE_MAX_SIZE") or DEFAULT_MAX_SIZE)
    if w <= 0 or h <= 0:
        raise ValueError(f"size {w}x{h} must be positive")
    if w > limit or h > limit:
        raise ValueError(f"size {w}x{h} exceeds CAKE_IMAGE_MAX_SIZE "
                         f"({limit}x{limit})")
    return w, h


def images_generations(handler, state) -> None:
    """POST /v1/images/generations and /api/v1/image."""
    if state.image_model is None:
        return handler.send_json({"error": "no image model loaded"}, 503)
    if state.draining:
        return handler.send_json({"error": "server draining for shutdown"},
                                 503, {"Retry-After": "5"})
    try:
        length = int(handler.headers.get("Content-Length") or 0)
        body = json.loads(handler.rfile.read(length) or b"{}")
    except (ValueError, json.JSONDecodeError):
        return handler.send_json({"error": "invalid JSON body"}, 400)
    if not isinstance(body, dict) or not body.get("prompt"):
        return handler.send_json({"error": "prompt required"}, 400)
    prompt = body["prompt"]
    try:
        w, h = parse_size(body.get("size", "1024x1024"))
    except ValueError as e:
        return handler.send_body(str(e).encode(), 400,
                                 "text/plain; charset=utf-8")
    fmt = body.get("response_format", "b64_json")
    raw = fmt == "png" or handler.path.endswith("/image")
    try:
        kwargs = dict(width=w, height=h, steps=int(body.get("steps", 20)),
                      guidance=float(body.get("guidance",
                                              body.get("cfg_scale", 3.5))),
                      seed=body.get("seed"),
                      negative_prompt=body.get("negative_prompt"))
    except (TypeError, ValueError) as e:
        return handler.send_json({"error": f"invalid parameters: {e}"}, 400)
    if body.get("init_image_b64"):
        return handler.send_json(
            {"error": "img2img is SD-only (FLUX is guidance-distilled "
                      "text-to-image)"}, 400)
    try:
        n = int(body.get("n") or 1)
    except (TypeError, ValueError):
        return handler.send_json({"error": "n must be 1..4"}, 400)
    if not 1 <= n <= 4:
        return handler.send_json({"error": "n must be 1..4"}, 400)
    if n > 1 and raw:
        return handler.send_json(
            {"error": "n > 1 needs response_format=b64_json"}, 400)
    resolved = resolve_admission(handler, state, body, "batch")
    if resolved is None:
        return None
    qos, tenant, release = resolved
    rid = adopt_job_request_id(handler, "img")
    gen = state.image_model.generate_image

    def run(job):
        kwargs["on_step"] = lambda i, total: job.checkpoint()
        out = []
        for i in range(n):
            job.checkpoint()
            kw = dict(kwargs)
            if n > 1:
                kw["seed"] = (kwargs.get("seed") or 0) + i
            out.append(gen(prompt, **kw))
        return out
    try:
        job = run_admitted_job(handler, state, "image", run, qos, tenant,
                               rid, release)
    except (BrokenPipeError, ConnectionResetError):
        return None                     # the client went away
    if job is None:
        return None
    pngs = [image.png_bytes() for image in job.result["value"]]
    if raw:
        return handler.send_body(pngs[0], 200, "image/png",
                                 {TRACE_HEADER: rid})
    return handler.send_json({
        "created": int(time.time()),
        "data": [{"b64_json": base64.b64encode(p).decode()} for p in pngs],
    }, 200, {TRACE_HEADER: rid})
