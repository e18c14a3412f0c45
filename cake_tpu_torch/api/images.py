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
WIDTHxHEIGHT up to CAKE_IMAGE_MAX_SIZE (2048) a side.

`init_image_b64` (img2img, with `strength`, 0.8 by default) is SD's: a
model without `init_latent_from` (FLUX) answers 400, as the reference
does. The image's bytes come in the body, never a server path. The
handler reads only the PNG's signature and header (utils/png.png_header):
anything but an 8-bit non-interlaced PNG, or one larger than twice
CAKE_IMAGE_MAX_SIZE a side, answers 400 `bad init_image_b64: ...` before
a pixel is inflated. The decode, the resize and the encode run inside
the job, under admission and the job workers, as the reference leaves
the pixel work to its job; a broken stream answers the same 400 from
there. SD's intermediate images and profiler trace are the operator's
(AppState.sd_intermediate_every / sd_trace_dir), never the request's.
"""
from __future__ import annotations

import base64
import binascii
import inspect
import json
import os
import time

from ..obs import TRACE_HEADER
from ..utils.png import decode_png, png_header
from .qos import adopt_job_request_id, resolve_admission, run_admitted_job

DEFAULT_MAX_SIZE = 2048         # the reference's CAKE_IMAGE_MAX_SIZE


def max_size() -> int:
    return int(os.environ.get("CAKE_IMAGE_MAX_SIZE") or DEFAULT_MAX_SIZE)


def parse_size(s: str) -> tuple[int, int]:
    """WIDTHxHEIGHT, each side positive and at most CAKE_IMAGE_MAX_SIZE;
    raises ValueError with the reference's message otherwise."""
    try:
        w, h = s.lower().split("x")
        w, h = int(w), int(h)
    except Exception:
        raise ValueError("size must be WIDTHxHEIGHT")
    limit = max_size()
    if w <= 0 or h <= 0:
        raise ValueError(f"size {w}x{h} must be positive")
    if w > limit or h > limit:
        raise ValueError(f"size {w}x{h} exceeds CAKE_IMAGE_MAX_SIZE "
                         f"({limit}x{limit})")
    return w, h


def check_init_png(data: bytes) -> None:
    """Refuse, from the header alone, an init image that decode_png would
    refuse or that is larger than twice CAKE_IMAGE_MAX_SIZE a side (a
    phone's 4032 x 3024 photo passes at the default); raises ValueError."""
    iw, ih, _ = png_header(data)
    limit = 2 * max_size()
    if iw > limit or ih > limit:
        raise ValueError(f"init image of {iw} x {ih}: at most {limit} a "
                         f"side (twice CAKE_IMAGE_MAX_SIZE)")


def _takes(fn, name: str) -> bool:
    """Whether `fn` has a parameter `name` (SD's debugging arguments go
    only to a generator that takes them)."""
    return name in inspect.signature(fn).parameters


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
    model = state.image_model
    init_png = None
    if body.get("init_image_b64"):
        if not hasattr(model, "init_latent_from"):
            return handler.send_json(
                {"error": "img2img is SD-only (FLUX is guidance-distilled "
                          "text-to-image)"}, 400)
        try:
            init_png = base64.b64decode(body["init_image_b64"],
                                        validate=True)
            check_init_png(init_png)
        except (ValueError, TypeError, binascii.Error) as e:
            return handler.send_json(
                {"error": f"bad init_image_b64: {e}"}, 400)
        try:
            kwargs["strength"] = float(body.get("strength", 0.8))
        except (TypeError, ValueError) as e:
            return handler.send_json({"error": f"invalid parameters: {e}"},
                                     400)
    gen = model.generate_image
    if state.sd_intermediate_every and _takes(gen, "intermediate_every"):
        kwargs["intermediate_every"] = state.sd_intermediate_every
    if state.sd_trace_dir and _takes(gen, "trace_dir"):
        kwargs["trace_dir"] = state.sd_trace_dir
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

    def run(job):
        kwargs["on_step"] = lambda i, total: job.checkpoint()
        if init_png is not None:
            try:
                pixels = decode_png(init_png)
            except ValueError as e:     # answered 400 by run_admitted_job
                raise ValueError(f"bad init_image_b64: {e}") from e
            kwargs["init_image"] = model.init_latent_from(pixels, w, h)
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
