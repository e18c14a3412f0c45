"""OpenAI-compatible chat completions over the serve engine (counterpart
of cake_tpu/api/text.py: chat_completions, the sampling grid, usage and
finish_reason), for the standard-library HTTP server in server.py.

Blocking JSON and SSE streaming (`"stream": true`). Left out so far: stop
sequences, continuation mode, QoS headers and the fleet KV handshakes.
"""
from __future__ import annotations

import json
import logging
import sys
import time
import uuid

from ..ops.sampling import SamplingConfig
from ..serve import EngineDown, EngineDraining, QueueFull
from ..tokenizer import PromptError

log = logging.getLogger("cake_tpu_torch.api")

TOP_K_CHOICES = (1, 5, 10, 20, 40, 64, 100, 200)


def _grid(v: float, step: float, lo: float, hi: float) -> float:
    return round(round(max(lo, min(hi, v)) / step) * step, 2)


def sampling_from_request(body: dict) -> SamplingConfig:
    """Clamp and quantize client sampling params onto the reference's grid
    (temperature, top_p and repetition penalty in steps of 0.05, top_k to
    the nearest of TOP_K_CHOICES, 0 = off)."""
    temp = _grid(float(body.get("temperature", 0.7)), 0.05, 0.0, 2.0)
    top_p = body.get("top_p")
    if top_p is not None:
        top_p = _grid(float(top_p), 0.05, 0.05, 1.0)
        if top_p >= 1.0:
            top_p = None
    top_k = body.get("top_k")
    if top_k is not None:
        top_k = int(top_k)
        top_k = (None if top_k <= 0
                 else min(TOP_K_CHOICES, key=lambda c: abs(c - top_k)))
    rp = _grid(float(body.get("repetition_penalty",
                              body.get("repeat_penalty", 1.0))),
               0.05, 1.0, 2.0)
    return SamplingConfig(temperature=temp, top_k=top_k, top_p=top_p,
                          repeat_penalty=rp)


def gen_kwargs(body: dict) -> dict:
    max_new = int(body.get("max_tokens",
                           body.get("max_completion_tokens", 256)))
    if max_new < 1:
        raise ValueError("max_tokens must be >= 1")
    return {"max_new_tokens": max_new,
            "sampling": sampling_from_request(body)}


def _completion_id() -> str:
    return "chatcmpl-" + uuid.uuid4().hex[:24]


def decode_text(tokenizer, ids: list[int]) -> str:
    """Decode output ids; if the whole list fails, decode per token and
    drop only the ids that fail (the reference's _decode_text)."""
    if tokenizer is None or not ids:
        return ""
    try:
        return tokenizer.decode(ids)
    except Exception:
        parts = []
        for i in ids:
            try:
                parts.append(tokenizer.decode([i]))
            except Exception:
                pass
        return "".join(parts)


class TextStream:
    """The text deltas of a stream of token ids. A character split over
    tokens (byte-fallback <0xNN> tokens, or byte-level tokens cut inside a
    UTF-8 sequence) decodes to U+FFFD until its last byte arrives: the
    delta waits for it, for at most MAX_PENDING tokens, so the deltas
    join to the whole text's decode_text."""

    MAX_PENDING = 4      # bytes of the longest UTF-8 sequence

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.pending: list[int] = []

    def push(self, tid: int) -> str:
        self.pending.append(tid)
        text = decode_text(self.tokenizer, self.pending)
        if text.endswith("\ufffd") and len(self.pending) < self.MAX_PENDING:
            return ""
        self.pending = []
        return text

    def flush(self) -> str:
        text = decode_text(self.tokenizer, self.pending)
        self.pending = []
        return text


def completion_json(state, cid: str, toks: list[int], stats: dict,
                    n_in: int) -> dict:
    ended = bool(toks) and state.model.cfg.is_eos(toks[-1])
    content_ids = toks[:-1] if ended else toks
    return {
        "id": cid,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": state.model_id,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant",
                        "content": decode_text(state.tokenizer,
                                               content_ids)},
            "finish_reason": "stop" if ended else "length",
        }],
        "usage": {
            "prompt_tokens": n_in,
            "completion_tokens": len(toks),
            "total_tokens": n_in + len(toks),
            "tokens_per_second": round(stats.get("tok_per_s", 0.0), 2),
        },
    }


def _client_fault(e: Exception) -> bool:
    """Whether building a prompt failed on the request: text without a
    tokenizer, or the chat template's own error (its raise_exception, a
    field the messages lack). jinja2 is looked up, not imported: a
    template error can only come from a template that was built."""
    jinja2 = sys.modules.get("jinja2")
    return isinstance(e, PromptError) or (
        jinja2 is not None and isinstance(e, jinja2.TemplateError))


def chat_completions(handler, state) -> None:
    """POST /v1/chat/completions on a BaseHTTPRequestHandler."""
    try:
        length = int(handler.headers.get("Content-Length") or 0)
        body = json.loads(handler.rfile.read(length) or b"{}")
    except (ValueError, json.JSONDecodeError):
        return handler.send_json({"error": "invalid JSON body"}, 400)
    messages = body.get("messages") if isinstance(body, dict) else None
    if not isinstance(messages, list) or not messages:
        return handler.send_json({"error": "messages[] required"}, 400)
    for m in messages:
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            return handler.send_json(
                {"error": "each message needs role and content"}, 400)
    try:
        kw = gen_kwargs(body)
    except (TypeError, ValueError) as e:
        return handler.send_json({"error": f"invalid sampling params: {e}"},
                                 400)
    try:
        prompt_ids = state.tokenizer.chat_prompt_ids(messages)
    except Exception as e:
        if not _client_fault(e):
            log.exception("building the prompt of %d messages failed",
                          len(messages))
            return handler.send_json({"error": "internal error"}, 500)
        return handler.send_json({"error": f"cannot build the prompt: {e}"},
                                 400)
    cid = _completion_id()
    try:
        req = state.engine.submit(prompt_ids, request_id=cid, **kw)
    except QueueFull as e:
        return handler.send_json({"error": str(e)}, 429,
                                 {"Retry-After": str(e.retry_after_s)})
    except (EngineDraining, EngineDown) as e:
        return handler.send_json({"error": str(e)}, 503,
                                 {"Retry-After": str(e.retry_after_s)})
    except ValueError as e:
        return handler.send_json({"error": str(e)}, 400)
    if body.get("stream"):
        return _stream(handler, state, cid, req)
    req.wait()
    if "error" in req.result:
        return handler.send_json(
            {"error": f"generation failed: {req.result['error']}"}, 500)
    return handler.send_json(completion_json(
        state, cid, req.result["tokens"], req.result["stats"],
        len(prompt_ids)))


def _stream(handler, state, cid: str, req) -> None:
    """SSE: a role chunk, one content chunk per token (a character split
    over tokens goes out with its last token: TextStream), a final chunk
    with finish_reason, then [DONE]. A client that goes away cancels the
    request, which frees its slot."""
    created = int(time.time())

    def chunk(delta: dict, finish=None) -> bytes:
        payload = {"id": cid, "object": "chat.completion.chunk",
                   "created": created, "model": state.model_id,
                   "choices": [{"index": 0, "delta": delta,
                                "finish_reason": finish}]}
        return f"data: {json.dumps(payload)}\n\n".encode()

    handler.send_response(200)
    handler.send_header("Content-Type", "text/event-stream")
    handler.send_header("Cache-Control", "no-cache")
    handler.end_headers()
    finish = "length"
    tokens = state.engine.stream(req)
    text = TextStream(state.tokenizer)
    try:
        handler.wfile.write(chunk({"role": "assistant"}))
        try:
            for tok in tokens:
                if tok.is_end_of_stream:
                    finish = "stop"
                elif delta := text.push(tok.id):
                    handler.wfile.write(chunk({"content": delta}))
                    handler.wfile.flush()
            if rest := text.flush():
                handler.wfile.write(chunk({"content": rest}))
        except Exception as e:      # generation failed mid-stream
            handler.wfile.write(chunk({"content": f"\n[error: {e}]"}))
            finish = "error"
        handler.wfile.write(chunk({}, finish=finish))
        handler.wfile.write(b"data: [DONE]\n\n")
        handler.wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
        req.cancel()
    finally:
        tokens.close()
