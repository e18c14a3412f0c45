"""OpenAI-compatible chat completions over the serve engine (counterpart
of cake_tpu/api/text.py: chat_completions, the sampling grid, usage and
finish_reason, stop sequences, continuation mode, the admission plane's
QoS class and tenant quota, request-id adoption and the typed engine
errors), for the standard-library HTTP server in server.py.

Blocking JSON and SSE streaming (`"stream": true`). A chat is admitted
under a QoS class (interactive by default; `X-Cake-QoS` or the body's
`qos`, clamped by the tenant's ceiling) and charged to its tenant
(`X-Cake-Tenant`) before it takes a queue slot (api/qos.py). An
`X-Cake-Request-Id` header becomes the request's id (its timeline, its
spans, the engine's bookkeeping) and is echoed back. A streamed
continuation-mode answer reports the characters of the partial it
consumed in `X-Cake-Continuation-Chars` (the fleet router's resume
splice strips re-emitted overlap by it), and a blocking chat whose
client closes its socket (a router's cancelled hedge or failover leg)
is cancelled, freeing its slot.

The fleet KV-share handshakes (fleet/kvshare/, with CAKE_KVSHARE on):
an X-Cake-KV-Peers directory makes the replica fetch the longest prefix
chain a warm peer advertises before it admits the prompt
(fetch-before-recompute); an X-Cake-KV-Resume request adopts the stream
blob the router staged here and answers with X-Cake-KV-Resumed, its SSE
replaying the generated text from token 0; and a stream whose KV is
parked for migration (a drain) ends with its socket closed and no finish
chunk, so that the router resumes it elsewhere.

With no engine (an offloaded MoE model, or CAKE_SERVE_SLOTS=0) a chat
takes the reference's locked fallback (its _chat_blocking and
_chat_stream): one generation at a time under the server's lock
(api/state.py), the same prompt, usage and finish_reason as the engine
path; `stop` trims the JSON answer and ends a stream at the match. The
tenant's quota applies as on the engine path; the QoS class orders
nothing where one request runs at a time.
"""
from __future__ import annotations

import json
import logging
import sys
import threading
import time
import uuid

from ..fleet.kvshare.directory import (KV_DIR_HEADER, KV_RESUME_HEADER,
                                      KV_RESUMED_HEADER)
from ..obs import (GENERATIONS, RECORDER, TIMELINES, TRACE_HEADER,
                   set_request_id)
from ..ops.sampling import SamplingConfig
from ..serve import (EngineDown, EngineDraining, PoisonedRequest,
                     QueueDeadlineExceeded, QueueFull,
                     RequestDeadlineExceeded)
from ..tokenizer import PromptError
from .qos import admission_refusal, resolve_admission
from .state import (client_gone, run_generation_blocking,
                    run_generation_streamed)

log = logging.getLogger("cake_tpu_torch.api")

TOP_K_CHOICES = (1, 5, 10, 20, 40, 64, 100, 200)

# continuation handshake with the fleet router (mirrored there by name:
# the router tier imports no torch): a streamed continuation-mode answer
# reports how many chars of the partial assistant text this replica
# consumed, so the router's mid-stream resume strips any re-emitted
# overlap by POSITION instead of guessing from content. The port always
# continues the partial verbatim, so it reports the full length.
CONTINUATION_CHARS_HEADER = "X-Cake-Continuation-Chars"


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


MAX_STOPS = 4           # OpenAI caps `stop` at 4 sequences


def stops_from_request(body: dict) -> list[str]:
    """Validated OpenAI `stop` field: a string or a list of up to 4
    non-empty strings (empty / None = no stop sequences)."""
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop] if stop else []
    if isinstance(stop, list):
        if len(stop) > MAX_STOPS:
            raise ValueError(f"stop accepts at most {MAX_STOPS} sequences")
        for s in stop:
            if not isinstance(s, str) or not s:
                raise ValueError("stop sequences must be non-empty strings")
        return list(stop)
    raise ValueError("stop must be a string or a list of strings")


def apply_stop(text: str, stops: list[str]) -> tuple[str, bool]:
    """Trim `text` at the EARLIEST occurrence of any stop sequence (the
    matched text excluded, OpenAI semantics). Returns (text, matched)."""
    best = -1
    for s in stops:
        i = text.find(s)
        if i >= 0 and (best < 0 or i < best):
            best = i
    return (text[:best], True) if best >= 0 else (text, False)


class StopMatcher:
    """Incremental stop-sequence scanner for a stream of text pieces.

    feed() returns the text that is SAFE to emit: everything up to (and
    excluding) a completed stop match, holding back the longest suffix
    that could still be the prefix of a match split across pieces (max
    stop length - 1 chars). flush() releases the held tail when the
    stream ends without a match, so a client never sees any part of a
    stop sequence, and never loses text to the holdback.
    """

    def __init__(self, stops: list[str]):
        self.stops = [s for s in stops if s]
        self.hold = max((len(s) for s in self.stops), default=1) - 1
        self.buf = ""
        self.stopped = False

    def feed(self, piece: str) -> str:
        if self.stopped or not piece:
            return ""
        self.buf += piece
        trimmed, matched = apply_stop(self.buf, self.stops)
        if matched:
            self.stopped = True
            self.buf = ""
            return trimmed
        if self.hold and len(self.buf) > self.hold:
            safe, self.buf = self.buf[:-self.hold], self.buf[-self.hold:]
            return safe
        if not self.hold:
            safe, self.buf = self.buf, ""
            return safe
        return ""

    def flush(self) -> str:
        tail, self.buf = self.buf, ""
        return "" if self.stopped else tail


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
                    n_in: int, stops: list[str] | None = None) -> dict:
    """The blocking chat.completion body. `stops`: the content is trimmed
    at the earliest match, and finish_reason becomes "stop"."""
    ended = bool(toks) and state.model.cfg.is_eos(toks[-1])
    content_ids = toks[:-1] if ended else toks
    text = decode_text(state.tokenizer, content_ids)
    if stops:
        text, matched = apply_stop(text, stops)
        ended = ended or matched
    return {
        "id": cid,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": state.model_id,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
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


def _adopt_request_id(handler, cid: str) -> str:
    """Cross-tier trace adoption (the reference's _adopt_request_id): an
    X-Cake-Request-Id header becomes THE request id (the contextvar every
    span carries, the id the engine keys its timeline events by, the key
    /api/v1/requests/<id> answers to); without one the completion id is
    the request id. The completion id is registered as an alias, so
    either id finds the timeline."""
    rid = handler.headers.get(TRACE_HEADER) or cid
    set_request_id(rid)
    TIMELINES.begin(rid)
    TIMELINES.event(rid, "received")
    TIMELINES.alias(cid, rid)
    return rid


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
    # continuation mode: a final assistant message with "continue": true
    # is a PARTIAL turn, and generation continues that same message
    continuation = bool(messages[-1].get("continue"))
    if continuation and messages[-1].get("role") != "assistant":
        return handler.send_json(
            {"error": '"continue": true requires the final message to be '
                      "role=assistant (the partial turn being continued)"},
            400)
    try:
        # validated before submit, so that a stream never commits to a 200
        # for a bad request
        kw = gen_kwargs(body)
        stops = stops_from_request(body)
    except (TypeError, ValueError) as e:
        return handler.send_json({"error": f"invalid sampling params: {e}"},
                                 400)
    # the admission plane: QoS class (chat defaults to interactive) and
    # the tenant's bucket and inflight cap, charged BEFORE any queue
    # slot; the inflight lease spans the whole handler, a stream's too
    resolved = resolve_admission(handler, state, body, "interactive")
    if resolved is None:
        return None
    qos, tenant, release = resolved
    try:
        if state.engine is None:
            return _chat_locked(handler, state, messages, continuation, kw,
                                stops, bool(body.get("stream")))
        return _chat_engine(handler, state, messages, continuation, kw,
                            stops, bool(body.get("stream")), qos, tenant)
    finally:
        release()


def _prompt(handler, state, messages, continuation: bool):
    """The prompt's token ids, or None once a 400 / 500 has been sent."""
    try:
        with RECORDER.span("api.chat_prompt", cat="api",
                           messages=len(messages)):
            return (state.tokenizer.continuation_prompt_ids(messages)
                    if continuation
                    else state.tokenizer.chat_prompt_ids(messages))
    except Exception as e:
        if not _client_fault(e):
            log.exception("building the prompt of %d messages failed",
                          len(messages))
            handler.send_json({"error": "internal error"}, 500)
        else:
            handler.send_json({"error": f"cannot build the prompt: {e}"},
                              400)
        return None


def _chat_locked(handler, state, messages, continuation: bool, kw: dict,
                 stops: list[str], stream: bool) -> None:
    """The locked fallback: the prompt built as on the engine path, then
    one generation at a time under state.lock, answered as JSON (the
    content trimmed at `stop`) or SSE."""
    if state.draining:
        return handler.send_json({"error": "server draining for shutdown"},
                                 503, {"Retry-After": "5"})
    cid = _completion_id()
    rid = _adopt_request_id(handler, cid)
    prompt_ids = _prompt(handler, state, messages, continuation)
    if prompt_ids is None:
        return None
    with state.lock:
        if stream:
            tokens, _, cancel = run_generation_streamed(state.model,
                                                        prompt_ids, kw)
            return _sse(handler, state, cid, rid, tokens, cancel.set, stops,
                        _consumed_chars(messages, continuation))
        try:
            toks, stats = run_generation_blocking(state.model, prompt_ids,
                                                  kw)
        except Exception as e:
            log.exception("locked generation failed")
            GENERATIONS.inc(kind="text", status="error")
            # imported on the error path only: a single-node server does
            # not load the cluster package
            from ..cluster.master import ClusterDegradedError
            if isinstance(e, ClusterDegradedError):
                # a worker is quarantined with its retry budget spent:
                # 503, retryable once the restore probe may have revived it
                ra = max(2, int(getattr(state.model, "restore_interval_s",
                                        2)))
                return handler.send_json({"error": str(e)}, 503,
                                         {"Retry-After": str(ra)})
            return handler.send_json({"error": f"generation failed: {e}"},
                                     500)
    GENERATIONS.inc(kind="text", status="ok")
    return handler.send_json(completion_json(
        state, cid, toks, stats, len(prompt_ids), stops),
        headers={TRACE_HEADER: rid})


def _chat_engine(handler, state, messages, continuation: bool, kw: dict,
                 stops: list[str], stream: bool, qos: str,
                 tenant: str | None) -> None:
    """Build the prompt, submit it to the engine under its class and
    tenant, and answer: JSON, SSE, or the typed refusal."""
    cid = _completion_id()
    rid = _adopt_request_id(handler, cid)
    prompt_ids = _prompt(handler, state, messages, continuation)
    if prompt_ids is None:
        return None
    req = _kvshare_before_admission(handler, state, rid, prompt_ids, kw,
                                    qos, tenant)
    resumed = req is not None
    if not resumed:
        try:
            req = state.engine.submit(prompt_ids, request_id=rid, qos=qos,
                                      tenant=tenant, **kw)
        except (QueueFull, EngineDraining) as e:
            return admission_refusal(handler, e)
        except (EngineDown, PoisonedRequest) as e:
            return _send_typed_error(handler, e)
        except ValueError as e:
            return handler.send_json({"error": str(e)}, 400)
    if stream:
        return _stream(handler, state, cid, req, stops,
                       _consumed_chars(messages, continuation), resumed)
    if stops:
        _cancel_at_stop(state, req, stops)
    else:
        # a client that closed its socket (a router's cancelled hedge or
        # failover leg) cancels the request, as the reference's aiohttp
        # handler is cancelled, so that its slot frees at the next step
        left = _ClientWatch(handler.connection, req.done)
        state.engine.wait(req, left)
        if left.is_set():
            req.cancel()
            state.engine.wait(req)
            return None         # nobody reads an answer
    if "error" in req.result:
        GENERATIONS.inc(kind="text", status="error")
        err = req.result["error"]
        if _send_typed_error(handler, err):
            return None
        return handler.send_json({"error": f"generation failed: {err}"},
                                 500)
    GENERATIONS.inc(kind="text", status="ok")
    return handler.send_json(completion_json(
        state, cid, req.result["tokens"], req.result["stats"],
        len(prompt_ids), stops), headers={TRACE_HEADER: rid})


def _kvshare_before_admission(handler, state, rid: str, prompt_ids, kw,
                              qos: str, tenant: str | None):
    """The KV-share tier's step before an admission. With
    X-Cake-KV-Resume: adopt the stream blob staged here for that id
    through the engine's swap resume (returns the live request: its
    sampled sequence continues bit-exactly). Otherwise, with
    X-Cake-KV-Peers: fetch the longest prefix chain a warm peer
    advertises, before the admission below computes the prompt. None in
    every other case; any failure inside (nothing staged, a blob that
    does not fit this pool, a fetch that fails) is never the client's:
    the plain admission follows."""
    kvs = state.kvshare
    if kvs is None:
        return None
    resume_rid = handler.headers.get(KV_RESUME_HEADER)
    if resume_rid:
        try:
            return kvs.submit_job(
                "adopt", {"rid": resume_rid, "sampling": kw["sampling"],
                          "qos": qos, "tenant": tenant}, kvs.fetch_timeout)
        except Exception:
            return None
    peers = handler.headers.get(KV_DIR_HEADER)
    if peers:
        try:
            kvs.fetch_before_prefill(rid, prompt_ids, peers)
        except Exception:
            log.exception("kvshare fetch-before-recompute failed")
    return None


def _stream_migrated(err: BaseException) -> bool:
    """True when the engine failed this request because its KV state was
    parked for fleet migration (the fleet package is looked up, not
    imported: it is loaded wherever kvshare could have raised this)."""
    mod = sys.modules.get("cake_tpu_torch.fleet.kvshare.replica")
    return mod is not None and isinstance(err, mod.StreamMigrated)


def _send_typed_error(handler, err) -> bool:
    """A typed engine failure's documented status (the reference's
    _typed_error_response), shared by the blocking path and the SSE
    path's pre-commit refusal: 503 + Retry-After for a request that
    expired in the queue or a down engine, 504 for a request that
    outlived its deadline, 500 for a poisoned request. False when `err`
    is none of them (the caller decides)."""
    if isinstance(err, (QueueDeadlineExceeded, EngineDown)):
        handler.send_json({"error": str(err)}, 503,
                          {"Retry-After": str(int(err.retry_after_s))})
    elif isinstance(err, RequestDeadlineExceeded):
        handler.send_json({"error": str(err)}, 504)
    elif isinstance(err, PoisonedRequest):
        handler.send_json({"error": str(err)}, 500)
    elif _stream_migrated(err):
        # this (non-streamed) request's KV was parked for migration:
        # answer retryable so the router or client re-runs it elsewhere
        handler.send_json({"error": str(err)}, 503, {"Retry-After": "1"})
    else:
        return False
    return True


def _cancel_at_stop(state, req, stops: list[str]) -> None:
    """Wait for a blocking request while watching its text, and cancel it
    at the first completed stop match, so that its slot frees instead of
    decoding to its budget (completion_json trims the text either way)."""
    matcher, text = StopMatcher(stops), TextStream(state.tokenizer)
    try:
        for tok in state.engine.stream(req):
            if not (matcher.stopped or tok.is_end_of_stream):
                matcher.feed(text.push(tok.id))
                if matcher.stopped:
                    req.cancel()
    except Exception:
        pass            # the request's error is in req.result, read next


class _ClientWatch(threading.Event):
    """Set once the client's socket has closed, which each wait looks at:
    the engine's wait on another event polls it every 20 ms. A wait sleeps
    on the request's own `done`, so a finished request is answered at
    once, not at the end of a poll."""

    def __init__(self, connection, done: threading.Event):
        super().__init__()
        self.connection = connection
        self.done = done

    def wait(self, timeout=None) -> bool:
        if not self.is_set() and client_gone(self.connection):
            self.set()
        if not self.is_set():
            self.done.wait(timeout)
        return self.is_set()


def _consumed_chars(messages, continuation: bool) -> int | None:
    """The continuation handshake's value: the characters of the partial
    assistant turn a continuation consumed (all of it), None otherwise."""
    return len(str(messages[-1].get("content") or "")) if continuation \
        else None


def _stream(handler, state, cid: str, req,
            stops: list[str] | None = None,
            cont_chars: int | None = None, resumed: bool = False) -> None:
    """The engine's SSE answer (_sse). Nothing is committed before the
    request is admitted: one refused outright (engine down, poisoned)
    answers its typed status instead of an in-band error chunk (a queue
    deadline, an engine going down, a quarantined prompt). `resumed`: an
    adopted stream blob, whose answer replays every generated token
    first (one leading chunk, marked by X-Cake-KV-Resumed); one that dies
    before it commits answers 503, so that the router continues the
    stream elsewhere as a plain continuation."""
    state.engine.wait(req, req.admitted)
    err = req.result.get("error") if req.done.is_set() else None
    if err is not None and _send_typed_error(handler, err):
        GENERATIONS.inc(kind="text", status="error")
        return
    if err is not None and resumed:
        GENERATIONS.inc(kind="text", status="error")
        return handler.send_json({"error": f"adopted stream failed: {err}"},
                                 503, {"Retry-After": "1"})
    text = None
    if resumed:
        # the replay goes through the same TextStream the source fed, so
        # the text it joins to is byte for byte what that stream sent and
        # a character split over the break point still waits for its
        # last byte; the router strips it by cumulative position. It is
        # the blob's token record and no more: a token decoded here
        # since the admission is in req.tokens AND on the stream below
        text = TextStream(state.tokenizer)
        replay = "".join(text.push(t) for t in req.tokens[:req.replayed])
    _sse(handler, state, cid, req.id, state.engine.stream(req), req.cancel,
         stops, cont_chars, text=text,
         replay=replay if resumed else None)


def _sse(handler, state, cid: str, trace_id: str, tokens, cancel,
         stops: list[str] | None = None,
         cont_chars: int | None = None, text: "TextStream | None" = None,
         replay: str | None = None) -> None:
    """SSE over an iterator of Tokens (the engine's stream, or the locked
    path's worker): a role chunk, one content chunk per token (a
    character split over tokens goes out with its last token:
    TextStream), a final chunk with finish_reason, then [DONE]. A client
    that goes away calls `cancel`, which frees the slot or the lock.
    `stops`: no part of a stop sequence is ever sent (a StopMatcher over
    the deltas holds back a possible partial match), the stream finishes
    with finish_reason "stop" at a match and `cancel` is called there.
    `cont_chars`: continuation mode only, the X-Cake-Continuation-Chars
    header's value. `replay`: an adopted stream's generated text so far,
    sent as one leading chunk under X-Cake-KV-Resumed (`text`: the
    TextStream that built it, which the new tokens continue); the stop
    matcher sees only the new tokens, as on a continuation leg. A stream
    whose KV the engine parked for migration (StreamMigrated) ends with
    no finish chunk and no [DONE]: the closed socket reads as a break at
    the router, which resumes it from the parked blob."""
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
    # the trace id rides the SSE headers too, so a streaming client can
    # read /api/v1/requests/<id> afterwards
    handler.send_header(TRACE_HEADER, trace_id)
    if cont_chars is not None:
        handler.send_header(CONTINUATION_CHARS_HEADER, str(cont_chars))
    if replay is not None:
        handler.send_header(KV_RESUMED_HEADER, "1")
    handler.end_headers()
    finish = "length"
    if text is None:
        text = TextStream(state.tokenizer)
    matcher = StopMatcher(stops) if stops else None
    matched = False

    def write(delta: str) -> None:
        if delta:
            handler.wfile.write(chunk({"content": delta}))
            handler.wfile.flush()

    def emit(delta: str) -> None:
        nonlocal matched
        if matcher is not None:
            delta = matcher.feed(delta)
            if matcher.stopped:
                # nothing past the match is ever sent; the producer stops
                # here, and the loop drains to its end
                matched = True
                cancel()
        write(delta)
    try:
        handler.wfile.write(chunk({"role": "assistant"}))
        if replay:
            write(replay)
        try:
            for tok in tokens:
                if tok.is_end_of_stream:
                    finish = "stop"
                elif not matched:
                    emit(text.push(tok.id))
            if not matched:
                emit(text.flush())
            if matched:
                finish = "stop"
            elif matcher is not None:
                write(matcher.flush())  # the held-back tail, unmatched
        except Exception as e:      # generation failed mid-stream
            if _stream_migrated(e):
                # sever: no finish chunk, no [DONE]; the router reads the
                # EOF of this close-delimited answer as a break
                handler.wfile.flush()
                handler.close_connection = True
                return
            handler.wfile.write(chunk({"content": f"\n[error: {e}]"}))
            finish = "error"
        GENERATIONS.inc(kind="text",
                        status="error" if finish == "error" else "ok")
        handler.wfile.write(chunk({}, finish=finish))
        handler.wfile.write(b"data: [DONE]\n\n")
        handler.wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
        cancel()
    finally:
        tokens.close()
