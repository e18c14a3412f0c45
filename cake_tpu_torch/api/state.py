"""The locked one-request path and the wait for a job (counterpart of
cake_tpu/api/state.py: run_generation_blocking, GenerationCancelled,
run_generation_streamed, await_job; the API builds the prompt ids, so the
reference's messages-or-ids dispatch has no caller here).

A model the engine does not serve (an offloaded MoE model, or any model
with CAKE_SERVE_SLOTS=0; serve/engine.py: maybe_engine) generates one
request at a time under the server's lock (server.py: AppState.lock).
The HTTP server already gives each connection a thread, so a blocking
generation runs in the handler's thread; a streamed one runs on a worker
thread that puts each Token on a queue as the model samples it, while the
handler writes the SSE chunks. Setting the cancel flag (the client went
away, or a stop sequence matched) makes the worker raise
GenerationCancelled at its next token, so the lock frees at once instead
of after the budget.

`await_job` waits for an image job in the handler's thread, and cancels
it once the client's socket has closed, so its step loop stops at the
next checkpoint instead of finishing for nobody.
"""
from __future__ import annotations

import contextvars
import queue as queue_mod
import select
import socket
import threading

# how long a reader waits on the token queue before it checks that the
# worker still runs
POLL_S = 0.5
# how long the stream's end waits for the worker to finish
JOIN_S = 30.0


def client_gone(sock) -> bool:
    """True once the peer has closed the connection (the socket reads
    EOF) or the socket has failed; a pipelined next request is data, not
    a close."""
    try:
        readable, _, _ = select.select([sock], [], [], 0)
        return bool(readable) and sock.recv(1, socket.MSG_PEEK) == b""
    except (OSError, ValueError):
        return True


def await_job(job, connection=None, poll_s: float = POLL_S / 5) -> bool:
    """Wait for a GenerationJob's terminal state. With the client's
    socket, poll it every poll_s: a closed one cancels the job and
    returns False at once (its thread unwinds at the next checkpoint).
    True once the job is done."""
    while not job.wait(poll_s):
        if connection is not None and client_gone(connection):
            job.cancel()
            return False
    return True


def run_generation_blocking(model, prompt_ids: list[int], gen_kwargs: dict):
    """A whole generation with no token callback, in the caller's thread
    (the handler's). Returns (token_ids, stats)."""
    return model.generate(prompt_ids, **gen_kwargs)


class GenerationCancelled(Exception):
    """Raised inside the worker to end a cancelled stream."""


def run_generation_streamed(model, prompt_ids: list[int], gen_kwargs: dict):
    """The generation on a worker thread (carrying the caller's context,
    so its spans keep the request id). Returns (tokens, result, cancel):
    `tokens` iterates the Tokens as they are sampled and, once the worker
    is done, raises its error if it failed; `result` gets "tokens" and
    "stats", or "cancelled", or "error"; `cancel` is a threading.Event
    the worker checks at each token. Leaving the iterator early sets it."""
    q: queue_mod.Queue = queue_mod.Queue()
    done = object()
    result: dict = {}
    cancel = threading.Event()
    ctx = contextvars.copy_context()

    def emit(tok):
        if cancel.is_set():
            raise GenerationCancelled()
        q.put(tok)

    def worker():
        try:
            toks, stats = ctx.run(model.generate, prompt_ids,
                                  on_token=emit, **gen_kwargs)
            result["tokens"] = toks
            result["stats"] = stats
        except GenerationCancelled:
            result["cancelled"] = True
        except Exception as e:          # raised to the stream's reader
            result["error"] = e
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True,
                         name="cake-torch-locked-generation")
    t.start()

    def tokens():
        try:
            while True:
                try:
                    item = q.get(timeout=POLL_S)
                except queue_mod.Empty:
                    if not t.is_alive() and q.empty():
                        break           # the worker died without its end
                    continue
                if item is done:
                    break
                yield item
        finally:
            cancel.set()
            t.join(timeout=JOIN_S)
        if "error" in result:
            raise result["error"]

    return tokens(), result, cancel
