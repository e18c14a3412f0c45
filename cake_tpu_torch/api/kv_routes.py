"""Fleet-shared KV tier routes (counterpart of cake_tpu/api/kv_routes.py):
prefix-blob export/import and stream-blob migration, for the
standard-library server in server.py.

  GET  /api/v1/kv/prefix/{chain}  export a cached prefix chain as a wire
                                  blob (404 = not cached here)
  POST /api/v1/kv/prefix/{chain}  install a prefix blob into the local
                                  prefix cache (fetch-before-recompute
                                  pulls instead, but this makes warming a
                                  replica scriptable)
  GET  /api/v1/kv/stream/{rid}    export a parked (or live — fetching IS
                                  the migration signal) stream's swap
                                  blob
  POST /api/v1/kv/stream/{rid}    stage a migrated stream blob; the
                                  resumed request (X-Cake-KV-Resume)
                                  adopts it

All four answer 409 when kvshare is off, 503 when the scheduler job
misses its deadline, and every structural problem is a typed
KVBlobMismatch -> 422: a peer treats anything but 200 as "fetch failed,
recompute honestly". A blob travels as application/x-cake-kv-blob; a
prefix export also reports its phases in X-Cake-KV-Timing
("export_ms=..,encode_ms=..").

Each route is `(handler, state, arg)`: the handler's send_json /
send_body answer it.
"""
from __future__ import annotations

BLOB_CT = "application/x-cake-kv-blob"
PREFIX = "/api/v1/kv/"
# route kind -> the endpoint label the request counters carry
ENDPOINTS = {"prefix": PREFIX + "prefix/{chain}",
             "stream": PREFIX + "stream/{rid}"}


def split(path: str) -> tuple[str, str] | None:
    """("prefix" | "stream", its argument) of a kv route's path, or
    None."""
    if not path.startswith(PREFIX):
        return None
    kind, _, arg = path[len(PREFIX):].partition("/")
    if kind not in ENDPOINTS or not arg or "/" in arg:
        return None
    return kind, arg


def _kvshare_of(handler, state):
    ks = state.kvshare
    if ks is None:
        handler.send_json({"error": "kvshare disabled on this replica "
                                    "(CAKE_KVSHARE off or no paged prefix "
                                    "cache)"}, 409)
    return ks


def _body(handler) -> bytes:
    n = int(handler.headers.get("Content-Length") or 0)
    return handler.rfile.read(n) if n > 0 else b""


def kv_get(handler, state, kind: str, arg: str) -> None:
    ks = _kvshare_of(handler, state)
    if ks is None:
        return
    timing = {}
    try:
        if kind == "prefix":
            blob = ks.export_prefix(arg, ks.fetch_timeout, timing)
        else:
            blob = ks.export_stream(arg, ks.fetch_timeout)
    except TimeoutError:
        return handler.send_json({"error": f"{kind} export timed out"}, 503)
    if blob is None:
        return handler.send_json(
            {"error": "chain not cached here" if kind == "prefix"
             else "no such parked or migratable stream"}, 404)
    headers = {}
    if kind == "prefix":
        headers["X-Cake-KV-Timing"] = ",".join(
            f"{k}={v}" for k, v in timing.items())
    handler.send_body(blob, 200, BLOB_CT, headers)


def kv_post(handler, state, kind: str, arg: str) -> None:
    from ..fleet.kvshare import KVBlobMismatch
    ks = _kvshare_of(handler, state)
    if ks is None:
        return
    data = _body(handler)
    try:
        if kind == "prefix":
            res = ks.import_prefix(data, ks.fetch_timeout)
        else:
            res = ks.store_inbound(arg, data)
    except KVBlobMismatch as e:
        return handler.send_json({"error": str(e)}, 422)
    except TimeoutError:
        return handler.send_json({"error": "import timed out"}, 503)
    handler.send_json(res)
