"""Fleet router: one HTTP front for N `cli serve` replicas (the port's own
copy of cake_tpu/fleet/router.py, on the standard-library HTTP layer of
fleet/http.py instead of aiohttp).

`cli route` runs this app. It owns three jobs, layered on the registry's
membership machine (fleet/registry.py) and the affinity hash
(fleet/routing.py):

  1. ROUTE — each chat request's conversation head is chain-hashed and
     rendezvous-placed so follow-ups land on the replica already holding
     their prefix KV blocks (warm TTFT); CAKE_FLEET_AFFINITY=0 degrades
     to round-robin for A/B benching.

  2. FAIL OVER — a transport failure or replica 5xx retries on the
     deterministic next-best replica under a per-request budget
     (CAKE_FLEET_RETRIES) with capped-exponential backoff +/-25% jitter.
     Streamed requests fail over invisibly BEFORE the first byte
     reaches the client (the commit point); AFTER it the router
     SELF-HEALS: it keeps a bounded replay buffer of the relayed
     assistant text (CAKE_FLEET_RESUME_BUFFER_KB) and on a break
     re-issues the buffered partial in CONTINUATION MODE (the replica
     prefills prompt + partial and continues the same message) on the
     affinity next-best replica — overlap stripped, chunk ids rewritten
     onto the original stream, relayed on the SAME client socket — up
     to CAKE_FLEET_STREAM_RESUMES times. Only an exhausted budget (or a
     blown buffer) emits the typed SSE error event, whose resume block
     carries a resume_token so the client can still finish via the
     same continuation mode by hand. Requests can optionally hedge
     (CAKE_FLEET_HEDGE_MS): no reply after the threshold fires a
     duplicate at the next-best replica and the first response wins
     ("The Tail at Scale") — streams hedge up to their commit point,
     the first replica to produce a body byte wins the socket.

  3. SHED — a per-replica in-flight cap and a global admission bound
     turn overload into typed 429s AT THE ROUTER (body carries
     shed_by=router), before any replica queues the request; Retry-After
     scales with the fleet backlog. Router drain mirrors engine drain:
     SIGTERM stops admission (503) while in-flight proxies finish.

A streamed answer of the port's replicas is HTTP/1.0 and close-delimited,
so its end of body cannot tell a cut from a finish: an EOF before
`data: [DONE]` is a break (resumed like a severed connection), an EOF
after it a clean end.

With CAKE_KVSHARE on, every outbound attempt carries X-Cake-KV-Peers,
the directory of the OTHER replicas' mirrored prefix-chain inventories
(a cold replica fetches a warm peer's chain instead of re-prefilling),
and a post-commit break first tries to ship the broken owner's stream
blob to the resume target (`_migrate_stream`), whose leg then carries
X-Cake-KV-Resume; a replica that adopted the blob answers
X-Cake-KV-Resumed and replays the stream from token 0, which the relay
strips by the cumulative characters the client already has. With
CAKE_SCALE (or `autoscale=True`) the probe cycle also runs the closed
loop: the lifecycle's sweep, then one autoscaler step on the telemetry
rollup (fleet/autoscale.py, fleet/lifecycle.py).

The router does NOT load a tokenizer, a model or torch: it is a thin tier
that must not claim a CUDA context, can run many-per-region, restart in
milliseconds, and scale separately from the replicas."""
from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import logging
import random
import signal
import uuid

from ..obs import (FLEET_HEDGES, FLEET_KV_MIGRATIONS, FLEET_PROXIED,
                   FLEET_RETRIES, FLEET_SHEDS, FLEET_STREAM_RESUMES,
                   REGISTRY, TRACE_HEADER, TimelineStore, now)
from . import faults, knobs
from .autoscale import Autoscaler, DecisionLog, ScalePolicy
from .http import (App, Request, Response, StreamResponse, json_response,
                   request)
from .kvshare.directory import (KV_DIR_HEADER, KV_RESUME_HEADER,
                                KV_RESUMED_HEADER, encode_directory)
from .lifecycle import ReplicaLifecycle
from .registry import ReplicaRegistry, discover_replicas
from .routing import affinity_key, conversation_head, rank_replicas
from .telemetry import FleetTelemetry

log = logging.getLogger("cake_tpu_torch.fleet")

__all__ = ["FleetRouter", "create_router_app", "serve_router"]

# transport-level failure classes: the replica never (fully) answered.
# InjectedFleetFault subclasses ConnectionError, so drills ride this too,
# and so does http.IncompleteBody (a sized or chunked body cut short).
_TRANSPORT_ERRORS = (ConnectionError, asyncio.TimeoutError, OSError)

# QoS plumbing, mirrored from serve/admission/classes.py by NAME ONLY: the
# router tier stays model-free and import-light (no torch). The replica
# is the authority — it re-resolves and clamps the class; the router only
# needs "is this batch" for early shedding and forwards the headers
# verbatim.
QOS_HEADER = "X-Cake-QoS"
TENANT_HEADER = "X-Cake-Tenant"
_QOS_CLASSES = ("interactive", "standard", "batch")

# continuation handshake, mirrored from api/text.py by NAME ONLY (same
# import-light rule as the QoS headers): a replica answering a
# continuation-mode request reports how many chars of the partial
# assistant text it actually consumed, and the router strips EXACTLY
# the re-emitted remainder from the resumed stream's front. Position
# accounting, not content matching — a suffix-match heuristic cannot
# tell boundary re-emission from genuinely repeating tokens.
CONTINUATION_CHARS_HEADER = "X-Cake-Continuation-Chars"

# the end of an SSE stream, as the replicas send it
_DONE_EVENT = b"[DONE]"


async def _deadline(aw, seconds):
    """Await `aw` under a deadline WITHOUT asyncio.wait_for: wait_for
    runs the awaitable in a child task, and the extra loop ticks that
    costs lose races against data that is already buffered — a replica
    that streams chunks and severs in the same breath would have its
    connection_lost exception processed before the relay loop reads the
    buffered chunks, turning a resumable post-commit break into a
    from-scratch retry. A call_later watchdog cancels in place instead;
    an overrun raises asyncio.TimeoutError (a classified transport
    failure), an external cancellation passes through untouched."""
    if not seconds:
        return await aw
    task = asyncio.current_task()
    fired = []
    handle = asyncio.get_running_loop().call_later(
        seconds, lambda: (fired.append(True), task.cancel()))
    try:
        return await aw
    except asyncio.CancelledError:
        if fired:
            raise asyncio.TimeoutError(
                f"no response within {seconds}s") from None
        raise
    finally:
        handle.cancel()


class _ClientGone(Exception):
    """Our DOWNSTREAM client vanished mid-relay. Distinct from upstream
    transport failures so a disconnecting client is never recorded as a
    replica failure (repeat disconnects would otherwise feed the gray
    detector and eject a healthy replica)."""


class _StreamRelay:
    """Client-side state of ONE streamed request across every replica
    attempt it takes: the (single) prepared client response, the
    identity of the first relayed stream (chunk id / created stamp —
    the resume path rewrites spliced chunks onto them so the client
    sees one continuous completion), and the bounded replay buffer a
    resume splice is rebuilt from. Event-loop-confined, like all
    handler state."""

    def __init__(self, limit_bytes: int):
        self.resp: StreamResponse | None = None
        self.claimed = False        # commit claim (one hedge leg wins)
        self.owner: str | None = None       # replica name that claimed
        self.commit_evt = asyncio.Event()
        self.cid: str | None = None         # first stream's chunk "id"
        self.created = None                 # ... and "created" stamp
        self.chunks = 0             # SSE events relayed to the client
        self.tokens = 0             # content-bearing chunks (~tokens)
        self.content_chars = 0      # relayed content length (always on)
        self.text = ""              # replay buffer (until overflow)
        self.text_bytes = 0         # running UTF-8 size of the buffer
        self.splice_chars = 0       # FULL partial length of the last
                                    # splice request (client's own
                                    # continuation prefix + buffer)
        self.limit = max(int(limit_bytes), 1024)
        self.overflow = False       # buffer blown: splice impossible
        self.opaque = False         # unparseable data event: ditto
        self.finished = False       # a finish_reason reached the client
        self.last_exc: BaseException | None = None

    def account(self, content: str | None, finish) -> None:
        """Fold one relayed chunk into the replay buffer/accounting."""
        if finish:
            self.finished = True
        if content:
            self.tokens += 1
            self.content_chars += len(content)
            if not self.overflow:
                self.text += content
                # running counter: re-encoding the whole buffer per
                # chunk would make the relay O(n^2) in stream length
                self.text_bytes += len(
                    content.encode("utf-8", "surrogatepass"))
                if self.text_bytes > self.limit:
                    # past the bound the splice can no longer be built:
                    # drop the buffer (memory bound is the point) and
                    # let a later break take the typed-error path
                    self.overflow = True
                    self.text = ""

    def spliceable(self) -> bool:
        return not (self.overflow or self.opaque)


class FleetRouter:
    """Router state + handlers. One instance per router process; all
    handler state is event-loop-confined (single asyncio thread), while
    the registry it routes over is thread-safe."""

    def __init__(self, registry: ReplicaRegistry, *,
                 retries: int | None = None,
                 backoff_s: float | None = None,
                 hedge_ms: float | None = None,
                 max_inflight: int | None = None,
                 affinity: bool | None = None,
                 affinity_blocks: int | None = None,
                 attempt_timeout_s: float | None = None,
                 connect_timeout_s: float | None = None,
                 first_byte_timeout_s: float | None = None,
                 probe_s: float | None = None,
                 cluster_key: str | None = None,
                 discover_s: float | None = None,
                 stream_resumes: int | None = None,
                 resume_buffer_kb: int | None = None,
                 autoscale: bool | None = None,
                 kvshare: bool | None = None):
        self.registry = registry
        self.retries = retries if retries is not None \
            else knobs.get("CAKE_FLEET_RETRIES")
        self.backoff_s = backoff_s if backoff_s is not None \
            else knobs.get("CAKE_FLEET_BACKOFF_S")
        self.hedge_ms = hedge_ms if hedge_ms is not None \
            else knobs.get("CAKE_FLEET_HEDGE_MS")
        self.max_inflight = max_inflight if max_inflight is not None \
            else knobs.get("CAKE_FLEET_MAX_INFLIGHT")
        self.affinity = affinity if affinity is not None \
            else knobs.get("CAKE_FLEET_AFFINITY")
        self.affinity_blocks = affinity_blocks if affinity_blocks is not None \
            else knobs.get("CAKE_FLEET_AFFINITY_BLOCKS")
        self.attempt_timeout_s = attempt_timeout_s \
            if attempt_timeout_s is not None \
            else knobs.get("CAKE_FLEET_ATTEMPT_TIMEOUT_S")
        # split deadlines (non-zero defaults): connect bounds the
        # refused/black-holed-SYN shapes, first-byte bounds
        # accept-then-silence — both classify as retryable transport
        # failures, converting a partition into bounded failover instead
        # of an attempt that hangs forever
        self.connect_timeout_s = connect_timeout_s \
            if connect_timeout_s is not None \
            else knobs.get("CAKE_FLEET_CONNECT_TIMEOUT_S")
        self.first_byte_timeout_s = first_byte_timeout_s \
            if first_byte_timeout_s is not None \
            else knobs.get("CAKE_FLEET_FIRST_BYTE_TIMEOUT_S")
        self.probe_s = probe_s if probe_s is not None \
            else knobs.get("CAKE_FLEET_PROBE_S")
        self.cluster_key = cluster_key
        self.discover_s = discover_s if discover_s is not None \
            else knobs.get("CAKE_FLEET_DISCOVER_S")
        self.stream_resumes = stream_resumes if stream_resumes is not None \
            else knobs.get("CAKE_FLEET_STREAM_RESUMES")
        self.resume_buffer_kb = resume_buffer_kb \
            if resume_buffer_kb is not None \
            else knobs.get("CAKE_FLEET_RESUME_BUFFER_KB")
        # fleet-shared KV tier: inject warm-peer directories and ship
        # stream blobs on post-commit breaks
        self.kvshare = kvshare if kvshare is not None \
            else knobs.get("CAKE_KVSHARE")
        self.kv_fetch_timeout_s = knobs.get("CAKE_KVSHARE_FETCH_TIMEOUT_S")
        self.inflight = 0                   # event-loop-confined
        self.draining = False
        # router-tier timeline ring, deliberately SEPARATE from the
        # process-global obs.TIMELINES: the stitched /api/v1/requests
        # view distinguishes tiers by store, and an in-process replica
        # (tests, smokes, embedded topologies) must keep its
        # replica-tier timeline distinct from the router's
        self.timelines = TimelineStore()
        # telemetry plane: fed by the probe loop, served by
        # /api/v1/fleet/telemetry (and the `cli top` dashboard)
        self.telemetry = FleetTelemetry(registry)
        # closed loop: the autoscaler consumes each cycle's rollup and
        # executes through the lifecycle manager (both None when off —
        # CAKE_SCALE gates the subsystem, the telemetry stays advisory)
        enabled = autoscale if autoscale is not None \
            else knobs.get("CAKE_SCALE")
        self.lifecycle = None
        self.autoscaler = None
        if enabled:
            decisions = DecisionLog()
            self.lifecycle = ReplicaLifecycle(registry,
                                              record=decisions.record)
            policy = ScalePolicy.from_knobs()
            if autoscale:       # explicit flag wins over the env knob
                policy = dataclasses.replace(policy, enabled=True)
            self.autoscaler = Autoscaler(registry, self.lifecycle,
                                         policy=policy, log=decisions)
        self._tasks: list = []

    # -- lifecycle -----------------------------------------------------------

    async def start(self, app=None):
        await self._probe_once()
        self._tasks.append(asyncio.create_task(self._probe_loop()))
        if self.cluster_key and self.discover_s > 0:
            self._tasks.append(asyncio.create_task(self._discover_loop()))
        self.registry.publish()

    async def stop(self, app=None):
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        if self.lifecycle is not None:
            await self.lifecycle.close()

    async def drain(self, app=None):
        """SIGTERM mirror of the engine drain: stop admission (new chats
        answer 503 + Retry-After) and wait for in-flight proxied
        requests to finish their final chunks, up to the same
        CAKE_DRAIN_TIMEOUT_S budget the replicas use."""
        self.draining = True
        deadline = now() + knobs.get("CAKE_DRAIN_TIMEOUT_S")
        while self.inflight > 0 and now() < deadline:
            await asyncio.sleep(0.05)
        if self.inflight:
            log.warning("router drain timed out with %d in flight",
                        self.inflight)

    # -- probe / discovery loops ---------------------------------------------

    async def _probe_once(self):
        tmo = max(min(self.probe_s, 2.0), 0.2)

        async def get_health(rep):
            async with await request("GET", rep.base_url + "/health",
                                     connect_timeout=tmo) as r:
                data = await r.read()
                return r.status, json.loads(data or b"null")

        async def probe(rep):
            try:
                status, body = await asyncio.wait_for(get_health(rep), tmo)
                rep.observe_health(status, body)
            except asyncio.CancelledError:
                raise
            except Exception:
                rep.observe_health(None, None)
        # concurrent: one unreachable replica must not stall health
        # detection for the whole fleet (each dead probe burns its full
        # timeout; serially that would multiply the effective cadence)
        await asyncio.gather(*(probe(r)
                               for r in self.registry.replicas()))
        self.registry.publish()
        # membership events (partition suspected/healed) land in
        # per-replica pseudo-timelines (rid "replica:<name>") on the
        # router-tier store, so an episode is visible in the stitched
        # timeline view next to the requests it disrupted
        for kind, attrs in self.registry.drain_events():
            rid = f"replica:{attrs.get('replica', '?')}"
            self.timelines.begin(rid, tier="fleet")
            self.timelines.event(rid, kind, **attrs)
        # same cadence as the probes: scrape /metrics and roll up the
        # telemetry plane (stale replicas were just flagged above, so
        # this cycle's rollup already excludes them)
        try:
            await self.telemetry.step()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("telemetry rollup failed (cycle skipped)")
        # the closed loop rides the same cadence: reap unexpected
        # deaths first (the controller must see the hole this cycle),
        # then decide on the rollup just computed
        if self.autoscaler is not None:
            try:
                self.lifecycle.sweep()
                self.autoscaler.step(self.telemetry.snapshot())
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("autoscale step failed (cycle skipped)")

    async def _probe_loop(self):
        """Health-driven membership: every tick consumes each replica's
        /health engine block into its state machine — ejects on
        down/wedged, readmits ejected replicas whose hold expired and
        whose probes came back healthy, mirrors queue depth / occupancy
        into the autoscaling gauges."""
        while True:
            await asyncio.sleep(self.probe_s)
            await self._probe_once()

    async def _discover_loop(self):
        """Periodic UDP re-discovery over the cluster PSK plumbing: new
        `cli serve --announce` replicas join without a router restart."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.discover_s)
            try:
                found = await loop.run_in_executor(
                    None, lambda: discover_replicas(self.cluster_key))
            except Exception:
                continue
            for name, base_url in found:
                self.registry.add(name, base_url)

    # -- admission / shedding ------------------------------------------------

    def _global_cap(self) -> int:
        if self.max_inflight > 0:
            return self.max_inflight
        return max(self.registry.total_capacity(), 1)

    def _retry_after(self) -> int:
        """Backlog-proportional Retry-After, the router-level analog of
        the engine's retry_after_hint: the fleet queue depth per
        routable replica."""
        routable = max(self.registry.routable_count(), 1)
        depth = self.registry.total_queue_depth() + self.inflight
        return max(1, min(30, 1 + depth // routable))

    def _shed(self, reason: str, rid: str | None = None) -> Response:
        FLEET_SHEDS.inc(reason=reason)
        FLEET_PROXIED.inc(outcome="shed")
        if rid:
            self.timelines.event(rid, "shed", reason=reason)
        return json_response(
            {"error": f"fleet overloaded: {reason}", "shed_by": "router"},
            status=429,
            headers={"Retry-After": str(self._retry_after())})

    def _no_replica(self, rid: str | None = None) -> Response:
        FLEET_PROXIED.inc(outcome="failed")
        if rid:
            self.timelines.event(rid, "shed", reason="no_replica")
        # during an in-flight scale-out the honest wait is the expected
        # spawn-to-routable time, not the backlog formula — a client
        # arriving mid cold start should wait the spawn out, not give up
        eta = self.lifecycle.pending_spawn_eta() \
            if self.lifecycle is not None else None
        body = {"error": "no routable replica (all ejected, draining, or "
                         "none registered)", "shed_by": "router"}
        if eta is not None:
            body["scale_out_pending"] = True
        return json_response(
            body, status=503,
            headers={"Retry-After": str(eta if eta is not None
                                        else self._retry_after())})

    # -- candidate ordering --------------------------------------------------

    def _order(self, messages: list) -> list:
        """Replica objects in attempt order: rendezvous over the
        conversation head's chain key (owner first, deterministic
        next-best after), or round-robin rotation when affinity is
        off."""
        names = self.registry.names()
        if not names:
            return []
        if self.affinity and messages:
            key = affinity_key(conversation_head(messages),
                               self.affinity_blocks)
            # weighted rendezvous: probed capacity (engine slots from
            # /health) scales each replica's score, so a heterogeneous
            # fleet places conversations proportionally
            weights = {r.name: r.weight()
                       for r in self.registry.replicas()}
            ranked = rank_replicas(key, names, weights)
        else:
            start = self.registry.next_rr() % len(names)
            ranked = sorted(names)
            ranked = ranked[start:] + ranked[:start]
        by_name = {r.name: r for r in self.registry.replicas()}
        return [by_name[n] for n in ranked if n in by_name]

    async def _sleep_backoff(self, attempt: int):
        """Capped exponential +/-25% jitter between failover attempts —
        the cluster recovery scheme, scaled for a request path."""
        base = min(self.backoff_s * (2 ** max(attempt - 1, 0)),
                   max(self.backoff_s * 8, 1.0))
        await asyncio.sleep(base * (0.75 + 0.5 * random.random()))

    # -- one outbound attempt ------------------------------------------------

    async def _post_json(self, rep, body: dict, hdrs: dict):
        """POST the chat to `rep` and read the whole answer: (status,
        content type, bytes, ttfb ms). The connect deadline bounds the
        handshake and the first-byte deadline each read gap (the wait
        for the headers, then the body), as the reference's aiohttp
        sock_read does."""
        t0 = now()
        r = await _deadline(
            request("POST", rep.base_url + "/v1/chat/completions",
                    json_body=body, headers=hdrs,
                    connect_timeout=self.connect_timeout_s or None),
            self.first_byte_timeout_s)
        async with r:
            ttfb_ms = (now() - t0) * 1e3
            data = await _deadline(r.read(), self.first_byte_timeout_s)
            return r.status, r.content_type, data, ttfb_ms

    async def _one_json(self, rep, body: dict, rid: str | None = None,
                        fwd: dict | None = None):
        """One non-streamed attempt against `rep`. Returns
        ("skip", None)       — replica at cap / not acquirable,
        ("retryable", str)   — transport failure, replica 5xx or 429,
        ("final", Response)  — relay this (200 or non-retryable 4xx).
        Acquires and releases the replica's routing slot itself so a
        hedge winner can cancel the loser without leaking the slot."""
        lease = rep.try_acquire()
        if not lease:
            return ("skip", None)
        try:
            hook = faults.FAULT_HOOK
            if hook is not None:
                stall = hook.on_attempt(rep.name)
                if stall:
                    await asyncio.sleep(stall)
            hdrs = self._trace_headers(rid, fwd)
            peers = self._kv_peers(rep)
            if peers:
                hdrs[KV_DIR_HEADER] = peers
            # the deprecated total attempt deadline still rides on top of
            # the split ones when set
            status, ctype, data, ttfb_ms = await _deadline(
                self._post_json(rep, body, hdrs), self.attempt_timeout_s)
            if status in (500, 502, 503):
                rep.record_result(False, lease=lease)
                if rid:
                    self.timelines.event(rid, "attempt", replica=rep.name,
                                         outcome="retryable",
                                         status=status)
                return ("retryable", f"{rep.name}: upstream {status}")
            if status == 429:
                # replica backpressure is load, not sickness: do not
                # feed the failure detector, just go elsewhere
                if rid:
                    self.timelines.event(rid, "attempt", replica=rep.name,
                                         outcome="saturated", status=429)
                return ("retryable",
                        f"{rep.name}: replica saturated (429)")
            rep.record_result(True, ttfb_ms, lease=lease)
            if rid:
                self.timelines.event(rid, "attempt", replica=rep.name,
                                     outcome="final", status=status,
                                     ttfb_ms=round(ttfb_ms, 3))
            resp = Response(data, status, ctype or "application/json")
            if rid:
                resp.headers[TRACE_HEADER] = rid
            return ("final", resp)
        except _TRANSPORT_ERRORS as e:
            rep.record_result(False, transport=True, lease=lease)
            if rid:
                self.timelines.event(rid, "attempt", replica=rep.name,
                                     outcome="transport_error", status=0)
            return ("retryable",
                    f"{rep.name}: {type(e).__name__}: {e}")
        finally:
            rep.release(lease)

    @staticmethod
    def _trace_headers(rid: str | None,
                       fwd: dict | None = None) -> dict:
        """Headers for one outbound attempt: the trace id (the replica
        adopts it into its request-id contextvar and its serve engine
        keys timeline events by it, so the router's
        /api/v1/requests/<id> can stitch both tiers) plus the
        passthrough admission headers captured in handle_chat —
        X-Cake-QoS / X-Cake-Tenant / Authorization — so the replica's
        admission plane sees the same class and tenant the router shed
        against."""
        out = dict(fwd) if fwd else {}
        if rid:
            out[TRACE_HEADER] = rid
        return out

    def _kv_peers(self, target) -> str | None:
        """X-Cake-KV-Peers value for one outbound attempt: every OTHER
        replica's registry-mirrored chain inventory. Draining/cordoned
        peers advertise on purpose — a replica on its way out is exactly
        the one whose cache peers should siphon — while ejected/stale/
        sick inventories come back empty (kv_inventory + probe
        retraction). None — header not injected — when kvshare is off
        or no peer has anything to advertise."""
        if not self.kvshare:
            return None
        peers = []
        for rep in self.registry.replicas():
            if rep.name == target.name:
                continue
            chains = rep.kv_inventory()
            if chains:
                peers.append((rep.base_url, chains))
        return encode_directory(peers)

    @staticmethod
    def _fwd_headers(req: Request) -> dict:
        """The admission headers a chat request carries through the
        router verbatim (class override, tenant key, auth credential —
        the replica re-resolves and clamps; the router never rewrites
        them)."""
        out = {}
        for h in (QOS_HEADER, TENANT_HEADER, "Authorization"):
            v = req.headers.get(h)
            if v:
                out[h] = v
        return out

    # -- request paths -------------------------------------------------------

    async def handle_chat(self, req: Request):
        if self.draining:
            return json_response(
                {"error": "router draining for shutdown"}, status=503,
                headers={"Retry-After": str(self._retry_after())})
        try:
            body = await req.json()
        except Exception:
            return json_response({"error": "invalid JSON body"},
                                 status=400)
        messages = body.get("messages") if isinstance(body, dict) else None
        if not isinstance(messages, list) or not messages:
            return json_response({"error": "messages[] required"},
                                 status=400)
        # cross-tier trace id: adopt the client's (a chained router, a
        # test harness) or mint one; it is injected into every outbound
        # attempt, adopted by the replica's API + serve engine, echoed
        # on the response, and keys this tier's timeline — one id end
        # to end
        rid = req.headers.get(TRACE_HEADER) \
            or "trace-" + uuid.uuid4().hex[:16]
        self.timelines.begin(rid, tier="router")
        # the admission class travels with the request (header or body
        # field); the REPLICA's plane is the authority that validates
        # and tenant-clamps it — the router only sheds early on it
        qos = str(req.headers.get(QOS_HEADER)
                  or body.get("qos") or "interactive").strip().lower()
        if qos not in _QOS_CLASSES:
            qos = "interactive"         # replica answers the 400
        fwd = self._fwd_headers(req)
        # router-level admission: shed BEFORE any replica queues it.
        # Batch sheds FIRST — at CAKE_QOS_BATCH_SHED_FRAC of the global
        # cap — so under pressure the remaining in-flight headroom stays
        # reserved for interactive traffic (batch clients hold their
        # Retry-After; chat keeps flowing)
        cap = self._global_cap()
        if self.inflight >= cap:
            return self._shed("global admission bound", rid)
        frac = knobs.get("CAKE_QOS_BATCH_SHED_FRAC")
        if qos == "batch" and frac < 1.0 \
                and self.inflight >= max(1, int(cap * frac)):
            return self._shed("batch_pressure", rid)
        order = self._order(messages)
        if not any(r.routable() for r in order):
            return self._no_replica(rid)
        self.timelines.event(rid, "route",
                             candidates=[r.name for r in order],
                             stream=bool(body.get("stream")), qos=qos)
        self.inflight += 1
        try:
            if body.get("stream"):
                return await self._route_stream(req, body, order, rid,
                                                fwd=fwd)
            if self.hedge_ms > 0:
                return await self._route_json_hedged(body, order, rid,
                                                     fwd=fwd)
            return await self._route_json(body, order, 1 + self.retries,
                                          rid=rid, fwd=fwd)
        finally:
            self.inflight -= 1

    async def _route_json(self, body: dict, order: list, budget: int,
                          prior_attempts: int = 0,
                          rid: str | None = None,
                          fwd: dict | None = None) -> Response:
        """Sequential failover over `order` under an attempt budget.
        `prior_attempts`: attempts already spent by a caller (the hedged
        path) — they count against the budget and keep the exhausted-503
        honest about how many replicas were really tried."""
        attempts = prior_attempts
        cap_skipped = False
        detail = None
        for i, rep in enumerate(order):
            if attempts >= budget:
                break
            if not rep.routable():
                continue
            kind, val = await self._one_json(rep, body, rid, fwd)
            if kind == "skip":
                cap_skipped = True
                continue
            attempts += 1
            if kind == "final":
                FLEET_PROXIED.inc(
                    outcome="ok" if val.status < 400 else "failed")
                if rid:
                    self.timelines.event(rid, "done", status=val.status)
                return val
            detail = val
            # back off only when another attempt can actually happen —
            # sleeping after the last candidate just delays the 503
            if attempts < budget \
                    and any(r.routable() for r in order[i + 1:]):
                FLEET_RETRIES.inc()
                if rid:
                    self.timelines.event(rid, "retry")
                await self._sleep_backoff(attempts)
        if attempts == 0:
            return self._shed("replica in-flight caps", rid) \
                if cap_skipped else self._no_replica(rid)
        FLEET_PROXIED.inc(outcome="failed")
        if rid:
            self.timelines.event(rid, "done", status=503)
        return json_response(
            {"error": "fleet failover budget exhausted",
             "attempts": attempts, "last": detail, "shed_by": "router"},
            status=503,
            headers={"Retry-After": str(self._retry_after())})

    async def _route_json_hedged(self, body: dict, order: list,
                                 rid: str | None = None,
                                 fwd: dict | None = None) -> Response:
        """Tail-hedged non-streamed path: if the owner has not answered
        within CAKE_FLEET_HEDGE_MS, fire a duplicate at the next-best
        replica and take whichever finishes first (the loser is
        cancelled — its socket closes, which cancels its generation on a
        port replica — and its routing slot released by _one_json's
        finally). Falls back to the sequential path when fewer than two
        replicas are routable, or for the remaining budget after both
        hedge legs fail."""
        reps = [r for r in order if r.routable()]
        if len(reps) < 2:
            return await self._route_json(body, order, 1 + self.retries,
                                          rid=rid, fwd=fwd)
        primary = asyncio.create_task(
            self._one_json(reps[0], body, rid, fwd))
        done, _ = await asyncio.wait({primary},
                                     timeout=self.hedge_ms / 1e3)
        tasks = {primary}
        tried = 1
        if not done:
            FLEET_HEDGES.inc()
            if rid:
                self.timelines.event(rid, "hedge", replica=reps[1].name)
            tasks.add(asyncio.create_task(
                self._one_json(reps[1], body, rid, fwd)))
            tried = 2
        pending = tasks
        non_final = 0
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    kind, val = t.result()
                    if kind == "final":
                        FLEET_PROXIED.inc(
                            outcome="ok" if val.status < 400
                            else "failed")
                        if rid:
                            self.timelines.event(rid, "done",
                                                 status=val.status)
                        return val
                    if kind != "skip":      # at-cap skips spend no budget
                        non_final += 1
        finally:
            for t in pending:
                t.cancel()
        # every fired leg failed/skipped: sequential over the replicas
        # not yet tried (when the primary failed fast the hedge never
        # fired, so reps[1] — the deterministic next-best — must still
        # get its attempt). Hedge attempts count against the budget via
        # prior_attempts, which also keeps the terminal 503 reporting
        # "budget exhausted after N attempts" rather than the misleading
        # no-replica message when reps[tried:] is empty.
        rest = reps[tried:]
        if non_final and any(r.routable() for r in rest):
            FLEET_RETRIES.inc()             # hedge -> sequential handoff
            if rid:
                self.timelines.event(rid, "retry")
        return await self._route_json(body, rest, 1 + self.retries,
                                      prior_attempts=non_final, rid=rid,
                                      fwd=fwd)

    async def _route_stream(self, req: Request, body: dict,
                            order: list, rid: str | None = None,
                            fwd: dict | None = None):
        """SSE relay with pre-commit failover/hedging and post-commit
        SELF-HEALING: attempts rotate replicas until one starts
        streaming; once the first byte has been relayed the request is
        COMMITTED to that replica's stream identity, and a break after
        commit is spliced back together — the buffered partial content
        is re-issued in continuation mode on the affinity next-best
        survivor and the continuation relayed on the SAME client socket
        — up to CAKE_FLEET_STREAM_RESUMES times. Only an exhausted
        budget (or a blown replay buffer) emits the typed error event,
        which carries a resume_token for a manual continuation."""
        st = _StreamRelay(self.resume_buffer_kb * 1024)
        bs = {"attempts": 0, "budget": 1 + self.retries,
              "cap_skipped": False}
        # rng-fold parity exception rides the resume: a sampled stream
        # (temperature > 0) still resumes, but its continuation draws
        # from a fresh fold — flagged on the timeline, same documented
        # exception as a crash rebuild
        sampled = float(body.get("temperature", 0.7) or 0.0) > 0.0
        if self.hedge_ms > 0:
            kind, val = await self._stream_first_hedged(
                req, body, order, rid, fwd, st, bs)
        else:
            kind, val = await self._stream_seq(
                req, body, order, rid, fwd, st, bs)
        failed: set = set()
        resumes = 0
        while kind == "broken":
            broken = val
            failed.add(broken.name)
            if st.finished:
                # the break lost only the [DONE] sentinel (the finish
                # chunk already reached the client): close the stream
                # clean — there is nothing left to resume
                return await self._finish_interrupted(st, rid)
            max_tok = int(body.get("max_tokens",
                                   body.get("max_completion_tokens",
                                            256)) or 256)
            if st.tokens >= max_tok:
                # every budgeted token was already delivered — only the
                # finish chunk and [DONE] died with the connection. A
                # splice here would decode PAST the client's budget
                # (max_tokens clamps at 1), so synthesize the finish
                # instead of resuming a completed generation.
                return await self._finish_interrupted(st, rid,
                                                      synth_finish=True)
            if resumes >= self.stream_resumes:
                FLEET_STREAM_RESUMES.inc(outcome="exhausted")
                return await self._stream_broken_terminal(
                    st, rid, broken, resumes)
            if not st.spliceable():
                FLEET_STREAM_RESUMES.inc(outcome="overflow")
                return await self._stream_broken_terminal(
                    st, rid, broken, resumes)
            resumes += 1
            if rid:
                self.timelines.event(rid, "stream_resume",
                                     replica=broken.name, attempt=resumes,
                                     **({"sampled": True} if sampled
                                        else {}))
            splice = self._splice_body(body, st)
            # affinity next-best over the (unchanged) conversation head:
            # the survivor ranked after the broken owner most likely
            # holds the shared prefix blocks, so the splice prefill is
            # the warm path. Replicas that already broke THIS stream
            # are skipped even if not yet ejected; the resume is a
            # fresh outbound placement, so it rotates under its own
            # attempt budget rather than whatever the initial
            # placement left over.
            rbs = {"attempts": 0, "budget": 1 + self.retries,
                   "cap_skipped": False}
            order = self._order(splice["messages"])
            # fleet-shared KV tier: before the continuation splice, try
            # to ship the broken owner's parked swap blob (drain parks
            # it; post-commit failover where the source still answers
            # exports the live slot — fetching IS the migration signal)
            # to the first viable survivor. Success marks that leg with
            # X-Cake-KV-Resume and orders the target first; every
            # failure mode falls through to the splice continuation,
            # which is the same request body either way.
            kv_resume = None
            if self.kvshare and rid:
                target = next((r for r in order
                               if r.name not in failed and r.routable()),
                              None)
                if target is not None and await self._migrate_stream(
                        broken, target, rid):
                    kv_resume = (target.name, rid)
                    order = [target] + [r for r in order
                                        if r.name != target.name]
            kind, val = await self._stream_seq(
                req, splice, order, rid, fwd, st, rbs, resumed=True,
                skip=failed, kv_resume=kv_resume)
            if kind == "none":
                FLEET_STREAM_RESUMES.inc(outcome="error")
                return await self._stream_broken_terminal(
                    st, rid, broken, resumes)
            if kind == "broken":
                FLEET_STREAM_RESUMES.inc(outcome="broken")
        if kind == "final":
            if resumes:
                FLEET_STREAM_RESUMES.inc(outcome="ok")
            if rid:
                self.timelines.event(rid, "done", status=val.status)
            return val
        # kind == "none": the stream never started anywhere
        if bs["attempts"] == 0:
            return self._shed("replica in-flight caps", rid) \
                if bs["cap_skipped"] else self._no_replica(rid)
        FLEET_PROXIED.inc(outcome="failed")
        if rid:
            self.timelines.event(rid, "done", status=503)
        return json_response(
            {"error": "fleet failover budget exhausted (stream never "
                      "started)", "attempts": bs["attempts"],
             "shed_by": "router"},
            status=503,
            headers={"Retry-After": str(self._retry_after())})

    async def _stream_seq(self, req, body, order: list,
                          rid: str | None, fwd: dict | None,
                          st: _StreamRelay, bs: dict,
                          resumed: bool = False, skip=(),
                          kv_resume: tuple | None = None):
        """Sequential streamed placement over `order` under bs's shared
        attempt budget: rotate candidates until one commits (relays a
        byte to the client). Pre-commit failures stay invisible.
        Returns ("final", resp) | ("broken", replica) | ("none", None);
        `skip` names replicas that already broke this stream;
        `kv_resume` = (replica_name, rid) marks the ONE candidate that
        holds a migrated stream blob — only its leg carries the
        X-Cake-KV-Resume header, so a rotation past it degrades to the
        plain continuation splice."""
        for i, rep in enumerate(order):
            if bs["attempts"] >= bs["budget"]:
                break
            if rep.name in skip or not rep.routable():
                continue
            kind, val = await self._stream_leg(req, rep, body, rid,
                                               fwd, st, resumed,
                                               kv_resume)
            if kind == "skip":
                bs["cap_skipped"] = True
                continue
            if kind == "lost":              # hedge twin owns the socket
                continue
            if kind in ("final", "broken"):
                return (kind, val)
            bs["attempts"] += 1
            # back off only when another attempt can actually happen
            rest = [r for r in order[i + 1:]
                    if r.name not in skip and r.routable()]
            if bs["attempts"] < bs["budget"] and rest:
                FLEET_RETRIES.inc()
                if rid:
                    self.timelines.event(rid, "retry")
                await self._sleep_backoff(bs["attempts"])
        return ("none", None)

    async def _stream_leg(self, req, rep, body, rid, fwd,
                          st: _StreamRelay, resumed: bool = False,
                          kv_resume: tuple | None = None):
        """One streamed attempt holding its own routing-slot lease (so
        a hedge winner can cancel the loser without leaking it)."""
        lease = rep.try_acquire()
        if not lease:
            return ("skip", None)
        try:
            return await self._relay_stream(req, rep, body, lease,
                                            rid, fwd, st, resumed,
                                            kv_resume)
        finally:
            rep.release(lease)

    async def _stream_first_hedged(self, req, body, order: list,
                                   rid: str | None, fwd: dict | None,
                                   st: _StreamRelay, bs: dict):
        """Pre-commit tail hedge for streams: if the owner has produced
        no body byte after CAKE_FLEET_HEDGE_MS, fire a duplicate at the
        next-best replica; the FIRST leg to claim the commit point owns
        the client socket and the loser is cancelled before it can ever
        write (the claim is the exclusion — a leg checks-and-sets it
        with no await in between). Hedge attempts spend the shared
        budget exactly like the non-streamed path; falls back to the
        sequential relay when fewer than two replicas are routable or
        every fired leg dies pre-commit."""
        reps = [r for r in order if r.routable()]
        if len(reps) < 2:
            return await self._stream_seq(req, body, order, rid, fwd,
                                          st, bs)
        legs: dict = {}

        def fire(rep):
            legs[rep.name] = asyncio.create_task(
                self._stream_leg(req, rep, body, rid, fwd, st))
        fire(reps[0])
        await asyncio.wait(set(legs.values()),
                           timeout=self.hedge_ms / 1e3)
        if not st.claimed and not legs[reps[0].name].done():
            FLEET_HEDGES.inc()
            if rid:
                self.timelines.event(rid, "hedge", replica=reps[1].name)
            fire(reps[1])
        tried = len(legs)
        watch = asyncio.create_task(st.commit_evt.wait())
        result = None
        try:
            pending = set(legs.values())
            while pending and result is None:
                done, _ = await asyncio.wait(
                    pending | {watch},
                    return_when=asyncio.FIRST_COMPLETED)
                if st.claimed:
                    # a leg owns the socket: cancel the one that lost
                    # the race (still pre-commit by construction) and
                    # ride the winner to its terminal state
                    for name, t in legs.items():
                        if name != st.owner and not t.done():
                            t.cancel()
                    result = await legs[st.owner]
                    break
                for t in done:
                    if t is watch:
                        continue
                    pending.discard(t)
                    kind, val = t.result()
                    if kind == "final":
                        result = (kind, val)
                        break
                    if kind in ("skip", "lost"):
                        if kind == "skip":
                            bs["cap_skipped"] = True
                        continue
                    bs["attempts"] += 1     # pre-commit failure
        finally:
            watch.cancel()
            for t in legs.values():
                if not t.done():
                    t.cancel()
            await asyncio.gather(*legs.values(), return_exceptions=True)
        if result is not None:
            return result
        # every fired leg failed pre-commit: sequential over the rest
        rest = reps[tried:]
        if bs["attempts"] and any(r.routable() for r in rest):
            FLEET_RETRIES.inc()             # hedge -> sequential handoff
            if rid:
                self.timelines.event(rid, "retry")
            # same spacing as every other failover attempt: a fleet-wide
            # hiccup (both hedge legs 503ing) must not be hammered with
            # a zero-delay third attempt
            await self._sleep_backoff(max(bs["attempts"], 1))
        return await self._stream_seq(req, body, rest, rid, fwd, st, bs)

    # -- resume plumbing -----------------------------------------------------

    async def _migrate_stream(self, broken, target, rid: str) -> bool:
        """Ship a broken stream's swap blob from its (possibly still
        answering) owner to `target`. Two bounded hops under the fetch
        timeout: GET the blob off the source — the source parks the
        slot on this fetch if it is still live — then POST it to the
        target, which stages it for the X-Cake-KV-Resume adoption.
        False (metrics say why) means the resume plane falls back to
        the continuation splice; a migration can never make a break
        worse, only cheaper."""
        tmo = self.kv_fetch_timeout_s or None
        url = "/api/v1/kv/stream/" + rid
        route = {"from": broken.name, "to": target.name}

        async def get_blob():
            async with await request("GET", broken.base_url + url,
                                     connect_timeout=tmo) as r:
                return r.status, await r.read()

        async def post_blob(blob):
            async with await request(
                    "POST", target.base_url + url, data=blob,
                    headers={"Content-Type": "application/x-cake-kv-blob"},
                    connect_timeout=tmo) as r:
                await r.read()
                return r.status
        try:
            status, blob = await _deadline(get_blob(), tmo)
        except _TRANSPORT_ERRORS:
            # the break that got us here usually took the whole replica
            # down — an unreachable source is the EXPECTED shape, not
            # an error worth a second failure record against it
            status, blob = None, b""
        if status != 200:
            # 404 = never parked / already swept; 409 = kvshare off on
            # the source; 503 = export timed out. All the same to the
            # resume plane: no blob to ship.
            FLEET_KV_MIGRATIONS.inc(outcome="source_miss")
            self.timelines.event(rid, "kv_migrate", outcome="source_miss",
                                 **route)
            return False
        try:
            status = await _deadline(post_blob(blob), tmo)
        except _TRANSPORT_ERRORS:
            status = None
        if status != 200:
            FLEET_KV_MIGRATIONS.inc(outcome="ship_error")
            self.timelines.event(
                rid, "kv_migrate", outcome="ship_error", **route,
                **({"status": status} if status is not None else {}))
            return False
        FLEET_KV_MIGRATIONS.inc(outcome="shipped")
        self.timelines.event(rid, "kv_migrate", outcome="shipped", **route,
                             bytes=len(blob))
        return True

    @staticmethod
    def _splice_body(body: dict, st: _StreamRelay) -> dict:
        """The continuation-mode request that resumes a broken stream:
        original messages + the buffered partial as a final assistant
        turn with `"continue": true` (merged in place when the client
        was ITSELF already continuing), token budget reduced by what
        was already generated so the resumed replica produces exactly
        the remainder. Records the FULL partial length on the relay
        state — the continuation-chars handshake reports consumption
        against the whole merged partial, not just the buffer."""
        msgs = [dict(m) if isinstance(m, dict) else m
                for m in (body.get("messages") or [])]
        if msgs and isinstance(msgs[-1], dict) \
                and msgs[-1].get("continue") \
                and msgs[-1].get("role") == "assistant":
            msgs[-1]["content"] = str(msgs[-1].get("content") or "") \
                + st.text
        else:
            msgs.append({"role": "assistant", "content": st.text,
                         "continue": True})
        st.splice_chars = len(str(msgs[-1]["content"]))
        out = dict(body)
        out["messages"] = msgs
        max_tok = body.get("max_tokens", body.get("max_completion_tokens"))
        if max_tok is not None:
            out.pop("max_completion_tokens", None)
            out["max_tokens"] = max(int(max_tok) - st.tokens, 1)
        return out

    @staticmethod
    def _resume_token(st: _StreamRelay, resumes: int) -> str:
        """The typed error's machine-readable half: the splice
        accounting a client needs to verify its own continuation
        (committed text length + generated-token count — NOT the event
        count, which includes role/finish chunks) before finishing the
        stream by hand. base64url JSON, inspectable on purpose."""
        tok = {"v": 1, "mode": "continue",
               "content_chars": st.content_chars,
               "tokens_generated": st.tokens,
               "chunks_relayed": st.chunks,
               "resumes_attempted": resumes}
        return base64.urlsafe_b64encode(
            json.dumps(tok, separators=(",", ":")).encode()).decode()

    async def _stream_broken_terminal(self, st: _StreamRelay,
                                      rid: str | None, rep,
                                      resumes: int) -> StreamResponse:
        """Self-healing gave up (budget exhausted, buffer blown, or no
        survivor could splice): emit the typed error event + [DONE] so
        the client sees a structured failure it can finish by hand via
        continuation mode — never a silent dead socket."""
        FLEET_PROXIED.inc(outcome="broken_stream")
        e = st.last_exc
        payload = {"error": {
            "type": "replica_stream_broken",
            "replica": rep.name,
            "message": f"{type(e).__name__}: {e}" if e is not None
                       else "stream broken after commit",
            "resume": {
                "chunks_relayed": st.chunks,
                "content_chars": st.content_chars,
                "tokens_generated": st.tokens,
                "resumes_attempted": resumes,
                "resume_token": self._resume_token(st, resumes),
                "hint": "append the received partial text as "
                        '{"role": "assistant", "content": <text>, '
                        '"continue": true} and re-issue: the replica '
                        "continues the same message in place "
                        "(prefix-affinity lands the retry warm; greedy "
                        "continuations are bit-identical)",
            },
        }}
        if rid:
            self.timelines.event(rid, "done", status=200)
        try:
            await st.resp.write(b"data: "
                                + json.dumps(payload).encode() + b"\n\n")
            await st.resp.write(b"data: [DONE]\n\n")
            await st.resp.write_eof()
        except _TRANSPORT_ERRORS:
            pass                        # client also gone
        return st.resp

    async def _finish_interrupted(self, st: _StreamRelay,
                                  rid: str | None,
                                  synth_finish: bool = False
                                  ) -> StreamResponse:
        """Close a broken stream that has nothing left to generate.
        `synth_finish`: the break also ate the finish chunk (the whole
        token budget was delivered) — emit one in the original stream's
        identity so the client sees a complete, well-formed stream."""
        FLEET_PROXIED.inc(outcome="ok")
        if rid:
            self.timelines.event(rid, "done", status=200)
        try:
            if synth_finish:
                chunk = {"object": "chat.completion.chunk",
                         "choices": [{"index": 0, "delta": {},
                                      "finish_reason": "length"}]}
                if st.cid is not None:
                    chunk["id"] = st.cid
                if st.created is not None:
                    chunk["created"] = st.created
                await st.resp.write(b"data: "
                                    + json.dumps(chunk).encode()
                                    + b"\n\n")
            await st.resp.write(b"data: [DONE]\n\n")
            await st.resp.write_eof()
        except _TRANSPORT_ERRORS:
            pass
        return st.resp

    async def _relay_stream(self, req, rep, body,
                            lease: str = "slot", rid: str | None = None,
                            fwd: dict | None = None,
                            st: _StreamRelay | None = None,
                            resumed: bool = False,
                            kv_resume: tuple | None = None):
        """One streamed attempt relayed onto the client socket held by
        `st`. Returns:
          ("final", resp)  — terminal: clean end, a relayed refusal, or
                             the client itself went away;
          ("none", True)   — nothing (new) reached the client; the
                             caller may rotate to another candidate;
          ("lost", None)   — a hedge twin claimed the socket first;
          ("broken", rep)  — transport break AFTER this attempt relayed
                             bytes; st carries the replay buffer.
        Non-resumed attempts relay events verbatim while ACCOUNTING the
        delta text into the replay buffer; resumed attempts PARSE and
        REWRITE — the duplicate assistant-role chunk is dropped,
        retokenization overlap against the buffer tail is stripped, and
        the chunk id / created stamp are rewritten to the first
        stream's so the client sees one continuous completion."""
        hook = faults.FAULT_HOOK
        t0 = now()
        chunks = 0          # events read from THIS upstream (fault seam)
        relayed = 0         # events THIS attempt wrote to the client
        # full partial length of the splice request (client's own
        # continuation prefix included) — consumption is reported
        # against this, not just the router's buffer
        splice_chars = st.splice_chars if resumed else 0
        strip_left = 0      # re-emitted overlap chars still to drop
        stripped = 0        # overlap chars dropped at the splice point
        ttfb_ms = None
        done_seen = False   # `data: [DONE]` read from THIS upstream
        try:
            if hook is not None:
                stall = hook.on_attempt(rep.name)
                if stall:
                    await asyncio.sleep(stall)
            # streams: connect deadline on the handshake, first-byte
            # deadline on the wait for response HEADERS — a replica
            # sends its headers before its first token, so the
            # accept-then-silence black hole fails here in bounded time
            # as a retryable transport failure. The body relay stays
            # UNBOUNDED: generation time is open-ended and the
            # stream-resume plane owns mid-body breaks.
            hdrs = self._trace_headers(rid, fwd)
            peers = self._kv_peers(rep)
            if peers:
                hdrs[KV_DIR_HEADER] = peers
            if kv_resume is not None and kv_resume[0] == rep.name:
                # this candidate staged the migrated stream blob: ask
                # it to adopt instead of splice-prefilling (the body is
                # still the splice, so a failed adoption inside the
                # replica falls through to the same continuation)
                hdrs[KV_RESUME_HEADER] = kv_resume[1]
            r = await _deadline(
                request("POST", rep.base_url + "/v1/chat/completions",
                        json_body=body, headers=hdrs,
                        connect_timeout=self.connect_timeout_s or None),
                self.first_byte_timeout_s)
            async with r:
                if r.status != 200:
                    data = await r.read()
                    if r.status in (500, 502, 503):
                        rep.record_result(False, lease=lease)
                        return ("none", True)
                    if r.status == 429:
                        return ("none", True)
                    if resumed:
                        # a refusal cannot be relayed onto a socket that
                        # is already a committed 200 SSE stream: count
                        # the candidate out and rotate (the replica
                        # answered, so it is not a transport failure)
                        rep.record_result(True, (now() - t0) * 1e3,
                                          lease=lease)
                        return ("none", True)
                    # non-retryable refusal (400 etc.): relay verbatim
                    rep.record_result(True, (now() - t0) * 1e3,
                                      lease=lease)
                    FLEET_PROXIED.inc(
                        outcome="ok" if r.status < 400 else "failed")
                    return ("final", Response(
                        data, r.status,
                        r.content_type or "application/json"))
                if resumed:
                    if r.headers.get(KV_RESUMED_HEADER):
                        # blob-adopted resume: the replica replays the
                        # FULL generated text from token 0 (the swap
                        # blob's token record), so the re-emitted
                        # prefix is everything the client has received
                        # across ALL previous legs — cumulative
                        # position, not the splice-consumption formula.
                        # Text past the cumulative mark is generated-
                        # but-never-relayed tail the break ate: it
                        # relays as new content, which is exactly right.
                        strip_left = st.content_chars
                    else:
                        # deterministic overlap: the replica says how
                        # much of the partial its continuation consumed
                        # (the port's consume all of it); the difference
                        # is re-emitted text the client already has. No
                        # header = assume exact continuation, strip
                        # nothing.
                        hdr = r.headers.get(CONTINUATION_CHARS_HEADER)
                        if hdr is not None:
                            try:
                                strip_left = max(
                                    splice_chars - int(hdr), 0)
                            except ValueError:
                                strip_left = 0
                buf = b""
                async for piece in r.iter_any():
                    if not piece:
                        continue
                    buf += piece
                    # relay whole SSE events, not TCP pieces: the break
                    # drill (and the resume accounting) count EVENTS,
                    # which TCP coalescing would otherwise blur
                    while b"\n\n" in buf:
                        event, buf = buf.split(b"\n\n", 1)
                        event += b"\n\n"
                        if hook is not None and hook.break_stream(
                                rep.name, chunks):
                            raise faults.InjectedFleetFault(
                                f"fault injected: stream to {rep.name} "
                                f"severed after {chunks} chunks")
                        chunks += 1
                        if ttfb_ms is None:
                            ttfb_ms = (now() - t0) * 1e3
                        if not resumed and st.claimed \
                                and st.owner != rep.name:
                            # a hedge twin claimed the socket between
                            # our upstream read and this event: stand
                            # down BEFORE parsing — a loser that folded
                            # its own stream's cid/opaque flags into the
                            # shared relay state would poison the
                            # winner's replay buffer
                            return ("lost", None)
                        # parse the event for the replay buffer (and,
                        # on a resumed leg, to rewrite/strip it)
                        content = finish = None
                        obj = None
                        if event.startswith(b"data:"):
                            pl = event[5:].strip()
                            if pl == _DONE_EVENT:
                                done_seen = True
                            else:
                                try:
                                    obj = json.loads(pl)
                                except Exception:
                                    # opaque payload: relayable, but a
                                    # future splice could not rebuild
                                    # it — disable resume honestly
                                    st.opaque = True
                        if isinstance(obj, dict):
                            choice = (obj.get("choices") or [{}])[0] or {}
                            delta = choice.get("delta") or {}
                            content = delta.get("content")
                            finish = choice.get("finish_reason")
                            if not resumed and st.cid is None \
                                    and obj.get("id"):
                                st.cid = obj["id"]
                                st.created = obj.get("created")
                        out = event
                        if resumed and isinstance(obj, dict):
                            if "role" in (choice.get("delta") or {}) \
                                    and not content:
                                continue    # duplicate assistant header
                            if strip_left and content:
                                cut = min(len(content), strip_left)
                                strip_left -= cut
                                stripped += cut
                                content = content[cut:]
                                choice["delta"]["content"] = content
                                if not content and finish is None:
                                    continue    # chunk fully re-emitted
                            if st.cid is not None and obj.get("id"):
                                obj["id"] = st.cid
                                if st.created is not None:
                                    obj["created"] = st.created
                            out = b"data: " \
                                + json.dumps(obj).encode() + b"\n\n"
                        if st.resp is None:
                            st.claimed = True
                            st.owner = rep.name
                            if rid:
                                self.timelines.event(
                                    rid, "commit", replica=rep.name,
                                    ttfb_ms=round(ttfb_ms, 3))
                            hdrs = {
                                "Content-Type": "text/event-stream",
                                "Cache-Control": "no-cache",
                            }
                            if rid:
                                hdrs[TRACE_HEADER] = rid
                            st.resp = StreamResponse(headers=hdrs)
                            st.commit_evt.set()
                            try:
                                await st.resp.prepare(req)
                            except _TRANSPORT_ERRORS as we:
                                raise _ClientGone() from we
                        try:
                            await st.resp.write(out)
                        except _TRANSPORT_ERRORS as we:
                            raise _ClientGone() from we
                        if resumed and relayed == 0 and rid:
                            self.timelines.event(
                                rid, "resume_spliced", replica=rep.name,
                                overlap_chars=stripped)
                        relayed += 1
                        st.chunks += 1
                        st.account(content, finish)
                if st.resp is None:
                    # upstream 200 with an empty body: broken replica
                    rep.record_result(False, lease=lease)
                    return ("none", True)
                if resumed and relayed == 0:
                    # a 200 that relayed nothing new (only a role chunk
                    # or pure overlap): a failed splice candidate, not
                    # a finished stream
                    rep.record_result(False, lease=lease)
                    return ("none", True)
                if r.close_delimited and not done_seen:
                    # the port's replicas close-delimit their SSE: an
                    # EOF before [DONE] is the replica dying mid-stream,
                    # not the end of the answer
                    raise ConnectionResetError(
                        f"{rep.name}: stream closed before [DONE]")
                if buf:
                    try:
                        await st.resp.write(buf)    # non-event tail
                    except _TRANSPORT_ERRORS as we:
                        raise _ClientGone() from we
                rep.record_result(True, ttfb_ms, lease=lease)
                FLEET_PROXIED.inc(outcome="ok")
                await st.resp.write_eof()
                return ("final", st.resp)
        except _ClientGone:
            # the CLIENT went away, the replica was fine: closing the
            # upstream socket cancels the replica-side generation (its
            # disconnect sweep frees the slot) and no failure is
            # recorded against it — a resume the client abandoned is
            # NOT replica evidence either
            rep.record_result(True, (now() - t0) * 1e3,
                              lease=lease)
            FLEET_PROXIED.inc(outcome="ok")
            return ("final",
                    st.resp if st.resp is not None and st.resp.prepared
                    else Response(b"", 200))
        except _TRANSPORT_ERRORS as e:
            rep.record_result(False, transport=True, lease=lease)
            if st.resp is None or relayed == 0:
                return ("none", True)   # nothing (new) was relayed
            # break AFTER bytes reached the client: hand the replay
            # buffer back to _route_stream, whose resume budget decides
            # between a transparent splice and the typed error event
            st.last_exc = e
            if rid:
                self.timelines.event(rid, "stream_broken",
                                     replica=rep.name, chunks=st.chunks)
            return ("broken", rep)

    # -- passthrough + introspection ----------------------------------------

    async def _get(self, url: str, timeout_s: float):
        """(status, content type, bytes) of one GET under a deadline."""
        async def fetch():
            async with await request("GET", url,
                                     connect_timeout=timeout_s) as r:
                return r.status, r.content_type, await r.read()
        return await asyncio.wait_for(fetch(), timeout_s)

    async def handle_models(self, req: Request) -> Response:
        for rep in self.registry.replicas():
            if not rep.routable():
                continue
            try:
                status, ctype, data = await self._get(
                    rep.base_url + "/v1/models", 5.0)
                return Response(data, status, ctype or "application/json")
            except _TRANSPORT_ERRORS:
                continue
        return self._no_replica()

    async def handle_health(self, req: Request) -> Response:
        snap = self.registry.snapshot()
        ok = snap["routable"] > 0 and not self.draining
        body = {"status": "ok" if ok else "degraded",
                "fleet": snap, "inflight": self.inflight,
                "global_cap": self._global_cap()}
        if self.draining:
            body["draining"] = True
        return json_response(body, status=200 if ok else 503)

    async def handle_fleet(self, req: Request) -> Response:
        return json_response(self.registry.snapshot())

    async def handle_fleet_telemetry(self, req: Request) -> Response:
        """Decision-grade rollups (fleet/telemetry.py): series, burn
        rates, headroom, outliers — the autoscaler/`cli top` feed.
        With the closed loop on, the body carries the autoscaler's
        compact summary so `cli top` renders its row from one GET."""
        body = self.telemetry.snapshot()
        if self.autoscaler is not None:
            body = dict(body)
            body["autoscale"] = self.autoscaler.summary()
        return json_response(body)

    async def handle_fleet_autoscale(self, req: Request) -> Response:
        """The decisions ring + policy + lifecycle process view
        (fleet/autoscale.py); {"enabled": false} when the loop is off."""
        if self.autoscaler is None:
            return json_response({"enabled": False})
        return json_response(self.autoscaler.snapshot())

    async def handle_request_index(self, req: Request) -> Response:
        return json_response({"requests": self.timelines.ids()})

    async def handle_request_trace(self, req: Request) -> Response:
        """Fleet-wide stitched timeline: this tier's routing events
        (route/attempt/retry/hedge/commit/done) plus the replica tier's
        lifecycle events for the same id, fetched from the replica the
        attempt events name (falling back to asking every registered
        replica — the id may predate this router process). Each tier
        carries its own start_unix anchor, so a consumer lays both on
        one wall-clock axis."""
        rid = req.match_info["rid"]
        own = self.timelines.get(rid)
        tiers = [own] if own is not None else []
        names = {e.get("replica") for e in (own or {}).get("events", [])
                 if e.get("replica")}
        reps = self.registry.replicas()
        candidates = [r for r in reps if r.name in names] or reps

        # concurrent: the all-replicas fallback must not serialize one
        # probe timeout per unreachable member (debugging happens
        # exactly when some of the fleet is down)
        async def fetch(rep):
            try:
                status, _, data = await self._get(
                    rep.base_url + "/api/v1/requests/" + rid, 2.0)
                if status != 200:
                    return None
                body = json.loads(data)
                body["replica"] = rep.name
                return body
            except (*_TRANSPORT_ERRORS, ValueError):
                return None
        for body in await asyncio.gather(*(fetch(r) for r in candidates)):
            if body is not None:
                tiers.append(body)
        if not tiers:
            return json_response(
                {"error": f"no timeline for request {rid!r} at the "
                          "router or any replica"}, status=404)
        return json_response({"request_id": rid, "tiers": tiers})


async def _metrics(req: Request) -> Response:
    return Response(REGISTRY.render().encode(),
                    content_type="text/plain; version=0.0.4; charset=utf-8")


def create_router_app(router: FleetRouter) -> App:
    """The router's routes and hooks; `await app.start(host, port)`
    serves them. /fleet is the reference's membership view, and
    /api/v1/fleet the same body under the port's API prefix."""
    app = App()
    app.router = router
    app.add_post("/v1/chat/completions", router.handle_chat)
    app.add_get("/v1/models", router.handle_models)
    app.add_get("/health", router.handle_health)
    app.add_get("/fleet", router.handle_fleet)
    app.add_get("/api/v1/fleet", router.handle_fleet)
    app.add_get("/api/v1/fleet/telemetry", router.handle_fleet_telemetry)
    app.add_get("/api/v1/fleet/autoscale", router.handle_fleet_autoscale)
    app.add_get("/api/v1/requests", router.handle_request_index)
    app.add_get("/api/v1/requests/{rid}", router.handle_request_trace)
    app.add_get("/metrics", _metrics)
    app.on_startup.append(router.start)
    app.on_shutdown.append(router.drain)
    app.on_cleanup.append(router.stop)
    return app


def serve_router(replicas: list, host: str = "0.0.0.0", port: int = 8100,
                 cluster_key: str | None = None,
                 autoscale: bool | None = None, **discovery):
    """Blocking router entry (ref: `cake route`). `replicas` is
    [(name, base_url), ...] from --replica flags; when a cluster key is
    given, announced replicas discovered over UDP join too (and keep
    joining every CAKE_FLEET_DISCOVER_S); `discovery` passes
    discover_replicas' `addresses` / `discovery_port` through.
    `autoscale` turns the closed loop on regardless of CAKE_SCALE (None
    defers to the knob); CAKE_KVSHARE turns the KV-share tier on.
    SIGINT / SIGTERM drain and stop it (and reap the replicas the
    lifecycle spawned)."""
    registry = ReplicaRegistry()
    router = FleetRouter(registry, cluster_key=cluster_key,
                         autoscale=autoscale)
    for name, base_url in replicas:
        registry.add(name, base_url)
    if cluster_key:
        for name, base_url in discover_replicas(cluster_key, **discovery):
            registry.add(name, base_url)
    app = create_router_app(router)

    async def main():
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        bound = await app.start(host, port)
        log.warning("fleet router on http://%s:%d fronting %d replicas",
                    bound[0], bound[1], len(registry.names()))
        try:
            await stop.wait()
        finally:
            await app.stop()
    asyncio.run(main())
