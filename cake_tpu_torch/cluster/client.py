"""Master-side proxy for a remote worker (counterpart of
cake_tpu/cluster/client.py): the same forward_hidden(x, cache, pos0,
valid_len) stage interface as LocalStage, over the framed TCP protocol,
one round trip per call, with the per-hop timing echo and RTT
statistics, gray-failure detection, classified StageFailures,
reestablish and goodbye.

Sync sockets: the master's generation loop is sequential per token (the
pipeline is a chain), so async buys nothing on this path. The hidden
state crosses as host bytes: the hop copies it off the device and the
reply back on (DistributedTextModel), the pipeline's own transfer point.

Knobs, read from the environment when a stage is made, with the
reference's defaults: CAKE_HOP_TIMEOUT_S (120, the per-op deadline),
CAKE_HOP_DEGRADED_MS (0 = off, the gray-failure threshold on the rolling
RTT p95) and CAKE_REVIVE_GRACE_S (60, the deadline of the first forward
after a reconnect).
"""
from __future__ import annotations

import hmac
import logging
import os
import socket
import time

from ..obs import (CLUSTER_HOP_DEGRADED, CLUSTER_STAGE_FAILURES,
                   HOP_SECONDS, TIMELINES, now)
from . import faults, proto
from .auth import CHALLENGE_LEN, MAC_LEN, AuthError, mac

log = logging.getLogger("cake_tpu_torch.cluster.client")

CONNECT_RETRIES = 3          # exponential backoff between attempts
CONNECT_BACKOFF = 1.0

# rolling window the gray-failure detector computes its RTT p95 over, and
# the minimum samples before it may trip (one slow op is noise, not gray)
GRAY_WINDOW = 64
GRAY_MIN_SAMPLES = 4


def env_float(name: str, default: float) -> float:
    """A float knob from the environment (unset or empty: the default)."""
    v = os.environ.get(name)
    return float(v) if v else default


class StageFailure(RuntimeError):
    """One classified failure of a remote hop. `kind` drives the recovery
    policy and the failure-counter labels:

      timeout       per-op deadline expired (worker stalled or wedged)
      eof           peer closed the connection (worker crash / drop)
      conn          other transport failure (refused, reset, no channel)
      corrupt       undecodable / desynced frame
      worker_error  the worker answered worker_error (op failed in-place;
                    the connection itself stayed up)
    """

    def __init__(self, kind: str, worker: str, detail: str):
        super().__init__(f"worker {worker}: {kind}: {detail}")
        self.kind = kind
        self.worker = worker
        self.detail = detail


class RemoteStage:
    """A connected, authenticated channel to one worker."""

    SETUP_TIMEOUT = 1800.0   # weight receipt and load

    def __init__(self, host: str, port: int, cluster_key: str,
                 name: str = "?", timeout: float | None = None):
        self.host, self.port = host, port
        self.cluster_key = cluster_key
        self.name = name
        # per-op deadline: every forward's socket reads must complete
        # within this, or the op is classified `timeout` and recovery
        # takes over
        self.timeout = timeout if timeout is not None \
            else env_float("CAKE_HOP_TIMEOUT_S", 120.0)
        # gray-failure threshold: rolling RTT p95 above this flags the hop
        # degraded in /health without failing anything (0 = disabled)
        self.degraded_ms = env_float("CAKE_HOP_DEGRADED_MS", 0.0)
        # the first forward after a reestablish() may pay the re-assigned
        # worker's first use (its kernels' build in a fresh process): it
        # gets this grace deadline instead of the per-op one
        self.revive_grace_s = env_float("CAKE_REVIVE_GRACE_S", 60.0)
        self._revive_grace = False
        self.sock: socket.socket | None = None
        self.info: dict = {}
        self._rid = 0
        from collections import deque
        # (rtt_s, timing-echo dict in ms: read/deser/fwd/ser — empty for
        # workers predating the echo)
        self.rtts: deque = deque(maxlen=512)
        # monotonic timestamps of the last forward attempt / success on
        # this channel — /health reports the success age and flags a
        # worker only when attempts keep happening without successes
        # (an idle channel is not a dead one)
        self.last_attempt: float | None = None
        self.last_ok: float | None = None
        self.total_ops = 0          # cumulative successes (never cleared)
        # recovery memory, filled in by master_setup: the assignment to
        # replay on reconnect and a weight-repush thunk for the (rare)
        # case the worker lost its content-keyed cache too
        self.assignment: dict | None = None
        self.repush = None

    # -- connection --------------------------------------------------------

    def connect(self, attempts: int | None = None,
                backoff: float | None = None):
        """Connect + mutual auth + hello. Recovery passes attempts=1 and
        runs its own jittered backoff around the call."""
        attempts = CONNECT_RETRIES if attempts is None else max(attempts, 1)
        backoff = CONNECT_BACKOFF if backoff is None else backoff
        last = None
        for attempt in range(attempts):
            try:
                self.sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout)
                self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                faults.tag(self.sock, self.name)
                self._auth()
                proto.write_frame_sync(self.sock, proto.hello("master"))
                self.info = proto.read_frame_sync(self.sock)
                return self
            except (OSError, AuthError, proto.ProtocolError) as e:
                last = e
                if self.sock:
                    self.sock.close()
                    self.sock = None
                if attempt == attempts - 1:
                    break               # no dead wait after the final attempt
                wait = backoff * (2 ** attempt)
                log.warning("connect to %s:%d failed (%s), retry in %.1fs",
                            self.host, self.port, e, wait)
                time.sleep(wait)
        raise ConnectionError(
            f"cannot reach worker {self.name} at {self.host}:{self.port}: {last}")

    def _auth(self):
        """Master side of the mutual HMAC handshake (sync mirror of
        auth.authenticate_as_master)."""
        cw = self._recv_exact(CHALLENGE_LEN)
        cm = os.urandom(CHALLENGE_LEN)
        self.sock.sendall(mac(self.cluster_key, cw) + cm)
        their = self._recv_exact(MAC_LEN)
        if not hmac.compare_digest(their, mac(self.cluster_key, cm)):
            raise AuthError("worker failed authentication")

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                # a truncated handshake IS an auth failure (the worker
                # bailed after a bad MAC) — same mapping as auth._read
                raise AuthError("peer closed during auth handshake")
            buf += chunk
        return buf

    def reestablish(self):
        """One reconnect + re-auth + re-assign + ready cycle from the
        remembered assignment — the recovery path's revive step. The
        weight push is skipped when the worker still acks its
        content-keyed cache (`transfer_cached`); a worker that lost the
        cache too gets the weights re-streamed via the repush thunk."""
        self.close()
        self.connect(attempts=1)
        if self.assignment is None:
            return self
        resp = self.assign(self.assignment)
        if resp.get("t") == "worker_error":
            raise RuntimeError(
                f"worker {self.name} re-assign failed: {resp['error']}")
        if self.assignment.get("push_weights") and not resp.get("cached",
                                                                False):
            if self.repush is None:
                raise RuntimeError(
                    f"worker {self.name} lost its weight cache and no "
                    "repush source is available")
            self.repush(self, resp)
        self.wait_ready()
        self._revive_grace = True
        return self

    # -- setup -------------------------------------------------------------

    def assign(self, assignment: dict) -> dict:
        proto.write_frame_sync(self.sock, assignment)
        return proto.read_frame_sync(self.sock)      # ack or worker_error

    def push_weights(self, chunk_msgs) -> None:
        for m in chunk_msgs:
            proto.write_frame_sync(self.sock, m)
        proto.write_frame_sync(self.sock, proto.model_done())

    def wait_ready(self) -> dict:
        # setup (receipt + load) can far exceed the per-op forward timeout
        self.sock.settimeout(self.SETUP_TIMEOUT)
        try:
            msg = proto.read_frame_sync(self.sock)
        finally:
            self.sock.settimeout(self.timeout)
        if msg.get("t") != "worker_ready" or not msg.get("ok", False):
            raise RuntimeError(
                f"worker {self.name} setup failed: {msg.get('error', msg)}")
        return msg

    # -- inference (stage interface) ----------------------------------------

    def forward_hidden(self, x, cache, pos0, valid_len, kv_hint=None):
        """x: a host tensor (or a packed wire dict). cache is managed
        worker-side per connection; the local `cache` slot is passed
        through untouched (None). kv_hint: the master's current cache
        bucket, so the worker sizes its cache to match. Returns (a CPU
        tensor in the worker's dtype, cache).

        Every failure mode surfaces as a classified StageFailure so the
        master's recovery loop (master._recover) can decide policy; after
        a transport-level failure the channel is closed — its stream state
        is unknowable, and a late reply would desync request ids."""
        self._rid += 1
        t0 = now()
        self.last_attempt = t0
        graced = False
        try:
            if self.sock is None:
                raise self._classify("conn", "not connected", close=False)
            if self._revive_grace:
                self._revive_grace = False
                graced = True
                self.sock.settimeout(max(self.timeout, self.revive_grace_s))
            proto.write_frame_sync(self.sock, proto.forward(
                x, int(pos0),
                None if valid_len is None else int(valid_len), self._rid,
                kv_hint=kv_hint))
            msg = proto.read_frame_sync(self.sock)
        except StageFailure:
            raise
        except (socket.timeout, TimeoutError) as e:
            raise self._classify("timeout", e, close=True) from e
        except ConnectionError as e:
            raise self._classify("eof", e, close=True) from e
        except OSError as e:
            raise self._classify("conn", e, close=True) from e
        except proto.ProtocolError as e:
            raise self._classify("corrupt", e, close=True) from e
        finally:
            if graced and self.sock is not None:
                self.sock.settimeout(self.timeout)
        rtt = now() - t0
        if msg.get("t") == "worker_error":
            # the op failed in-place but the connection loop is alive
            # (no teardown)
            raise self._classify("worker_error", msg["error"], close=False)
        if msg.get("rid", self._rid) != self._rid:
            raise self._classify("corrupt", "response id mismatch",
                                 close=True)
        # successful replies only: error RTTs would pollute the wire stats
        tm = dict(msg.get("tm") or {})
        if "fwd_ms" not in tm and msg.get("fwd_ms"):
            tm["fwd_ms"] = float(msg["fwd_ms"])   # pre-echo workers
        if not graced:
            # the graced post-revive op may carry a first use's build: one
            # such sample would pin the rolling p95 and false-flag a
            # freshly recovered hop as gray for a whole window
            self.rtts.append((rtt, tm))
        self.last_ok = now()
        self.total_ops += 1
        self._observe_hop(rtt, tm)
        # per-request timeline: attribute this hop to the generation in
        # flight (request-id contextvar). A no-op dict lookup when no
        # tier opened a timeline for the id (bench scripts, tests)
        TIMELINES.event(None, "cluster_hop", worker=self.name,
                        ms=round(rtt * 1e3, 3))
        if self.degraded_ms > 0:
            CLUSTER_HOP_DEGRADED.set(1.0 if self.gray_degraded else 0.0,
                                     worker=self.name)
        return proto.unpack_tensor(msg["x"]), cache

    def _classify(self, kind: str, detail, close: bool) -> StageFailure:
        CLUSTER_STAGE_FAILURES.inc(worker=self.name, kind=kind)
        if close:
            self.close()
        return StageFailure(kind, self.name, str(detail))

    # -- gray-failure detection --------------------------------------------

    def rtt_p95_ms(self) -> float | None:
        """Rolling p95 over the most recent GRAY_WINDOW successful ops."""
        rtts = [r for r, _ in list(self.rtts)[-GRAY_WINDOW:]]
        if not rtts:
            return None
        arr = sorted(rtts)
        return round(arr[min(int(len(arr) * 0.95), len(arr) - 1)] * 1e3, 2)

    @property
    def gray_degraded(self) -> bool:
        """True while the hop is slow-but-alive: ops succeed, but the
        rolling RTT p95 exceeds CAKE_HOP_DEGRADED_MS. Surfaces in /health
        (and the cake_cluster_hop_degraded gauge) BEFORE a hard per-op
        deadline turns the slowness into a request failure."""
        if self.degraded_ms <= 0 or len(self.rtts) < GRAY_MIN_SAMPLES:
            return False
        p95 = self.rtt_p95_ms()
        return p95 is not None and p95 > self.degraded_ms

    def _observe_hop(self, rtt: float, tm: dict):
        """Feed the per-hop histograms: whole RTT, each worker-echoed phase,
        and the unattributed remainder (wire = TCP + response write +
        scheduling)."""
        HOP_SECONDS.observe(rtt, worker=self.name, phase="rtt")
        echoed = 0.0
        for k in self._ECHO_PHASES:
            v = tm.get(f"{k}_ms")
            if v is not None:
                HOP_SECONDS.observe(v / 1e3, worker=self.name, phase=k)
                echoed += v / 1e3
        if echoed:
            HOP_SECONDS.observe(max(rtt - echoed, 0.0),
                                worker=self.name, phase="wire")

    _ECHO_PHASES = ("read", "deser", "fwd", "ser")

    def rtt_stats(self) -> dict:
        """Per-hop round-trip accounting. The mean against p50 spread flags
        bimodal stalls (the Nagle / delayed-ACK class). Each RTT splits
        into the phases the worker echoes back (read_/deser_/fwd_/ser_*)
        and the remainder (wire_*: TCP, the response write and
        scheduling), so a tail stall is attributable to one side of the
        link and one phase of the worker's handling."""
        if not self.rtts:
            return {"count": 0}

        def _stats(vals, prefix):
            arr = sorted(vals)
            return {f"{prefix}p50_ms": round(arr[len(arr) // 2] * 1e3, 2),
                    f"{prefix}p95_ms": round(arr[int(len(arr) * 0.95)] * 1e3, 2),
                    f"{prefix}mean_ms": round(sum(arr) / len(arr) * 1e3, 2),
                    f"{prefix}min_ms": round(arr[0] * 1e3, 2)}

        samples = list(self.rtts)
        rtts = [r for r, _ in samples]
        out = {"count": len(rtts), **_stats(rtts, "")}
        for k in self._ECHO_PHASES:
            vals = [t[f"{k}_ms"] / 1e3 for _, t in samples
                    if t.get(f"{k}_ms")]
            if vals:
                out.update(_stats(vals, f"{k}_"))
        # wire remainder only over samples that carry a worker timing: a
        # worker predating the echo would otherwise have its whole RTT
        # misattributed to the wire
        timed = [(r, t) for r, t in samples if t.get("fwd_ms")]
        if timed:
            out.update(_stats(
                [max(r - sum(t.get(f"{k}_ms", 0.0)
                             for k in self._ECHO_PHASES) / 1e3, 0.0)
                 for r, t in timed], "wire_"))
        return out

    def goodbye(self):
        """Best-effort clear of per-connection worker state. Teardown must
        never raise: a timeout, protocol desync, or half-dead socket here
        would otherwise propagate out of master_setup's cleanup (masking
        the original error) or abort an unrelated reset. A channel that
        fails its goodbye is closed — its stream state is unknown, and the
        next forward's `conn` failure routes it into recovery."""
        if self.sock is None:
            return
        try:
            proto.write_frame_sync(self.sock, proto.goodbye())
            proto.read_frame_sync(self.sock)
        except Exception:
            self.close()

    def close(self):
        if self.sock:
            try:
                self.sock.close()
            finally:
                self.sock = None
