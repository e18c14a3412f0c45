"""Replica side of the fleet-shared KV tier (the port's copy of
cake_tpu/fleet/kvshare/replica.py).

One KVShareReplica rides each serve engine (wired by the API server when
CAKE_KVSHARE is on; the engine holds it duck-typed as `kv_share`, so the
serve package never imports the fleet). It owns three jobs:

  * prefix blob plane — export a prefix-cache chain's pinned blocks as a
    wire blob (GET /api/v1/kv/prefix/<chain>) and install a fetched blob
    into the local PagedPrefixCache through the same pin machinery a
    local capture uses, so a fetched chain is indistinguishable from a
    locally computed one (greedy outputs stay bit-identical);
  * fetch-before-recompute — on admission, consult the router-injected
    peer directory header and fetch the longest matching chain from a
    warm peer instead of re-prefilling, bounded by
    CAKE_KVSHARE_FETCH_TIMEOUT_S; every failure mode degrades to honest
    recompute;
  * live stream migration — park a draining slot's swap blob
    (PagedKV.swap_out: KV bytes + row state + decode carries + the
    generated-token record) for the router's resume plane to ship to a
    new owner, which adopts it through the engine's swap resume and
    continues the stream bit-exactly (the key and counter carries ride
    the blob).

The port's decode carries are its own (toks, pos, recents, keys,
counters: serve/engine.py's swap), where the reference carries (toks,
pos, rngs, recents): a stream blob moves only between port replicas, and
one that is not the port's is refused at adoption (the resume falls back
to the continuation splice). Prefix blobs carry no carries: a JAX replica
and a port replica of the same pool geometry install each other's.

Threading model: the prefix cache and the paged pool are scheduler-thread
state, so every mutation runs as a mailbox job drained by run_pending()
at the top of each engine iteration (the engine calls it before its idle
return, and submit_job sets the engine's wake event, so an idle engine
still serves blobs promptly). API threads block on a per-job event with a
deadline. The routes' and the fetch's jobs only gather or install tensors:
the blob's encode and decode (a checksum over tens of MB) run in the API
thread, where the reference runs them inside the job, so that a blob does
not stall the decode of every other slot. The port's API server is the standard library's threaded
server, so the fetch itself is a blocking http.client call inside the
handler's thread, under the same deadline. The only cross-thread reads
outside the mailbox are the inventory mirror (an atomically swapped
tuple) and the parked/inbound stores (dict ops under self._lock).
"""
from __future__ import annotations

import hashlib
import http.client
import logging
import socket
import threading
from collections import deque
from urllib.parse import urlsplit

import numpy as np
import torch

from ...obs import (FLEET_KV_FETCH_BYTES, FLEET_KV_FETCHES,
                    FLEET_KV_HIT_RATIO, SERVE_PREFIX_BYTES,
                    SERVE_SLOTS_BUSY, TIMELINES, now)
from ...serve.engine import ServeRequest
from ...serve.paged.preempt import PreemptedSlot
from ...serve.prefix_cache import _PagedEntry
from .. import knobs
from .blob import (KVBlobMismatch, decode_blob, dtype_name, encode_blob,
                   pool_signature)
from .directory import parse_directory

__all__ = ["KVShareReplica", "StreamMigrated"]

log = logging.getLogger("cake_tpu_torch.fleet.kvshare")

# parked stream blobs nobody fetched are dropped after this many
# seconds (host RAM; the client's own retry has long moved on)
_PARKED_TTL_S = 60.0

# the port's swap carries, in PagedKV.swap_out order
_CARRIES = ("toks", "pos", "recents", "keys", "counters")

# a fetch reads its blob in pieces of this size, checking the deadline
# between them
_READ_CHUNK = 1 << 20


class StreamMigrated(RuntimeError):
    """This live stream's KV state was parked for migration: the slot is
    gone and the blob is waiting for the router's resume plane. The SSE
    handler severs the socket mid-body (NO clean finish) so the router
    classifies the leg as broken and runs its resume machinery."""

    def __init__(self, rid: str):
        super().__init__(
            f"stream {rid} migrated: swap blob parked for the fleet "
            "resume plane")
        self.rid = rid


def _chain_of(ids, block: int) -> list[bytes]:
    """Unit keys of a token record that is an exact multiple of the unit
    size — one key per STORED unit. (PrefixCache.chain_keys caps at
    (n-1)//block because an admission must keep one live suffix token;
    an exported entry's record covers exactly its units, so the export
    and import sides hash the full record with this instead.)"""
    ids = np.asarray(ids, np.int32)
    h = hashlib.blake2b(digest_size=16)
    keys = []
    for b in range(len(ids) // block):
        h.update(ids[b * block:(b + 1) * block].tobytes())
        keys.append(h.digest())
    return keys


def _leaves(snap: list[dict]) -> list[torch.Tensor]:
    """A row snapshot's tensors in the reference's pytree leaf order:
    layer by layer, each layer's names sorted."""
    return [lay[name] for lay in snap for name in sorted(lay)]


def _shaped(leaves: list, ref: list[dict]) -> list[dict]:
    """`leaves` (in _leaves order) back into the layout of `ref`."""
    it = iter(leaves)
    return [{name: next(it) for name in sorted(lay)} for lay in ref]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _ms(t0: float) -> float:
    return round((now() - t0) * 1e3, 3)


class KVShareReplica:
    """Per-replica kvshare agent (see the module docstring)."""

    def __init__(self, engine):
        self.engine = engine
        self.fetch_timeout = float(knobs.get("CAKE_KVSHARE_FETCH_TIMEOUT_S"))
        self.inventory_cap = int(knobs.get("CAKE_KVSHARE_INVENTORY"))
        # mailbox: (kind, payload, box) appended by API threads, drained
        # on the scheduler thread; deque append/popleft are atomic
        self._jobs: deque = deque()
        self._lock = threading.Lock()
        self._parked: dict = {}     # guarded-by: self._lock
        self._inbound: dict = {}    # guarded-by: self._lock
        # inventory mirror: hex chain keys this replica can export,
        # newest-first. Rebuilt on the scheduler thread whenever the
        # prefix cache's membership version moves, swapped atomically so
        # API threads read it lock-free
        self._inventory: tuple = ()
        self._pc_version = -1
        self._drain_swept = False
        # lifetime fetch accounting behind the hit-ratio gauge
        self._fetches = 0
        self._fetch_hits = 0

    # -- scheduler-thread side ---------------------------------------------

    def run_pending(self) -> None:
        """Drain the mailbox + housekeeping. Called at the top of every
        engine scheduler iteration (and on wake): everything in here runs
        on the scheduler thread, where the prefix cache and paged pool
        are safe to touch."""
        eng = self.engine
        try:
            self._sweep_drain()
            self._sweep_parked_ttl()
        except Exception:
            log.exception("kvshare housekeeping failed")
        while True:
            try:
                kind, payload, box = self._jobs.popleft()
            except IndexError:
                break
            try:
                box["result"] = self._execute(kind, payload)
            except BaseException as e:   # the submitter re-raises it
                box["error"] = e
            box["event"].set()
        pc = eng.prefix_cache
        if pc is not None and pc.version != self._pc_version:
            self._pc_version = pc.version
            cap = max(self.inventory_cap, 0)
            keys = list(pc._blocks)[-cap:] if cap else []
            self._inventory = tuple(k.hex() for k in reversed(keys))

    def submit_job(self, kind: str, payload, timeout: float):
        """API-thread entry: enqueue a scheduler job and block on its
        completion (the engine's wake event lands the scheduler loop in
        run_pending even when idle). Raises TimeoutError past the
        deadline and re-raises whatever the job raised."""
        box = {"event": threading.Event()}
        self._jobs.append((kind, payload, box))
        self.engine._wake.set()
        if not box["event"].wait(timeout):
            raise TimeoutError(f"kvshare {kind} job timed out after "
                               f"{timeout:.1f}s")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _execute(self, kind: str, payload):
        if kind == "gather_prefix":
            return self._gather_prefix(payload)
        if kind == "install_prefix":
            return self._install_prefix(*payload)
        if kind == "park_stream":
            return self._find_parked(payload)
        if kind == "adopt":
            return self._adopt(payload)
        raise ValueError(f"unknown kvshare job kind {kind!r}")

    # -- API-thread entries: the scheduler gathers or installs, the caller
    # encodes or decodes ---------------------------------------------------

    def export_prefix(self, chain_hex: str, timeout: float,
                      timing: dict | None = None) -> bytes | None:
        """The prefix GET route's blob: the chain's tensors gathered by a
        scheduler job, encoded here; None = not exportable here.
        `timing`, when given, receives this export's export_ms (the
        gather) and encode_ms."""
        got = self.submit_job("gather_prefix", chain_hex, timeout)
        if got is None:
            return None
        header, arrays, export_ms = got
        t0 = now()
        data = encode_blob(header, arrays)
        if timing is not None:
            timing.update(export_ms=export_ms, encode_ms=_ms(t0))
        return data

    def import_prefix(self, data: bytes, timeout: float,
                      timing: dict | None = None) -> dict:
        """Decode a prefix blob here and install it by a scheduler job
        (the POST route and fetch-before-recompute). Raises
        KVBlobMismatch when the blob cannot apply here. `timing`, when
        given, receives this import's decode_ms and install_ms."""
        t0 = now()
        header, arrays = decode_blob(data)
        decode_ms = _ms(t0)
        res = self.submit_job("install_prefix", (header, arrays), timeout)
        install_ms = res.pop("install_ms")
        if timing is not None:
            timing.update(decode_ms=decode_ms, install_ms=install_ms)
        return res

    # -- drain parking -------------------------------------------------------

    def _sweep_drain(self) -> None:
        """On drain, park every live STREAMED decode once: the router
        resumes each one on a peer from the shipped blob instead of the
        continuation re-prefill. Mid-prefill slots and requests nobody
        streams finish normally under the plain drain; a slot whose
        first token is sampled but unfetched is skipped too — parking it
        would lose that token."""
        eng = self.engine
        if not eng._draining.is_set():
            self._drain_swept = False
            return
        if self._drain_swept or eng.paged is None:
            return
        self._drain_swept = True
        for i, req in self._migratable():
            if req.streaming:
                self._park_slot(i, req)

    def _migratable(self) -> list:
        """(slot, request) of every decoding slot whose state can move:
        past its prefill, its first token fetched, not cancelled or
        done."""
        eng = self.engine
        prefilling = {p.slot for p in eng._prefills}
        out = []
        for i in eng.pool.busy():
            req = eng._reqs[i]
            if req is None or i in prefilling or not req.tokens \
                    or req._first_pending or req.cancelled.is_set() \
                    or req.done.is_set():
                continue
            out.append((i, req))
        return out

    def _sweep_parked_ttl(self) -> None:
        cutoff = now() - _PARKED_TTL_S
        with self._lock:
            stale = [rid for rid, p in self._parked.items()
                     if p["t"] < cutoff]
            for rid in stale:
                del self._parked[rid]
        for rid in stale:
            log.warning("kvshare: dropped unclaimed parked stream %s", rid)

    def _park_slot(self, slot: int, req: ServeRequest) -> dict:
        """Swap a live decode out of its slot and park the blob for the
        resume plane — the migration flavour of the engine's
        _preempt_slot: the same committed frontier, the speculative tail
        trimmed first, and swap_out, but the request FAILS typed
        (StreamMigrated) instead of joining the resume queue, because its
        next owner is another replica."""
        eng = self.engine
        wp = eng._frontier(req)
        eng.spec_trimmed += eng.paged.trim_to(slot, wp)
        c = eng.carries
        blob = eng.paged.swap_out(slot, tuple(getattr(c, n)
                                              for n in _CARRIES))
        parked = {"blob": blob, "gen_ids": list(req.tokens),
                  "prompt_ids": list(req.prompt_ids),
                  "budget": req.budget, "wp": wp, "t": now()}
        with self._lock:
            self._parked[req.id] = parked
        TIMELINES.event(req.id, "preempt", mode="swap", tokens=wp)
        eng.pool.free(slot)
        eng._reqs[slot] = None
        req.slot = None
        c.active[slot] = False
        c.toks[slot] = 0
        c.pos[slot] = 0
        SERVE_SLOTS_BUSY.set(eng.pool.busy_count)
        log.info("kvshare: parked stream %s (%d prompt + %d generated "
                 "tokens) for migration", req.id, len(req.prompt_ids),
                 len(req.tokens))
        eng._fail(req, StreamMigrated(req.id))
        return parked

    # -- prefix export/import (scheduler thread) -----------------------------

    def _gather_prefix(self, chain_hex: str
                       ) -> tuple[dict, dict, float] | None:
        """(header, host tensors, the gather's ms) of the blob of the
        longest CONTIGUOUS cached chain head ending at (or before) the
        requested chain key; None = not exportable here."""
        eng = self.engine
        pc, paged = eng.prefix_cache, eng.paged
        if pc is None or paged is None:
            return None
        try:
            want = bytes.fromhex(chain_hex)
        except ValueError:
            return None
        tip = pc._blocks.get(want)
        if tip is None:
            return None
        t0 = now()
        keys = _chain_of(tip.tokens, pc.block)
        entries = []
        for k in keys:                  # stop at the first gap: the blob
            e = pc._blocks.get(k)       # must stay a contiguous head
            if e is None:
                break
            entries.append(e)
        if not entries:
            return None
        all_pids = [pid for e in entries for pid in e.pids]
        arrays = {"tokens": torch.from_numpy(
            np.asarray(entries[-1].tokens, np.int32))}
        pid_idx = torch.tensor(all_pids, dtype=torch.long,
                               device=paged.device)
        for li, pl in enumerate(paged.pool):
            if not pl:
                continue
            for name in ("k", "v", "pos"):
                # the export IS the planned copy to the host, on the blob
                # route, never per decode iteration
                arrays[f"layers/{li}/{name}"] = pl[name][pid_idx].cpu()
        has_snap = entries[0].snap is not None
        if has_snap:
            for u, e in enumerate(entries):
                for j, leaf in enumerate(_leaves(e.snap)):
                    arrays[f"snap/{u}/{j}"] = leaf.cpu()
        header = {
            "kind": "prefix",
            "chain": keys[len(entries) - 1].hex(),
            "units": len(entries),
            "unit_tokens": pc.block,
            "block_tokens": paged.bt,
            "bpu": pc.bpu,
            "pool": pool_signature(paged),
            "has_snap": has_snap,
        }
        return header, arrays, _ms(t0)

    def _install_prefix(self, header: dict, arrays: dict) -> dict:
        """Install a decoded prefix blob into the local PagedPrefixCache:
        fresh physical blocks, cache-pin ownership, per-unit boundary
        snapshots — after this, match()/splice() treat the chain exactly
        like a local capture. Installs the longest contiguous head that
        fits (capacity/pool pressure can shorten it — still valid).
        Raises KVBlobMismatch when the blob cannot apply here at all."""
        eng = self.engine
        pc, paged = eng.prefix_cache, eng.paged
        if pc is None or paged is None:
            raise KVBlobMismatch("replica has no paged prefix cache")
        t0 = now()
        if header.get("kind") != "prefix":
            raise KVBlobMismatch("not a prefix blob")
        if header.get("pool") != pool_signature(paged):
            raise KVBlobMismatch("pool shape signature mismatch")
        if header.get("unit_tokens") != pc.block \
                or header.get("block_tokens") != paged.bt \
                or header.get("bpu") != pc.bpu:
            raise KVBlobMismatch("prefix geometry mismatch")
        units = int(header.get("units") or 0)
        tokens = arrays.get("tokens")
        if units < 1 or tokens is None or tokens.dim() != 1 \
                or len(tokens) != units * pc.block:
            raise KVBlobMismatch("prefix blob token record inconsistent")
        ids = tokens.to(torch.int32).numpy()
        keys = _chain_of(ids, pc.block)     # never trust the sender's keys
        rows = {}
        for li, pl in enumerate(paged.pool):
            if not pl:
                continue
            for name in ("k", "v", "pos"):
                a = arrays.get(f"layers/{li}/{name}")
                if a is None or a.shape[0] != units * pc.bpu \
                        or a.shape[1:] != pl[name].shape[1:] \
                        or a.dtype != pl[name].dtype:
                    raise KVBlobMismatch(
                        f"prefix blob layer {li}/{name} rows missing, "
                        "short or shaped wrong")
                rows[(li, name)] = a
        snaps = self._decode_snaps(header, arrays, units)
        installed = 0
        for u in range(units):
            key = keys[u]
            if key in pc._blocks:           # dedupe, refresh recency
                pc._blocks.move_to_end(key)
                installed = u + 1
                continue
            snap = snaps[u] if snaps is not None else None
            snap_nbytes = _nbytes(_leaves(snap)) if snap is not None else 0
            nbytes = pc.bpu * paged.block_bytes + snap_nbytes
            if nbytes > pc.capacity:
                break
            while pc.bytes + nbytes > pc.capacity and pc._blocks:
                pc._evict_lru()
            if not paged.ensure_free(pc.bpu):
                break                       # partial contiguous head: valid
            pids = []
            for _ in range(pc.bpu):
                pid = paged._alloc_one()
                assert pid is not None      # guarded by ensure_free above
                pids.append(pid)
            dst = torch.tensor(pids, dtype=torch.long, device=paged.device)
            sl = slice(u * pc.bpu, (u + 1) * pc.bpu)
            for (li, name), arr in rows.items():
                paged.pool[li][name][dst] = arr[sl].to(paged.device)
            # cache-pin ownership: alloc() granted ref=1; convert it to a
            # pure pin (ref == mappings + cache_pins stays balanced)
            for pid in pids:
                paged.alloc.ref(pid, cache_pin=True)
                paged.alloc.deref(pid)
            pc._blocks[key] = _PagedEntry(
                tokens=ids[:(u + 1) * pc.block].copy(), pids=pids,
                snap=snap, nbytes=nbytes)
            pc.bytes += nbytes
            pc.version += 1
            pc.pinned += len(pids)
            installed = u + 1
        paged._publish()
        SERVE_PREFIX_BYTES.set(pc.bytes)
        if installed == 0:
            raise KVBlobMismatch("no room to install any prefix unit")
        install_ms = _ms(t0)
        log.info("kvshare: installed %d/%d prefix units (%d tokens)",
                 installed, units, installed * pc.block)
        return {"installed_units": installed,
                "tokens": installed * pc.block, "install_ms": install_ms}

    def _row_leaves(self, arrays: dict, prefix: str) -> list | None:
        """The leaves `prefix`0.. of a row snapshot, each checked against
        the LOCAL row layout (the blob carries leaves only; a locally
        derived reference is the honest compatibility gate). None when a
        leaf is missing, shaped or typed wrong, or one is extra."""
        eng = self.engine
        ref = _leaves(eng.model.row_snapshot(eng.paged.rows, 0))
        got = []
        for j, leaf in enumerate(ref):
            a = arrays.get(f"{prefix}{j}")
            if a is None or tuple(a.shape) != tuple(leaf.shape) \
                    or dtype_name(a.dtype) != dtype_name(leaf.dtype):
                return None
            got.append(a)
        if f"{prefix}{len(ref)}" in arrays:
            return None
        return got

    def _decode_snaps(self, header: dict, arrays: dict, units: int):
        """Per-unit boundary row snapshots of a prefix blob, on the
        device, in the local row layout."""
        eng = self.engine
        paged = eng.paged
        if not header.get("has_snap"):
            if paged.has_rows:
                raise KVBlobMismatch(
                    "prefix blob has no row snapshots but this pool "
                    "keeps per-slot rows")
            return None
        if not paged.has_rows:
            raise KVBlobMismatch(
                "prefix blob carries row snapshots but this pool is "
                "rowless")
        ref = eng.model.row_snapshot(paged.rows, 0)
        snaps = []
        for u in range(units):
            got = self._row_leaves(arrays, f"snap/{u}/")
            if got is None:
                raise KVBlobMismatch(
                    f"row snapshot {u} missing, extra or shaped wrong")
            snaps.append(_shaped([a.to(paged.device) for a in got], ref))
        return snaps

    # -- stream export/adopt (scheduler thread) ------------------------------

    def export_stream(self, rid: str, timeout: float) -> bytes | None:
        """API-thread entry for the stream GET route. An ALREADY-parked
        blob encodes directly (host memory + static pool shapes — no
        engine state; this keeps drain-parked blobs fetchable even while
        the scheduler is busy tearing down). A live stream goes through
        the mailbox so the park runs on the scheduler thread."""
        with self._lock:
            parked = self._parked.get(rid)
        if parked is None:
            parked = self.submit_job("park_stream", rid, timeout)
        if parked is None:
            return None
        data = self._encode_stream(rid, parked)
        with self._lock:
            parked["fetched"] = True
        return data

    def unclaimed(self) -> int:
        """Parked stream blobs no peer has fetched yet. A draining server
        keeps its routes up while any is left (within its drain budget),
        so that a SIGTERM's drain ships its streams rather than closing
        on them."""
        with self._lock:
            return sum(1 for p in self._parked.values()
                       if not p.get("fetched"))

    def _find_parked(self, rid: str) -> dict | None:
        """The parked record of a stream; a LIVE stream is parked on the
        spot (the resume plane's fetch IS the migration signal — covers
        planned rebalance and post-commit failover where the source
        still answers). None = unknown stream."""
        with self._lock:
            parked = self._parked.get(rid)
        return parked if parked is not None else self._park_live(rid)

    def _park_live(self, rid: str) -> dict | None:
        eng = self.engine
        if eng.paged is None:
            return None
        for i, req in self._migratable():
            if req.id == rid:
                return self._park_slot(i, req)
        return None

    def _encode_stream(self, rid: str, parked: dict) -> bytes:
        paged = self.engine.paged
        blob = parked["blob"]
        arrays = {
            "idx": torch.tensor(blob["idx"], dtype=torch.int32),
            "gen_ids": torch.tensor(parked["gen_ids"], dtype=torch.int32),
            "prompt_ids": torch.tensor(parked["prompt_ids"],
                                       dtype=torch.int32),
        }
        for li, saved in enumerate(blob["layers"]):
            if not saved:
                continue
            for name in ("k", "v", "pos"):
                arrays[f"layers/{li}/{name}"] = saved[name]
        has_rows = blob["rows"] is not None
        if has_rows:
            for j, leaf in enumerate(_leaves(blob["rows"])):
                arrays[f"rows/{j}"] = leaf
        for ci, c in enumerate(blob["carries"]):
            arrays[f"carries/{ci}"] = c
        header = {
            "kind": "stream", "rid": rid, "budget": parked["budget"],
            "wp": parked["wp"], "block_tokens": paged.bt,
            "pool": pool_signature(paged), "has_rows": has_rows,
        }
        return encode_blob(header, arrays)

    def store_inbound(self, rid: str, data: bytes) -> dict:
        """Decode + stage a stream blob shipped by the router (any
        thread: decode touches no engine state). The adopt job installs
        it when the resumed request arrives."""
        header, arrays = decode_blob(data)
        if header.get("kind") != "stream":
            raise KVBlobMismatch("not a stream blob")
        gen = arrays.get("gen_ids")
        if gen is None or gen.dim() != 1:
            raise KVBlobMismatch("stream blob has no token record")
        with self._lock:
            self._inbound[rid] = (header, arrays, now())
        return {"rid": rid, "gen_tokens": int(gen.shape[0])}

    def _adopt(self, payload: dict):
        """Adopt a staged stream blob: rebuild the swap-blob dict against
        the local pool and enter the engine through the swap resume
        (_resume_preempted swap_in's it, and the decode carries continue
        the sampled sequence bit-exactly). Returns the live ServeRequest,
        or None = cannot adopt (the caller falls back to the plain
        continuation re-prefill): nothing staged, a foreign pool, or a
        blob whose carries are not the port's."""
        eng = self.engine
        paged = eng.paged
        rid = payload["rid"]
        with self._lock:
            staged = self._inbound.pop(rid, None)
        if staged is None or paged is None:
            return None
        header, arrays, _ = staged
        if header.get("pool") != pool_signature(paged) \
                or header.get("block_tokens") != paged.bt:
            log.warning("kvshare: staged blob for %s does not match this "
                        "pool; falling back to continuation", rid)
            return None
        idx_t = arrays.get("idx")
        if idx_t is None or idx_t.dim() != 1:
            return None
        idx = [int(i) for i in idx_t]
        if not idx or min(idx) < 0 or max(idx) >= paged.max_blocks:
            return None
        layers = []
        for li, pl in enumerate(paged.pool):
            if not pl:
                layers.append({})
                continue
            d = {}
            for name in ("k", "v", "pos"):
                a = arrays.get(f"layers/{li}/{name}")
                if a is None or a.shape[0] != len(idx) \
                        or a.shape[1:] != pl[name].shape[1:] \
                        or a.dtype != pl[name].dtype:
                    return None
                d[name] = a
            layers.append(d)
        rows = None
        if header.get("has_rows"):
            if not paged.has_rows:
                return None
            got = self._row_leaves(arrays, "rows/")
            if got is None:
                return None
            rows = _shaped(got, eng.model.row_snapshot(paged.rows, 0))
        elif paged.has_rows:
            return None
        carries = []
        for ci, name in enumerate(_CARRIES):
            a = arrays.get(f"carries/{ci}")
            local = getattr(eng.carries, name)[0]
            if a is None or tuple(a.shape) != tuple(local.shape) \
                    or a.dtype != local.dtype:
                log.warning("kvshare: staged blob for %s carries no "
                            "port decode state; falling back to "
                            "continuation", rid)
                return None
            carries.append(a)
        if f"carries/{len(_CARRIES)}" in arrays:
            return None
        gen_ids = [int(t) for t in arrays["gen_ids"]]
        prompt = arrays.get("prompt_ids")
        prompt_ids = [int(t) for t in prompt] if prompt is not None else []
        if not gen_ids or not prompt_ids:
            return None
        blob = {"idx": idx, "layers": layers, "rows": rows,
                "carries": carries}
        req = ServeRequest(prompt_ids, max(len(gen_ids) + 1, 2),
                           payload.get("sampling"), request_id=rid,
                           qos=payload.get("qos", "interactive"),
                           tenant=payload.get("tenant"))
        req._engine = eng
        req.tokens = list(gen_ids)
        req.replayed = len(gen_ids)
        req.budget = max(int(header.get("budget") or 0), 0)
        req.t_first = now()
        req.stats["ttft_s"] = 0.0
        req.stats["kv_migrated"] = True
        wp = int(header.get("wp") or 0)
        eng._preempted.append(PreemptedSlot(req, "swap", wp, blob))
        eng._wake.set()
        log.info("kvshare: adopted migrated stream %s (%d generated "
                 "tokens, budget %d)", rid, len(gen_ids), req.budget)
        return req

    # -- fetch-before-recompute (API thread) ----------------------------------

    def fetch_before_prefill(self, rid: str, prompt_ids: list,
                             peers_header: str) -> None:
        """Consult the router-injected peer directory and try ONE fetch
        of the longest chain a warm peer advertises beyond what the local
        cache already holds. Best-effort by construction: every failure
        (no match, HTTP error, timeout, geometry mismatch) returns with
        the cache unchanged and the admission recomputes honestly. A hit's
        kv_fetch timeline event carries its phases in ms: the peer's
        export and encode, the wire (the GET less those two), the decode
        and the install here."""
        eng = self.engine
        pc = eng.prefix_cache
        if pc is None or eng.paged is None or not peers_header:
            return
        peers = parse_directory(peers_header)
        if not peers:
            return
        keys = pc.chain_keys(prompt_ids)
        if not keys:
            return
        hexkeys = [k.hex() for k in keys]
        local = 0
        for i in range(len(keys) - 1, -1, -1):
            if keys[i] in pc._blocks:   # racy read, advisory only: a
                local = i + 1           # stale answer costs one redundant
                break                   # fetch or one missed one
        best = None
        for i in range(len(hexkeys) - 1, local - 1, -1):
            for url, advertised in peers:
                if hexkeys[i] in advertised:
                    best = (i + 1, url, hexkeys[i])
                    break
            if best is not None:
                break
        if best is None:
            if local < len(keys):
                self._account_fetch("miss", rid, None)
            return
        _, url, chain_hex = best
        t0 = now()
        deadline = max(self.fetch_timeout, 0.1)
        try:
            status, timing, data = self._get_blob(
                url.rstrip("/") + "/api/v1/kv/prefix/" + chain_hex,
                t0 + deadline)
        except TimeoutError:
            self._account_fetch("timeout", rid, url)
            return
        except Exception:
            self._account_fetch("error", rid, url)
            return
        if status != 200:
            self._account_fetch("miss", rid, url)
            return
        get_ms = _ms(t0)
        remaining = max(deadline - (now() - t0), 0.2)
        split = {k: timing[k] for k in ("export_ms", "encode_ms")
                 if k in timing}
        try:
            res = self.import_prefix(data, remaining, split)
        except KVBlobMismatch:
            self._account_fetch("mismatch", rid, url)
            return
        except Exception:
            self._account_fetch("error", rid, url)
            return
        # the GET's time less the peer's own export and encode
        wire = get_ms - timing.get("export_ms", 0.0) \
            - timing.get("encode_ms", 0.0)
        split.update(get_ms=get_ms, wire_ms=round(wire, 3),
                     total_ms=_ms(t0), bytes=len(data))
        self._account_fetch("hit", rid, url, tokens=res["tokens"], **split)
        FLEET_KV_FETCH_BYTES.inc(len(data))

    @staticmethod
    def _get_blob(url: str, deadline: float) -> tuple[int, dict, bytes]:
        """(status, the peer's export timing, body) of one GET, read in
        pieces; TimeoutError once `deadline` (on the `now` clock) has
        passed."""
        u = urlsplit(url)
        left = deadline - now()
        if left <= 0:
            raise TimeoutError("kvshare fetch deadline passed")
        conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                          timeout=left)
        try:
            conn.request("GET", u.path)
            resp = conn.getresponse()
            timing = {}
            raw = resp.getheader("X-Cake-KV-Timing")
            if raw:
                for part in raw.split(","):
                    k, _, v = part.partition("=")
                    try:
                        timing[k.strip()] = float(v)
                    except ValueError:
                        pass
            parts = []
            while True:
                # each read waits at most the socket's timeout (the time
                # left when the fetch began); the deadline is checked
                # between pieces
                if deadline - now() <= 0:
                    raise TimeoutError("kvshare fetch deadline passed")
                piece = resp.read(_READ_CHUNK)
                if not piece:
                    break
                parts.append(piece)
            return resp.status, timing, b"".join(parts)
        except socket.timeout as e:
            raise TimeoutError(str(e)) from e
        finally:
            conn.close()

    def _account_fetch(self, outcome: str, rid: str, peer: str | None,
                       **attrs) -> None:
        FLEET_KV_FETCHES.inc(outcome=outcome)
        self._fetches += 1
        if outcome == "hit":
            self._fetch_hits += 1
        FLEET_KV_HIT_RATIO.set(self._fetch_hits / self._fetches)
        ev = {"outcome": outcome}
        if peer:
            ev["peer"] = peer
        ev.update(attrs)
        TIMELINES.event(rid, "kv_fetch", **ev)

    # -- views ---------------------------------------------------------------

    def health_view(self) -> dict:
        """The kvshare block /health carries — the registry mirrors
        `chains` into the peer directory on every probe scrape."""
        with self._lock:
            parked = len(self._parked)
            inbound = len(self._inbound)
        return {"chains": list(self._inventory), "parked": parked,
                "inbound": inbound}
