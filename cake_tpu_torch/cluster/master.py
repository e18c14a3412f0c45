"""Master node: cluster bring-up and distributed text generation
(counterpart of cake_tpu/cluster/master.py).

Bring-up: workers (from discovery or a topology file) -> per-layer bytes
from the safetensors headers -> TFLOPS-proportional assignment ->
connect, authenticate, assign -> stream each worker's layer subset (CRC32,
content-keyed cache) -> wait for worker_ready. The master keeps the
unassigned layers, the embeddings and the head.

Generation: the stage chain [local ranges | remote workers] runs per
token; a local range is a models/common/text_model.py LocalStage on the
master's device, a remote one a TCP round trip (client.RemoteStage) whose
hidden state crosses as host bytes; embeddings, head and sampling stay on
the master's device. A prompt that spans two chunks or more is prefilled
pipelined: chunk c + 1 runs on stage s while chunk c is on stage s + 1.
Sampling is the port's keyed sampling (request_key(seed, 0), draw i for
token i, as TextModel.generate), so greedy output equals the
single-process model's.

Recovery keeps the reference's contract: a failed hop quarantines its
worker, reconnects with capped, jittered exponential backoff
(re-authenticate, re-assign; the weight push is skipped while the worker
acks its cache, re-streamed if it lost it), and rebuilds every stage's
cache by one replay prefill of prompt + tokens so far, whose last logits
are the ones the failed op owed. Past CAKE_RECOVERY_RETRIES (3) cycles
the request fails fast with ClusterDegradedError, /health answers 503,
and a restore loop probes the worker every CAKE_RESTORE_INTERVAL_S (5)
until it comes back. CAKE_RECOVERY_BACKOFF_S (0.5) is the backoff's base.

One divergence: the KV caches are sized once per request, at
TextModel.generate's bucket of prompt + max_new_tokens (the master's and,
through the kv hint, every worker's), where the reference starts smaller
and grows them by bucket during decode.
"""
from __future__ import annotations

import functools
import json
import logging
import os
import queue
import random
import threading
import time
from dataclasses import dataclass, field

import torch

from ..device import parse_dtype, resolve_device
from ..models.common.config import ModelConfig
from ..models.common.layers import embed_tokens, lm_head_logits
from ..models.common.text_model import (LocalStage, bucket_for,
                                        check_prefill_bounds, eager_generate,
                                        select_flash_mode)
from ..obs import (CLUSTER_DEGRADED, CLUSTER_RECONNECTS, CLUSTER_REPLAYS,
                   RECORDER, now, observe_generation)
from ..ops.sampling import SamplingConfig
from . import proto, transfer
from .auth import cluster_hash
from .client import RemoteStage, StageFailure, env_float
from .strategy import DefaultStrategy, WorkerCapacity, estimate_layer_bytes
from .topology import Topology

log = logging.getLogger("cake_tpu_torch.cluster.master")

# the pipelined prefill's chunk width (the reference's PREFILL_CHUNK)
PREFILL_CHUNK = 512
# cap on the recovery reconnect backoff: failures past the first few
# retries are probed by the background restore loop instead
RECOVERY_BACKOFF_CAP_S = 10.0


class ClusterDegradedError(RuntimeError):
    """A worker is down and the recovery retry budget is spent: the
    request fails fast, /health answers 503, and the restore loop keeps
    probing the dead worker so that a later request can succeed."""


@dataclass
class Stage:
    kind: str                  # "local" | "remote"
    start: int
    end: int
    runner: object             # LocalStage or RemoteStage
    cache: object = None       # local KV cache (a worker keeps its own)


class DistributedTextModel:
    """A text model over a stage chain: one local stage is the plain
    TextModel's arithmetic; remote stages hop hidden states over the
    wire. `params` holds the master's embeddings, final norm and head."""

    def __init__(self, cfg: ModelConfig, master_params: dict,
                 stages: list[Stage], tokenizer=None,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 max_cache_len: int = 2048,
                 prefill_chunk: int | None = None,
                 recovery_retries: int | None = None,
                 recovery_backoff_s: float | None = None,
                 restore_interval_s: float | None = None):
        self.cfg = cfg
        self.stages = stages
        self.params = master_params
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = resolve_device(device)
        self.max_cache_len = min(max_cache_len, cfg.max_seq_len)
        self.prefill_chunk = prefill_chunk or PREFILL_CHUNK
        self.recovery_retries = int(
            recovery_retries if recovery_retries is not None
            else env_float("CAKE_RECOVERY_RETRIES", 3))
        self.recovery_backoff_s = (
            recovery_backoff_s if recovery_backoff_s is not None
            else env_float("CAKE_RECOVERY_BACKOFF_S", 0.5))
        self.restore_interval_s = (
            restore_interval_s if restore_interval_s is not None
            else env_float("CAKE_RESTORE_INTERVAL_S", 5.0))
        # serializes channel revival: _recover and the restore loop never
        # reestablish() one worker at once. It never guards the flags
        # below (a revival takes minutes; a flag read must not wait)
        self._revive_lock = threading.Lock()
        # guards `degraded` and the restore thread's handle, held only for
        # flag reads and writes
        self._degraded_lock = threading.Lock()
        self.degraded: dict | None = None          # guarded-by: _degraded_lock
        self._restore_thread: threading.Thread | None = None
        self._recoveries = 0
        self._replays = 0
        self._gen_prompt: list[int] = []
        self._gen_out: list[int] = []
        self._last_prefill: dict = {}
        self._kv_len = self.max_cache_len
        # host copies around the remote hops (device -> host before a hop,
        # host -> device after it), seconds per generation
        self._copy_s = 0.0

    # -- lifecycle -----------------------------------------------------------

    def reset(self, kv_len: int | None = None):
        """Fresh caches everywhere at kv_len slots: local stages allocate
        theirs, remote ones drop theirs (goodbye) and size the next by the
        kv hint."""
        self._kv_len = min(kv_len or self.max_cache_len, self.max_cache_len)
        for s in self.stages:
            if s.kind == "local":
                s.cache = s.runner.new_cache(self._kv_len, self.dtype)
            else:
                s.runner.goodbye()

    # -- forward -------------------------------------------------------------

    def _stage_forward(self, s: Stage, x: torch.Tensor, pos0: int,
                       valid_len: int | None) -> torch.Tensor:
        """One stage hop, under the `layers` span: the one definition of
        local / remote dispatch (dtype, flash mode, kv hint) that the
        sequential chain and the pipelined prefill's threads share."""
        with RECORDER.span("layers", cat="phase", kind=s.kind,
                           start=s.start, end=s.end,
                           worker=getattr(s.runner, "name", "")):
            if s.kind == "local":
                # a local prefill stage flashes like TextModel.prefill
                flash_mode = "off"
                if valid_len is not None:
                    flash_mode = select_flash_mode(pos0, x.shape[1],
                                                   self._kv_len)
                x = self._to_device(x)
                x, s.cache = s.runner.forward_hidden(
                    x, s.cache, pos0, valid_len, flash_mode=flash_mode)
                return x
            # a remote hop: the hidden state becomes host bytes to cross
            # the wire (the pipeline's own transfer point)
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)   # time the copy alone
            t = now()
            host = x.to("cpu")
            self._copy_s += now() - t
            y, _ = s.runner.forward_hidden(host, None, pos0, valid_len,
                                           kv_hint=self._kv_len)
            return y

    def _run_stages(self, x, pos0: int, valid_len: int | None):
        for s in self.stages:
            x = self._stage_forward(s, x, pos0, valid_len)
        return x

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """x on the master's device in its dtype; a copy from the host (a
        remote hop's reply) counts in the host copy seconds."""
        if x.device != self.device:
            t = now()
            x = x.to(self.device)
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
            self._copy_s += now() - t
        return x.to(self.dtype)

    def _head(self, x_last: torch.Tensor) -> torch.Tensor:
        return lm_head_logits(self.cfg, self.params,
                              self._to_device(x_last))[:, 0]

    def _embed(self, ids: list[int], width: int) -> torch.Tensor:
        padded = torch.zeros((1, width), dtype=torch.long)
        padded[0, :len(ids)] = torch.as_tensor(ids, dtype=torch.long)
        return embed_tokens(self.cfg, self.params, padded.to(self.device))

    @torch.no_grad()
    def prefill_logits(self, token_ids: list[int], pos0: int = 0):
        """Logits [1, V] at the last of token_ids, prefilled from pos0:
        pipelined when the chain has a remote hop and the prompt spans
        two chunks or more, else one bucket-padded pass."""
        n = len(token_ids)
        bkt = check_prefill_bounds(n, pos0, self._kv_len, self.max_cache_len)
        cw = self.prefill_chunk
        if (pos0 == 0 and n > cw
                and (-(-n // cw)) * cw <= self._kv_len
                and any(s.kind == "remote" for s in self.stages)):
            return self._prefill_pipelined(token_ids)
        self._last_prefill = {"pipelined": False, "chunks": 1, "width": bkt}
        x = self._run_stages(self._embed(token_ids, bkt), pos0, n)
        return self._head(x[:, n - 1:n])

    def _prefill_pipelined(self, token_ids: list[int]):
        """The prompt through the chain in prefill_chunk-token slices, one
        thread per stage plus a feeder, so the blocking round trips of
        different stages overlap. Unbounded queues: a failed stage cannot
        deadlock its upstream."""
        cw = self.prefill_chunk
        n = len(token_ids)
        n_chunks = -(-n // cw)
        self._last_prefill = {"pipelined": True, "chunks": n_chunks,
                              "width": cw}
        qs = [queue.Queue() for _ in range(len(self.stages) + 1)]
        errs: list[Exception] = []

        def feed():
            try:
                with torch.no_grad():
                    for ci in range(n_chunks):
                        lo = ci * cw
                        ids = token_ids[lo:lo + cw]
                        qs[0].put((self._embed(ids, cw), lo, len(ids)))
            except Exception as e:     # surfaced below
                errs.append(e)
            finally:
                qs[0].put(None)

        def run_stage(i: int, s: Stage):
            try:
                with torch.no_grad():
                    while True:
                        item = qs[i].get()
                        if item is None:
                            break
                        x, p0, vl = item
                        qs[i + 1].put((self._stage_forward(s, x, p0, vl),
                                       p0, vl))
            except Exception as e:     # surfaced below
                errs.append(e)
            finally:
                qs[i + 1].put(None)

        threads = [threading.Thread(target=feed, daemon=True)] + [
            threading.Thread(target=run_stage, args=(i, s), daemon=True)
            for i, s in enumerate(self.stages)]
        for t in threads:
            t.start()
        last = None
        while True:
            item = qs[-1].get()
            if item is None:
                break
            last = item
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        if last is None:
            raise RuntimeError("pipelined prefill produced no output")
        x, _, vl = last
        return self._head(x[:, vl - 1:vl])

    @torch.no_grad()
    def decode_logits(self, token_id: int, pos: int):
        """Logits [1, V] of one decode step at `pos`."""
        with RECORDER.span("embed", cat="phase"):
            x = embed_tokens(self.cfg, self.params,
                             torch.tensor([[int(token_id)]],
                                          device=self.device))
        x = self._run_stages(x, pos, None)
        with RECORDER.span("lm_head", cat="phase"):
            return self._head(x[:, -1:])

    # -- generation ----------------------------------------------------------

    def generate(self, prompt_ids: list[int], max_new_tokens: int = 256,
                 sampling: SamplingConfig | None = None, seed: int = 0,
                 on_token=None, **_):
        """text_model.eager_generate over the stage chain, each prefill
        and decode step under the recovery contract (`_recovering`).
        Returns (token_ids, stats): eager_generate's stats plus the
        prefill's form, recoveries, replays, host copy seconds and each
        remote hop's RTT split (stage_rtts)."""
        d = self.degraded_info()
        if d is not None:
            raise ClusterDegradedError(
                f"cluster degraded: worker {d['worker']} down for "
                f"{now() - d['since']:.0f}s ({d['error']}); "
                "restore loop is probing")
        n = len(prompt_ids)
        self.reset(kv_len=bucket_for(n + max_new_tokens, self.max_cache_len))
        for s in self.stages:
            if s.kind == "remote":
                s.runner.rtts.clear()
        # recovery bookkeeping: what a rebuild-by-replay prefills
        self._gen_prompt = list(prompt_ids)
        self._gen_out = []
        self._recoveries = self._replays = 0
        self._copy_s = 0.0
        out, stats = eager_generate(
            self.cfg, self.device, prompt_ids, self._kv_len,
            self._recovering(self.prefill_logits),
            self._recovering(self.decode_logits), max_new_tokens, sampling,
            seed, on_token, out=self._gen_out)
        stats.update({
            "prefill": dict(self._last_prefill),
            "recoveries": self._recoveries, "replays": self._replays,
            "host_copy_s": self._copy_s,
            "stage_rtts": {
                f"{s.runner.name}[{s.start}:{s.end}]": s.runner.rtt_stats()
                for s in self.stages if s.kind == "remote"}})
        observe_generation(stats, len(out), "cluster")
        return out, stats

    def _recovering(self, op):
        """op (prefill_logits or decode_logits) under the recovery
        contract: a StageFailure is recovered (`_recover`), whose replay
        leaves every cache holding the positions before op's and returns
        the logits op owed."""
        def run(*args):
            try:
                return op(*args)
            except StageFailure as e:
                return self._recover(e)
        return run

    # -- mid-stream fault recovery ---------------------------------------------

    def _remote_stage(self, worker: str) -> Stage | None:
        return next((s for s in self.stages
                     if s.kind == "remote" and s.runner.name == worker), None)

    def _recover(self, failure: StageFailure):
        """Quarantine the failed stage, reconnect with capped exponential
        backoff and jitter, then rebuild every stage's cache with one
        replay prefill. Returns the logits the failed op owed. A spent
        retry budget marks the cluster degraded and raises
        ClusterDegradedError."""
        worker = failure.worker
        last: Exception = failure
        log.warning("stage failure (%s): %s — starting recovery",
                    failure.kind, failure)
        for attempt in range(self.recovery_retries):
            if attempt:
                wait = min(self.recovery_backoff_s * (2 ** (attempt - 1)),
                           RECOVERY_BACKOFF_CAP_S)
                # jitter, so that masters do not stampede a worker that
                # just came back
                time.sleep(wait * random.uniform(0.75, 1.25))
            if isinstance(last, StageFailure):
                worker = last.worker
            try:
                stage = self._remote_stage(worker)
                if stage is not None:
                    with RECORDER.span("recover", cat="gen", worker=worker,
                                       attempt=attempt):
                        with self._revive_lock:
                            stage.runner.reestablish()
                    CLUSTER_RECONNECTS.inc(worker=worker)
                    log.info("worker %s reconnected (attempt %d)", worker,
                             attempt + 1)
                logits = self._replay()
                self._recoveries += 1
                return logits
            except (StageFailure, OSError, RuntimeError,
                    proto.ProtocolError) as e:
                log.warning("recovery attempt %d/%d for %s failed: %s",
                            attempt + 1, self.recovery_retries, worker, e)
                last = e
        self._mark_degraded(worker, last)
        raise ClusterDegradedError(
            f"worker {worker} unrecoverable after "
            f"{self.recovery_retries} attempts: {last}") from last

    def _replay(self):
        """Rebuild by replay: a worker's KV is per connection and died with
        it, so every stage's cache is reset (at the request's bucket) and
        prompt + tokens so far go through one prefill. Its last logits are
        the ones the failed op would have given: the greedy continuation
        equals the unfailed run's, and a recovery costs one prefill
        whenever the failure hit."""
        seq = self._gen_prompt + self._gen_out
        self.reset(kv_len=self._kv_len)
        with RECORDER.span("replay_prefill", cat="gen", tokens=len(seq)):
            logits = self.prefill_logits(seq)
        self._replays += 1
        CLUSTER_REPLAYS.inc()
        return logits

    def degraded_info(self) -> dict | None:
        """Locked read of the degraded flag (for /health and generate's
        fail-fast check); never waits on recovery work."""
        with self._degraded_lock:
            return self.degraded

    def _mark_degraded(self, worker: str, error: Exception):
        with self._degraded_lock:
            self.degraded = {"worker": worker, "since": now(),
                             "error": str(error)}
            if self._restore_thread is None \
                    or not self._restore_thread.is_alive():
                self._restore_thread = threading.Thread(
                    target=self._restore_loop, daemon=True,
                    name="cake-torch-restore")
                self._restore_thread.start()
        CLUSTER_DEGRADED.set(1.0)
        log.error("cluster degraded: worker %s unrecoverable (%s); "
                  "restore loop probing every %.1fs", worker, error,
                  self.restore_interval_s)

    def _restore_loop(self):
        """Probe the quarantined worker until it answers: the flag then
        clears, and the next request's reset and prefill rebuild all
        state."""
        while True:
            with self._degraded_lock:
                info = self.degraded
            if info is None:
                return
            time.sleep(self.restore_interval_s)
            with self._degraded_lock:
                info = self.degraded
            if info is None:
                return
            stage = self._remote_stage(info["worker"])
            if stage is None:
                with self._degraded_lock:
                    self.degraded = None
                CLUSTER_DEGRADED.set(0.0)
                return
            try:
                with self._revive_lock:
                    stage.runner.reestablish()
                CLUSTER_RECONNECTS.inc(worker=info["worker"])
                with self._degraded_lock:
                    self.degraded = None
                CLUSTER_DEGRADED.set(0.0)
                log.info("worker %s restored; cluster healthy again",
                         info["worker"])
                return
            except Exception as e:
                log.debug("restore probe for %s failed: %s",
                          info["worker"], e)

    def close(self):
        """Close every worker channel."""
        for s in self.stages:
            if s.kind == "remote":
                s.runner.close()


# ---------------------------------------------------------------------------
# Cluster bring-up
# ---------------------------------------------------------------------------


@dataclass
class MasterSetup:
    cfg: ModelConfig
    topology: Topology
    stages: list[Stage]
    master_params: dict
    clients: list[RemoteStage] = field(default_factory=list)
    # per worker: {"bytes", "push_s", "ready_s", "cached"}: the bytes of
    # its weight stream, the seconds to send them (the socket's pace) and
    # then to its worker_ready (receipt's end and load)
    streams: dict = field(default_factory=dict)


def plan_assignments(cfg: ModelConfig, storage, workers: list[dict],
                     quant_factor: float = 1.0) -> dict[str, tuple[int, int]]:
    """TFLOPS-proportional contiguous ranges from the workers' replies."""
    caps = [WorkerCapacity(name=w["name"],
                           memory_bytes=w["caps"]["memory_bytes"],
                           tflops=w["caps"]["tflops"],
                           backend=w["caps"].get("backend", "cuda"))
            for w in workers]
    layer_bytes = estimate_layer_bytes(storage, cfg.num_hidden_layers,
                                       quant_factor)
    plan = DefaultStrategy().assign_layers(
        caps, list(range(cfg.num_hidden_layers)), layer_bytes)
    return {name: (min(layers), max(layers) + 1)
            for name, layers in plan.items() if layers}


def master_setup(model_dir: str, cluster_key: str, cfg: ModelConfig,
                 workers: list[dict],
                 assignments: dict[str, tuple[int, int]] | None = None,
                 dtype_str: str = "bf16", max_cache_len: int = 2048,
                 push_weights: bool = True, fp8_native: bool = False,
                 device=None, warm: str = "full") -> MasterSetup:
    """Connect, authenticate, assign and push to each worker; build the
    stage chain, the master's local stages on `device` (default `cuda`).

    workers: discovery replies ({"name", "host", "port", "caps"}).
    fp8_native: stream the checkpoint's e4m3 tensors as they are and have
    every node keep them at 1 byte per parameter. warm: passed to the
    workers (a JAX worker compiles by it; a port worker has nothing to
    compile)."""
    from ..utils.loaders import load_model_params
    from ..utils.safetensors_io import TensorStorage

    dev = resolve_device(device)
    dtype = parse_dtype(dtype_str)
    storage = TensorStorage.from_model_dir(model_dir)
    if assignments is None:
        assignments = plan_assignments(cfg, storage, workers)
    with open(os.path.join(model_dir, "config.json")) as f:
        config_raw = json.load(f)
    mhash = transfer.model_hash(model_dir)
    ckey = transfer.cache_key(cluster_hash(cluster_key), mhash)

    # workers sorted by their range's start: the stage order
    ordered = sorted(assignments.items(), key=lambda kv: kv[1][0])
    clients: list[RemoteStage] = []
    streams: dict = {}
    worker_by_name = {w["name"]: w for w in workers}
    n = cfg.num_hidden_layers

    try:
        for name, (start, end) in ordered:
            w = worker_by_name[name]
            client = RemoteStage(w["host"], w["port"], cluster_key,
                                 name).connect()
            # registered at once: a failure below must not leak the open
            # sockets
            clients.append(client)
            names = transfer.subset_tensor_names(storage, start, end, n,
                                                 include_embed=False,
                                                 include_head=False)
            total, _ = transfer.synthesize_safetensors(storage, names)
            expected = {"model.safetensors": total}
            assignment = proto.layer_assignment(
                model_id=mhash, arch=cfg.arch, config=config_raw,
                start=start, end=end, dtype=dtype_str, cache_key=ckey,
                push_weights=push_weights, fp8_native=fp8_native)
            assignment["max_cache_len"] = max_cache_len
            assignment["expected_files"] = expected
            assignment["warm"] = warm
            # recovery memory: a reconnect replays this exact assignment,
            # and the repush thunk covers a worker that lost its cache
            client.assignment = assignment
            client.repush = functools.partial(_repush_weights, model_dir,
                                              names)
            resp = client.assign(assignment)
            if resp.get("t") == "worker_error":
                raise RuntimeError(f"worker {name}: {resp['error']}")
            t = now()
            sent = 0
            if push_weights and not transfer_cached(resp):
                start_off = (resp.get("resume") or {}).get(
                    "model.safetensors", 0)
                total, chunks = transfer.synthesize_safetensors(storage,
                                                                names)
                sent = total - start_off
                client.push_weights(
                    transfer.encode_chunks("model.safetensors", total,
                                           chunks, start_offset=start_off))
            t_push = now()
            client.wait_ready()
            streams[name] = {"bytes": sent, "push_s": t_push - t,
                             "ready_s": now() - t_push,
                             "cached": transfer_cached(resp)}
            log.info("worker %s ready with layers [%d,%d)", name, start, end)

        # the master keeps the unassigned layers
        assigned = set()
        for start, end in assignments.values():
            assigned |= set(range(start, end))
        master_layers = [i for i in range(n) if i not in assigned]

        by_name = dict(zip((nm for nm, _ in ordered), clients))
        ranges = [("remote", start, end, by_name[name])
                  for name, (start, end) in ordered]
        ranges += [("local", lo, hi, None)
                   for lo, hi in _contiguous(master_layers)]
        ranges.sort(key=lambda r: r[1])

        quant = None
        if fp8_native:
            from ..utils.quant import fp8_native_quant
            quant = fp8_native_quant()
        master_params = load_model_params(
            cfg, model_dir, dtype, dev, quant, layer_range=(0, 0),
            include_embed=True, include_head=True)
        stages: list[Stage] = []
        for kind, lo, hi, runner in ranges:
            if kind == "local":
                p = load_model_params(cfg, model_dir, dtype, dev, quant,
                                      layer_range=(lo, hi),
                                      include_embed=False,
                                      include_head=False)
                stage = LocalStage(cfg, p, lo, hi, dev)
                stages.append(Stage("local", lo, hi, stage,
                                    stage.new_cache(max_cache_len, dtype)))
            else:
                stages.append(Stage("remote", lo, hi, runner))

        topo = Topology.from_dict({
            name: {"host": f"{worker_by_name[name]['host']}:"
                           f"{worker_by_name[name]['port']}",
                   "layers": [f"model.layers.{s}-{e - 1}"],
                   "memory_bytes": worker_by_name[name]["caps"]["memory_bytes"],
                   "tflops": worker_by_name[name]["caps"]["tflops"],
                   "backend": worker_by_name[name]["caps"].get("backend", "")}
            for name, (s, e) in assignments.items()})
        storage.close()
        return MasterSetup(cfg=cfg, topology=topo, stages=stages,
                           master_params=master_params, clients=clients,
                           streams=streams)
    except BaseException:
        # a failure anywhere in setup must not leak the open worker
        # sockets or the checkpoint's maps
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
        try:
            storage.close()
        except Exception:
            pass
        raise


def transfer_cached(ack_msg: dict) -> bool:
    return bool(ack_msg.get("cached", False))


def _repush_weights(model_dir: str, names: list[str], client: RemoteStage,
                    ack: dict) -> None:
    """Re-stream a worker's layer subset on recovery, for a worker that
    lost its cache (setup's storage is long closed by then)."""
    from ..utils.safetensors_io import TensorStorage
    storage = TensorStorage.from_model_dir(model_dir)
    try:
        start_off = (ack.get("resume") or {}).get("model.safetensors", 0)
        total, chunks = transfer.synthesize_safetensors(storage, names)
        client.push_weights(transfer.encode_chunks(
            "model.safetensors", total, chunks, start_offset=start_off))
    finally:
        storage.close()


def _contiguous(layers: list[int]) -> list[tuple[int, int]]:
    if not layers:
        return []
    out = []
    lo = prev = layers[0]
    for i in layers[1:]:
        if i != prev + 1:
            out.append((lo, prev + 1))
            lo = i
        prev = i
    out.append((lo, prev + 1))
    return out
