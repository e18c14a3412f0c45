"""Worker node: advertises itself, authenticates the master, receives a
layer assignment (and optionally the streamed weights), then serves
forward requests through its contiguous range of layers (counterpart of
cake_tpu/cluster/worker.py: the same messages, so a JAX master drives a
port worker).

The range runs on `cuda` unless the worker is asked for the CPU, as a
models/common/text_model.py LocalStage, eagerly: a prefill chunk of 256
tokens or more reaches the flash kernel through the stage
(select_flash_mode, as the reference's worker chooses it), a decode step
the batched decode form. Captured stage graphs are later work.

Failure semantics are the reference's: a failed forward answers
worker_error and keeps the connection loop alive; a new
layer_assignment on a live socket re-runs setup; goodbye drops the
connection's cache; each connection gets a fresh KV cache, sized by
bucket and grown bucket by bucket.
"""
from __future__ import annotations

import asyncio
import logging
import os
import socket

import torch

from ..device import parse_dtype, resolve_device
from ..models.common.cache import grow_cache, init_cache, kv_capacity
from ..models.common.config import config_from_hf_dict
from ..models.common.text_model import LocalStage, bucket_for, select_flash_mode
from ..obs import PhaseTimer, WORKER_FWD_SECONDS, WORKER_HEARTBEAT, now
from . import faults, proto
from .auth import authenticate_as_worker
from .discovery import WorkerAdvertiser, detect_capabilities
from .transfer import ModelReceiver, has_valid_model_cache

log = logging.getLogger("cake_tpu_torch.cluster.worker")


def cache_dir() -> str:
    """The worker's weight cache root: CAKE_TPU_CACHE (the reference's
    knob, default ~/.cache/cake-tpu) + /worker."""
    root = os.environ.get("CAKE_TPU_CACHE") or "~/.cache/cake-tpu"
    return os.path.join(os.path.expanduser(root), "worker")


class WorkerState:
    """Model state shared by all connections after a layer assignment."""

    def __init__(self):
        self.cfg = None
        self.stage: LocalStage | None = None
        self.start = 0
        self.end = 0
        self.dtype = torch.bfloat16
        self.max_cache_len = 2048
        self.model_id = ""

    @property
    def loaded(self) -> bool:
        return self.stage is not None


class WorkerServer:
    def __init__(self, name: str, cluster_key: str, port: int = 10128,
                 model_dir: str | None = None, cache_root: str | None = None,
                 advertise: bool = True, discovery_port: int | None = None,
                 host: str = "0.0.0.0", device=None):
        self.name = name
        self.cluster_key = cluster_key
        self.port = port
        self.host = host
        self.device = resolve_device(device)
        self.model_dir = model_dir          # pre-provisioned weights
        self.cache_root = cache_root or cache_dir()
        self.advertise = advertise
        self.discovery_port = discovery_port
        self.caps = detect_capabilities()
        if self.device.type == "cpu":
            self.caps = dict(self.caps, backend="cpu", device="cpu")
        self.state = WorkerState()
        self._advertiser = None
        self._server: asyncio.AbstractServer | None = None
        self._writers: set = set()       # live connections, closed on stop()
        # ops, tokens, forward seconds, and the prefill chunks by flash
        # mode ("fresh" / "append" / "off"): a chunk of 256 tokens or more
        # in a flash mode launches the flash kernel once per full-attention
        # layer of the range
        self.stats = {"ops": 0, "tokens": 0, "fwd_s": 0.0,
                      "chunks": {"fresh": 0, "append": 0, "off": 0}}
        # monotonic liveness: bumped on every handled message, reported as
        # an age in worker_info and exported by the heartbeat loop
        self.started = now()
        self.last_heartbeat = now()
        # per-message phase accounting (read / deser / fwd / ser)
        self.phase = PhaseTimer()
        self._hb_task: asyncio.Task | None = None

    # -- lifecycle ---------------------------------------------------------

    async def start(self):
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.advertise:
            kw = {}
            if self.discovery_port is not None:
                kw["discovery_port"] = self.discovery_port
            self._advertiser = WorkerAdvertiser(
                self.name, self.cluster_key, self.port, caps=self.caps,
                **kw).start()
        self._hb_task = asyncio.get_running_loop().create_task(
            self._heartbeat_loop())
        # a `@name:crash_after_ops=N` fault plan hard-kills this worker
        # mid-stream (no goodbye)
        faults.register_crash("@" + self.name, self._crash)
        log.info("worker %s listening on %s:%d", self.name, self.host,
                 self.port)
        return self

    HEARTBEAT_INTERVAL = 15.0

    async def _heartbeat_loop(self):
        """Periodic liveness export: the gauge carries the age of the last
        activity, so a wedged worker shows as a growing age."""
        while True:
            await asyncio.sleep(self.HEARTBEAT_INTERVAL)
            WORKER_HEARTBEAT.set(now() - self.last_heartbeat,
                                 worker=self.name)
            log.debug("worker %s heartbeat: last activity %.1fs ago, "
                      "%d ops [%s]", self.name, now() - self.last_heartbeat,
                      self.stats["ops"], self.phase)

    async def serve_forever(self):
        async with self._server:
            await self._server.serve_forever()

    def _crash(self):
        """Injected hard death (faults.py crash_after_ops): stop accepting
        and abort every live connection with an RST."""
        log.warning("worker %s: injected crash", self.name)
        if self._hb_task:
            self._hb_task.cancel()
        if self._advertiser:
            self._advertiser.stop()
        if self._server:
            self._server.close()
        for w in list(self._writers):
            try:
                w.transport.abort()
            except Exception:
                w.close()

    async def stop(self):
        faults.unregister_crash("@" + self.name)
        if self._hb_task:
            self._hb_task.cancel()
        if self._advertiser:
            self._advertiser.stop()
        if self._server:
            self._server.close()
            # close live connections too: Server.close() only stops
            # accepting
            for w in list(self._writers):
                try:
                    w.close()
                except Exception:
                    pass
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2)
            except (TimeoutError, asyncio.TimeoutError):
                pass

    # -- connection handling ---------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        sock = writer.get_extra_info("socket")
        if sock is not None:
            # replies are latency-critical (one per token): Nagle and
            # delayed ACKs would stall alternate replies
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # registered before auth: a connection suspended mid-handshake when
        # stop() runs is closed too
        self._writers.add(writer)
        faults.tag(reader, "@" + self.name)
        faults.tag(writer, "@" + self.name)
        try:
            await authenticate_as_worker(reader, writer, self.cluster_key)
        except Exception as e:
            log.warning("auth failed from %s: %s", peer, e)
            self._writers.discard(writer)
            writer.close()
            return
        cache = None
        try:
            while True:
                msg, read_s, decode_s = await proto.read_frame_timed(reader)
                prev_heartbeat = self.last_heartbeat
                self.last_heartbeat = now()
                t = msg.get("t")
                if t == "hello":
                    await proto.write_frame(writer, proto.worker_info(
                        self.name,
                        list(range(self.state.start, self.state.end)),
                        self.caps["backend"], self.caps["device"],
                        self.caps["memory_bytes"], self.caps["tflops"],
                        heartbeat_age_s=now() - prev_heartbeat,
                        ops=self.stats["ops"]))
                elif t == "layer_assignment":
                    cache = None
                    await self._handle_assignment(msg, reader, writer)
                elif t == "forward":
                    if not self.state.loaded:
                        await proto.write_frame(writer, proto.worker_error(
                            "no layer assignment"))
                        continue
                    cache = await self._handle_forward(msg, writer, cache,
                                                       read_s, decode_s)
                elif t == "goodbye":
                    # drop (not just zero) the cache: a grown buffer must
                    # not leak its size into the next generation
                    cache = None
                    await proto.write_frame(writer, proto.ack())
                else:
                    await proto.write_frame(writer, proto.worker_error(
                        f"unexpected message {t!r}"))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception as e:
            log.exception("connection error from %s: %s", peer, e)
        finally:
            self._writers.discard(writer)
            writer.close()

    # -- setup -------------------------------------------------------------------

    async def _handle_assignment(self, msg, reader, writer):
        st = self.state
        st.model_id = msg["model_id"]
        st.start, st.end = int(msg["start"]), int(msg["end"])
        st.dtype = parse_dtype(msg["dtype"])
        st.max_cache_len = int(msg.get("max_cache_len", 2048))
        cfg = config_from_hf_dict(msg["config"], msg.get("arch") or None)
        st.cfg = cfg
        key = msg["cache_key"]
        expected = msg.get("expected_files", {})

        # the ack tells the master whether the weights are already here,
        # so it can skip the push (content-keyed cache)
        model_dir = self.model_dir
        if model_dir is None:
            # an empty `expected` cannot validate anything: uncached
            cached = bool(expected) and has_valid_model_cache(
                self.cache_root, key, expected)
            if not cached and msg["push_weights"]:
                a = proto.ack()
                a["cached"] = False
                recv = ModelReceiver(self.cache_root, key)
                a["resume"] = {f: recv.resume_offset(f) for f in expected}
                await proto.write_frame(writer, a)
                model_dir = await self._receive_weights(reader, msg, recv)
            elif cached:
                a = proto.ack()
                a["cached"] = True
                await proto.write_frame(writer, a)
                model_dir = os.path.join(self.cache_root, key)
            else:
                await proto.write_frame(writer, proto.worker_error(
                    "no weights: not cached and push disabled"))
                return
        else:
            a = proto.ack()
            a["cached"] = True
            await proto.write_frame(writer, a)

        try:
            t0 = now()
            st.stage = None
            # off the event loop: other connections keep being served
            st.stage = await asyncio.get_running_loop().run_in_executor(
                None, self._load_stage, model_dir, bool(msg.get("fp8_native")))
            # The reference's worker runs _warm here, to compile the XLA
            # programs serving will hit (warm="decode" / "full"). The port
            # runs its range eagerly and has no program to compile, so
            # `warm` is read and nothing is warmed; the kernels build at
            # their first use (kernels/build.py), shared by the processes
            # of one checkout.
            log.info("worker %s loaded layers [%d,%d) in %.1fs (warm %r: "
                     "nothing to compile)", self.name, st.start, st.end,
                     now() - t0, msg.get("warm", "decode"))
            await proto.write_frame(writer, proto.worker_ready())
        except Exception as e:
            log.exception("assignment failed")
            await proto.write_frame(writer, proto.worker_ready(
                ok=False, error=str(e)))
            st.stage = None

    def _load_stage(self, model_dir: str, fp8_native: bool) -> LocalStage:
        from ..utils.loaders import load_model_params
        st = self.state
        quant = None
        if fp8_native:
            from ..utils.quant import fp8_native_quant
            quant = fp8_native_quant()
        params = load_model_params(
            st.cfg, model_dir, st.dtype, self.device, quant,
            layer_range=(st.start, st.end), include_embed=False,
            include_head=False)
        return LocalStage(st.cfg, params, st.start, st.end, self.device)

    async def _receive_weights(self, reader, assign_msg,
                               recv: ModelReceiver) -> str:
        while True:
            msg = await proto.read_frame(reader)
            if msg["t"] == "model_chunk":
                recv.on_chunk(msg)
            elif msg["t"] == "model_done":
                recv.finalize()
                recv.write_json("config.json", assign_msg["config_raw"]
                                if "config_raw" in assign_msg
                                else assign_msg["config"])
                break
            else:
                raise proto.ProtocolError(
                    f"unexpected {msg['t']!r} during weight transfer")
        return recv.dir

    # -- inference ---------------------------------------------------------------

    def _sized_cache(self, cache, needed: int):
        """The per-connection cache, allocated at the smallest bucket
        covering the request and grown bucket by bucket as positions
        advance. Returns (cache, capacity)."""
        st = self.state
        rng = (st.start, st.end)
        bkt = bucket_for(needed, st.max_cache_len)
        if cache is None:
            return init_cache(st.cfg, 1, bkt, st.dtype, self.device,
                              rng), bkt
        cap = kv_capacity(st.cfg, cache, rng)
        if cap is None:            # a ring or linear range: no capacity
            return cache, st.max_cache_len
        if needed > cap:
            cache = grow_cache(st.cfg, cache, bkt, rng)
            cap = bkt
        return cache, cap

    async def _handle_forward(self, msg, writer, cache, read_s: float = 0.0,
                              decode_s: float = 0.0):
        st = self.state
        t0 = now()
        try:
            # deser: the frame's decode (timed by the framing layer), the
            # raw-buffer unpack and the copy to the device
            t_d = now()
            x = proto.unpack_tensor(msg["x"]).to(self.device, st.dtype)
            deser_s = decode_s + (now() - t_d)
            pos0 = int(msg["pos0"])
            vl = msg.get("valid_len")
            # the kv hint sizes the cache to the master's bucket
            needed = max(pos0 + x.shape[1], int(msg.get("kv") or 0))
            cache, capacity = self._sized_cache(cache, needed)
            # prefill chunks (valid_len present) take the flash path by
            # their mode (worker caches are unwrapped inside the buffer)
            flash_mode = "off"
            if vl is not None:
                flash_mode = select_flash_mode(pos0, x.shape[1], capacity)
            loop = asyncio.get_running_loop()

            def _run():
                # timed inside the executor thread (queueing belongs to the
                # wire) and up to the host copy, which waits for the card
                t_fwd = now()
                yy, cc = st.stage.forward_hidden(x, cache, pos0, vl,
                                                 flash_mode=flash_mode)
                yy = yy.to("cpu")
                return yy, cc, t_fwd, (now() - t_fwd) * 1e3

            y, cache, t_fwd0, fwd_ms = await loop.run_in_executor(None, _run)
            t_s = now()
            packed = proto.pack_tensor(y)
            ser_s = now() - t_s
            tm = {"read_ms": read_s * 1e3, "deser_ms": deser_s * 1e3,
                  "fwd_ms": fwd_ms, "ser_ms": ser_s * 1e3}
            await proto.write_frame(
                writer, proto.tensor_result(packed, msg.get("rid", 0),
                                            fwd_ms=fwd_ms, timing=tm))
        except Exception as e:
            log.exception("forward failed")
            await proto.write_frame(writer, proto.worker_error(str(e)))
            return cache
        dt = now() - t0
        self.stats["ops"] += 1
        self.stats["fwd_s"] += dt
        self.stats["tokens"] += int(msg["x"]["sh"][0]) * int(msg["x"]["sh"][1])
        if vl is not None:
            self.stats["chunks"][flash_mode] += 1
        WORKER_FWD_SECONDS.observe(fwd_ms / 1e3)
        ph = self.phase
        ph.add("read", read_s, t0=t0 - decode_s - read_s)
        ph.add("deser", deser_s, t0=t0 - decode_s)
        ph.add("fwd", fwd_ms / 1e3, t0=t_fwd0)
        ph.add("ser", ser_s, t0=t_s)
        if self.stats["ops"] % 5 == 0:
            log.debug("worker %s: %d ops, avg %.1f ms [%s]", self.name,
                      self.stats["ops"],
                      1000 * self.stats["fwd_s"] / self.stats["ops"], ph)
        return cache


def run_worker(name: str, cluster_key: str, port: int = 10128,
               model_dir: str | None = None, **kw):
    """Blocking entry point (`cli worker`)."""
    async def main():
        server = WorkerServer(name, cluster_key, port, model_dir, **kw)
        await server.start()
        await server.serve_forever()
    asyncio.run(main())
