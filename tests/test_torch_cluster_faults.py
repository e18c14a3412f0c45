"""The port cluster's fault tolerance (cake_tpu_torch/cluster/faults.py,
the master's recovery, the client's failure classes), after the
reference's tests/test_cluster_faults.py, on the CPU at a tiny size:

  * fault plans parse as the JAX injector parses them, and install and
    clear the proto hook;
  * goodbye never raises; a forward with no channel is a `conn` failure;
  * a truncated handshake is an AuthError, both async sides and the
    master's sync one;
  * a worker connection dropped mid-decode costs exactly one replay, and
    the continuation equals the unfailed run (the JAX TextModel's greedy
    tokens, float32); the revived channel serves the next request with
    no recovery;
  * a crashed worker exhausts the retry budget: ClusterDegradedError,
    fast failure while degraded, /health 503 naming the worker, a chat
    answered 503 with Retry-After, and the restore loop revives the
    worker once it is back, after which /health answers 200;
  * a gray hop (every op delayed) is flagged in /health without a
    recovery."""
import asyncio
import gc
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from cake_tpu.cluster import faults as jfaults
from cake_tpu_torch import obs
from cake_tpu_torch.api.server import create_app
from cake_tpu_torch.cluster import faults, proto
from cake_tpu_torch.cluster.auth import (AuthError, authenticate_as_master,
                                         authenticate_as_worker)
from cake_tpu_torch.cluster.client import RemoteStage, StageFailure
from cake_tpu_torch.cluster.master import (ClusterDegradedError,
                                           DistributedTextModel,
                                           master_setup)
from cake_tpu_torch.tokenizer import ByteTokenizer
from tests.test_torch_cluster import (GREEDY, KEY, model_dir,  # noqa: F401
                                      start_port_worker, stop_worker,
                                      workers_of)

torch.set_num_threads(1)
PROMPT = [3, 17, 42, 99, 7, 11]
FAST = dict(recovery_retries=4, recovery_backoff_s=0.05,
            restore_interval_s=0.15)


@pytest.fixture(autouse=True)
def _isolated_faults():
    """Every test starts and ends without an installed fault plan; JAX
    objects built here are collected after it."""
    faults.clear()
    yield
    faults.clear()
    gc.collect()


def _dist(d, cfg, port, **kw):
    setup = master_setup(d, KEY, cfg, workers_of("w0", port),
                         assignments={"w0": (1, 3)}, dtype_str="f32",
                         max_cache_len=64, device="cpu")
    return DistributedTextModel(cfg, setup.master_params, setup.stages,
                                tokenizer=ByteTokenizer(),
                                dtype=torch.float32, device="cpu",
                                max_cache_len=64, **{**FAST, **kw})


def _remote(dist):
    return next(s for s in dist.stages if s.kind == "remote").runner


@pytest.fixture
def live(model_dir, tmp_path):  # noqa: F811
    d, _, cfg, ref = model_dir
    holder, t = start_port_worker("w0", KEY, str(tmp_path / "wc"))
    dist = _dist(d, cfg, holder["port"])
    yield dist, ref
    dist.close()
    stop_worker(holder, t)


# -- plans ---------------------------------------------------------------------

PLAN = ("w0:drop_after_ops=5;delay_ms=12.5, @w1:crash_after_ops=2,"
        "corrupt_after_ops=1;stall_once_ms=30;stall_after_ops=4")


def test_fault_plans_parse_as_jax():
    mine, ref = faults.parse_plan(PLAN), jfaults.parse_plan(PLAN)
    fields = ("target", "drop_after_ops", "delay_ms", "stall_once_ms",
              "stall_after_ops", "corrupt_after_ops", "crash_after_ops")
    assert [tuple(getattr(p, f) for f in fields) for p in mine.plans] == \
        [tuple(getattr(p, f) for f in fields) for p in ref.plans]
    assert mine.plans[0].matches("w0") and not mine.plans[0].matches("@w0")
    for bad, match in (("w0:explode=1", "unknown fault key"),
                       ("w0:drop_after_ops", "key=value"),
                       (" , ", "empty")):
        with pytest.raises(ValueError, match=match):
            faults.parse_plan(bad)
    assert proto.FAULT_HOOK is None
    inj = faults.install("*:delay_ms=1")
    assert proto.FAULT_HOOK is inj and faults.active() is inj
    faults.clear()
    assert proto.FAULT_HOOK is None


def test_goodbye_never_raises_and_no_channel_is_conn():
    rs = RemoteStage("127.0.0.1", 1, "k", "w")
    rs.goodbye()                                 # no channel: no-op
    a, b = socket.socketpair()
    rs.sock = a
    b.close()                                    # the peer is gone
    rs.goodbye()
    assert rs.sock is None
    a2, b2 = socket.socketpair()
    rs.sock = a2
    b2.sendall(b"\x00\x00\x00\x00\x10\x00\x00\x00")   # bad magic reply
    rs.goodbye()
    assert rs.sock is None
    b2.close()
    with pytest.raises(StageFailure) as ei:
        rs.forward_hidden(torch.zeros((1, 1, 4)), None, 0, None)
    assert ei.value.kind == "conn" and ei.value.worker == "w"


# -- truncated handshakes ------------------------------------------------------

def _handshake(worker_side, master_side):
    async def go():
        done = asyncio.get_running_loop().create_future()

        async def on_conn(r, w):
            try:
                await worker_side(r, w)
                done.set_result(True)
            except Exception as e:
                done.set_result(e)
            finally:
                w.close()
        srv = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        r, w = await asyncio.open_connection("127.0.0.1", port)
        try:
            await master_side(r, w)
            c = True
        except Exception as e:
            c = e
        w.close()
        s = await asyncio.wait_for(done, 20)
        srv.close()
        return c, s
    return asyncio.run(go())


def test_truncated_handshakes_are_auth_errors():
    async def bad_master(r, w):
        await r.readexactly(32)
        w.write(b"\x00" * 10)                    # a truncated answer
        await w.drain()
        w.close()

    async def bad_worker(r, w):
        w.write(b"\x01" * 7)                     # a truncated challenge
        await w.drain()
        w.close()

    _, s = _handshake(lambda r, w: authenticate_as_worker(r, w, "k"),
                      bad_master)
    assert isinstance(s, AuthError)
    c, _ = _handshake(bad_worker,
                      lambda r, w: authenticate_as_master(r, w, "k"))
    assert isinstance(c, AuthError)
    # the master's sync handshake: a peer that closes mid-auth
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def peer():
        conn, _ = srv.accept()
        conn.sendall(b"\x02" * 32)
        conn.recv(64)
        conn.close()
    t = threading.Thread(target=peer, daemon=True)
    t.start()
    rs = RemoteStage("127.0.0.1", srv.getsockname()[1], "k", "w",
                     timeout=2.0)
    with pytest.raises(ConnectionError, match="auth"):
        rs.connect(attempts=1)
    t.join(timeout=5)
    srv.close()


# -- recovery ------------------------------------------------------------------

def test_drop_mid_decode_costs_one_replay(live):
    dist, ref = live
    want = ref(PROMPT, 8)
    reconnects0 = obs.CLUSTER_RECONNECTS.value(worker="w0")
    replays0 = obs.CLUSTER_REPLAYS.value()
    faults.install("w0:drop_after_ops=4")
    got, stats = dist.generate(PROMPT, max_new_tokens=8, sampling=GREEDY)
    assert got == want
    assert stats["replays"] == 1 and stats["recoveries"] == 1
    assert obs.CLUSTER_RECONNECTS.value(worker="w0") == reconnects0 + 1
    assert obs.CLUSTER_REPLAYS.value() == replays0 + 1
    assert obs.CLUSTER_STAGE_FAILURES.value(worker="w0", kind="eof") >= 1
    faults.clear()
    got2, stats2 = dist.generate(PROMPT, max_new_tokens=8, sampling=GREEDY)
    assert got2 == want
    assert stats2["replays"] == 0 and stats2["recoveries"] == 0


def test_gray_hop_flagged_without_abort(live):
    from cake_tpu_torch.api.obs_routes import worker_health
    dist, ref = live
    runner = _remote(dist)
    runner.degraded_ms = 10              # what CAKE_HOP_DEGRADED_MS sets
    faults.install("w0:delay_ms=40")
    got, stats = dist.generate(PROMPT, max_new_tokens=8, sampling=GREEDY)
    assert got == ref(PROMPT, 8)
    assert stats["recoveries"] == 0 and stats["replays"] == 0
    assert runner.gray_degraded and runner.rtt_p95_ms() > 10
    entry = worker_health(dist)[0]
    assert entry["degraded"] is True and entry["failing"] is False
    assert obs.CLUSTER_HOP_DEGRADED.value(worker="w0") == 1.0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def test_exhausted_budget_degrades_then_restores(model_dir, tmp_path):  # noqa: F811
    d, _, cfg, ref = model_dir
    wc = str(tmp_path / "wc")
    holder, t = start_port_worker("w0", KEY, wc)
    port = holder["port"]
    dist = _dist(d, cfg, port, recovery_retries=2, recovery_backoff_s=0.02,
                 restore_interval_s=0.15)
    app = create_app(dist, None, ByteTokenizer(), port=0)
    app.start()
    holder2 = t2 = None
    try:
        faults.install("@w0:crash_after_ops=3")
        with pytest.raises(ClusterDegradedError):
            dist.generate(PROMPT, max_new_tokens=6, sampling=GREEDY)
        assert dist.degraded_info()["worker"] == "w0"
        assert obs.CLUSTER_DEGRADED.value() == 1.0
        t0 = time.monotonic()
        with pytest.raises(ClusterDegradedError):
            dist.generate(PROMPT, max_new_tokens=6, sampling=GREEDY)
        assert time.monotonic() - t0 < 0.5      # fails fast
        status, body, _ = _get(app.url + "/health")
        assert status == 503 and body["status"] == "degraded"
        assert body["cluster"]["worker"] == "w0"
        req = urllib.request.Request(
            app.url + "/v1/chat/completions", data=json.dumps({
                "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        # the worker comes back on the same port: the restore loop revives
        # it (the crash fault is one-shot)
        faults.clear()
        stop_worker(holder, t)
        holder2, t2 = start_port_worker("w0", KEY, wc, port=port)
        deadline = time.monotonic() + 20
        while dist.degraded_info() is not None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert dist.degraded_info() is None
        assert obs.CLUSTER_DEGRADED.value() == 0.0
        got, _ = dist.generate(PROMPT, max_new_tokens=6, sampling=GREEDY)
        assert got == ref(PROMPT, 6)
        status, body, _ = _get(app.url + "/health")
        assert status == 200 and body["status"] == "ok"
    finally:
        app.stop(drain_s=5)
        dist.close()
        if holder2 is not None:
            stop_worker(holder2, t2)
        else:
            stop_worker(holder, t)
