"""The port's layer-sharded cluster (module 13a, cake_tpu_torch/cluster/)
against the JAX package's (cake_tpu/cluster/), on the CPU at a tiny size:

  * every message constructor's frame is byte for byte the JAX
    `encode_frame`'s (hypothesis over the field values); frames encoded
    by either package decode in the other; the port's msgpack codec
    gives msgpack's bytes and reads them back;
  * tensors round-trip at f32, bf16 and f16 (and int32, uint8, fp8)
    into the JAX `unpack_tensor` and back;
  * the HMAC handshake both ways, a wrong key failing;
  * topology: the reference's YAML texts give the JAX reader's
    Topology; text outside the YAML subset raises;
  * DefaultStrategy's assignments equal the JAX ones on random
    capacities (hypothesis), and estimate_layer_bytes the JAX sizes;
  * weight streaming from the port's sender is accepted by the JAX
    ModelReceiver, uncompressed when zstandard is blocked; CRC and
    resume are checked;
  * discovery on loopback;
  * the reference's end-to-end contract (tests/test_cluster.py:319-365):
    a port master and a port worker over localhost TCP, local, remote and
    local stages, f32, greedy output equal to the JAX TextModel's twice
    on one cluster; the pipelined prefill; FP8 native streaming; the
    worker's cache skipping the second push;
  * across packages: a port master driving a JAX worker and a JAX master
    driving a port worker give the JAX TextModel's greedy tokens;
  * `cli serve --cluster-key --topology` answers a chat over HTTP, lists
    the nodes at /api/v1/topology and answers /health 200.
Greedy tokens are held exactly (float32); no tolerance is involved."""
import asyncio
import gc
import json
import os
import socket
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cake_tpu.cluster import proto as jproto
from cake_tpu.cluster import transfer as jtransfer
from cake_tpu.cluster.auth import (authenticate_as_master as j_auth_master,
                                   authenticate_as_worker as j_auth_worker)
from cake_tpu.cluster.auth import AuthError as JaxAuthError
from cake_tpu.cluster.auth import cluster_hash as j_cluster_hash
from cake_tpu.cluster.master import DistributedTextModel as JaxDist
from cake_tpu.cluster.master import master_setup as jax_master_setup
from cake_tpu.cluster.strategy import DefaultStrategy as JaxStrategy
from cake_tpu.cluster.strategy import WorkerCapacity as JaxCapacity
from cake_tpu.cluster.strategy import estimate_layer_bytes as j_layer_bytes
from cake_tpu.cluster.topology import Topology as JaxTopology
from cake_tpu.models import SamplingConfig as JaxSampling
from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models.common.config import config_from_hf_dict as jax_cfg
from cake_tpu.models.common.layers import init_params as jax_init
from cake_tpu.utils.export import params_to_hf_tensors as jax_export
from cake_tpu.utils.safetensors_io import TensorStorage as JaxStorage
from cake_tpu.utils.safetensors_io import save_safetensors as jax_save
from cake_tpu_torch.cluster import codec, proto, transfer
from cake_tpu_torch.cluster.auth import (AuthError, authenticate_as_master,
                                         authenticate_as_worker,
                                         cluster_hash)
from cake_tpu_torch.cluster.discovery import (WorkerAdvertiser,
                                              discover_workers)
from cake_tpu_torch.cluster.master import (DistributedTextModel,
                                           master_setup)
from cake_tpu_torch.cluster.strategy import (DefaultStrategy, WorkerCapacity,
                                             estimate_layer_bytes)
from cake_tpu_torch.cluster.topology import (Topology, expand_layer_specs,
                                             load_yaml)
from cake_tpu_torch.cluster.worker import WorkerServer
from cake_tpu_torch.models.common.config import config_from_hf_dict
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.utils.safetensors_io import TensorStorage

torch.set_num_threads(1)
GREEDY = SamplingConfig(temperature=0.0)
JGREEDY = JaxSampling(temperature=0.0)
KEY = "port-cluster-key"
# the reference's tiny cluster model (tests/test_cluster.py:260-272)
CONFIG = dict(architectures=["Qwen3ForCausalLM"], vocab_size=256,
              hidden_size=64, intermediate_size=128, num_hidden_layers=4,
              num_attention_heads=4, num_key_value_heads=2,
              rms_norm_eps=1e-5, rope_theta=10000.0,
              max_position_embeddings=128, eos_token_id=2)
CPU_CAPS = {"backend": "cpu", "device": "cpu", "memory_bytes": 8 << 30,
            "tflops": 1.0}


@pytest.fixture(autouse=True)
def _collect_reference_engines():
    """JAX models and workers built here are collected after each test."""
    yield
    gc.collect()


def write_model(path: str, config: dict = CONFIG, seed: int = 3):
    """A checkpoint directory written by the JAX exporter from seeded JAX
    weights; returns (JAX config, JAX params)."""
    os.makedirs(path, exist_ok=True)
    jcfg = jax_cfg(config)
    params = jax_init(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    jax_save(os.path.join(path, "model.safetensors"),
             jax_export(jcfg, params))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return jcfg, params


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cluster") / "model")
    jcfg, params = write_model(d)
    want = {}

    def ref(prompt, n, max_cache_len=64):
        key = (tuple(prompt), n, max_cache_len)
        if key not in want:
            jm = JaxTextModel(jcfg, params, dtype=jnp.float32,
                              max_cache_len=max_cache_len)
            want[key], _ = jm.generate(list(prompt), max_new_tokens=n,
                                       sampling=JGREEDY)
        return want[key]
    return d, jcfg, config_from_hf_dict(CONFIG), ref


def start_port_worker(name, key, cache_root, port=0, model_dir=None):
    """A port WorkerServer on its own event-loop thread, on the CPU;
    returns (holder, thread)."""
    holder, ready = {}, threading.Event()

    def run():
        async def main():
            server = WorkerServer(name, key, port=port, model_dir=model_dir,
                                  cache_root=cache_root, advertise=False,
                                  device="cpu")
            await server.start()
            holder["port"], holder["server"] = server.port, server
            ready.set()
            try:
                await server.serve_forever()
            except asyncio.CancelledError:
                pass

        loop = asyncio.new_event_loop()
        holder["loop"] = loop
        try:
            loop.run_until_complete(main())
        finally:
            loop.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(10)
    return holder, t


def stop_worker(holder, t):
    loop, srv = holder.get("loop"), holder.get("server")
    if loop and srv and loop.is_running():
        try:
            asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(
                timeout=5)
        except Exception:
            pass
    t.join(timeout=10)


def start_jax_worker(name, key, cache_root):
    sys.path.insert(0, os.path.dirname(__file__))
    from test_cluster import _start_worker_thread
    ready = threading.Event()
    holder, t = _start_worker_thread(name, key, cache_root, ready)
    assert ready.wait(10)
    return holder, t


def workers_of(name, port):
    return [{"name": name, "host": "127.0.0.1", "port": port,
             "caps": CPU_CAPS}]


# -- the wire ----------------------------------------------------------------

names = st.text(min_size=0, max_size=40)
ints = st.integers(min_value=-2**40, max_value=2**40)
small = st.integers(min_value=0, max_value=2**31 - 1)
floats = st.floats(allow_nan=False, allow_infinity=False, width=64)


def _tensor_pair(data: np.ndarray):
    return torch.from_numpy(data.copy()), data


@settings(max_examples=30, deadline=None)
@given(name=names, layers=st.lists(small, max_size=20), tf=floats,
       mem=small, age=st.one_of(st.none(), floats), ops=st.one_of(
           st.none(), small), start=small, end=small, flag=st.booleans(),
       blob=st.binary(max_size=300), off=small, idx=small,
       cfg=st.dictionaries(names, st.one_of(ints, names, floats,
                                            st.booleans(), st.none()),
                           max_size=20))
def test_every_constructor_frames_like_jax(name, layers, tf, mem, age, ops,
                                           start, end, flag, blob, off,
                                           idx, cfg):
    pairs = [
        (proto.hello(name), jproto.hello(name)),
        (proto.worker_info(name, layers, "cuda", name, mem, tf, age, ops),
         jproto.worker_info(name, layers, "cuda", name, mem, tf, age, ops)),
        (proto.layer_assignment(name, name, cfg, start, end, "f16", name,
                                flag, not flag),
         jproto.layer_assignment(name, name, cfg, start, end, "f16", name,
                                 flag, not flag)),
        (proto.model_chunk(name, idx, end, blob, proto.crc32(blob), flag,
                           off),
         jproto.model_chunk(name, idx, end, blob, jproto.crc32(blob), flag,
                            off)),
        (proto.model_done(), jproto.model_done()),
        (proto.model_resume(name, off), jproto.model_resume(name, off)),
        (proto.worker_ready(flag, name or None),
         jproto.worker_ready(flag, name or None)),
        (proto.worker_error(name), jproto.worker_error(name)),
        (proto.goodbye(), jproto.goodbye()),
        (proto.ack(), jproto.ack()),
    ]
    rng = np.random.default_rng(idx % 1000)
    x = rng.standard_normal((1, 3, 8)).astype(np.float32)
    pairs.append((proto.forward(torch.from_numpy(x), start, None if flag
                                else end, idx, None if flag else off),
                  jproto.forward(x, start, None if flag else end, idx,
                                 None if flag else off)))
    tm = {"read_ms": abs(tf) % 1e3, "fwd_ms": 1.5}
    pairs.append((proto.tensor_result(torch.from_numpy(x), idx,
                                      fwd_ms=abs(tf) % 1e3, timing=tm),
                   jproto.tensor_result(x, idx, fwd_ms=abs(tf) % 1e3,
                                        timing=tm)))
    for port_msg, jax_msg in pairs:
        frame = proto.encode_frame(port_msg)
        assert frame == jproto.encode_frame(jax_msg), port_msg["t"]
        assert proto.decode_payload(frame[8:]) == \
            jproto.decode_payload(frame[8:])


@settings(max_examples=60, deadline=None)
@given(obj=st.recursive(
    st.one_of(st.none(), st.booleans(),
              st.integers(min_value=-2**63, max_value=2**64 - 1), floats,
              st.text(max_size=300), st.binary(max_size=300)),
    lambda inner: st.one_of(st.lists(inner, max_size=20),
                            st.dictionaries(st.text(max_size=10), inner,
                                            max_size=20)),
    max_leaves=40))
def test_codec_is_msgpack(obj):
    data = codec.packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    assert codec.unpackb(data) == msgpack.unpackb(data, raw=False)


def test_codec_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        codec.packb({1, 2})
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError):
        codec.unpackb(b"\x92\x01")            # truncated array
    with pytest.raises(proto.ProtocolError):
        proto.decode_payload(b"\xc1")         # never used in msgpack


def test_frames_cross_packages_over_sockets():
    """A JAX-encoded frame read by the port's socket reader and a
    port-encoded one read by the JAX reader; bad magic raises."""
    x = np.arange(24, dtype=np.float32).reshape(1, 3, 8)
    a, b = socket.socketpair()
    try:
        a.sendall(jproto.encode_frame(jproto.forward(x, 5, 2, 9, 64)))
        got = proto.read_frame_sync(b)
        assert got["t"] == "forward" and got["pos0"] == 5 \
            and got["rid"] == 9 and got["kv"] == 64
        assert torch.equal(proto.unpack_tensor(got["x"]),
                           torch.from_numpy(x))
        a.sendall(proto.encode_frame(proto.forward(torch.from_numpy(x), 7,
                                                   None, 3)))
        got = jproto.read_frame_sync(b)
        assert got["valid_len"] is None and got["pos0"] == 7
        np.testing.assert_array_equal(jproto.unpack_tensor(got["x"]), x)
        a.sendall(b"\x00\x00\x00\x00\x04\x00\x00\x00abcd")
        with pytest.raises(proto.ProtocolError, match="bad magic"):
            proto.read_frame_sync(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.uint8,
                                   torch.float8_e4m3fn])
def test_tensors_round_trip_with_jax(dtype):
    g = torch.Generator().manual_seed(5)
    t = (torch.randn((2, 3, 5), generator=g) * 8).to(dtype)
    j = jproto.unpack_tensor(proto.pack_tensor(t))
    assert j.dtype.name == str(dtype).split(".")[1]
    back = proto.unpack_tensor(jproto.pack_tensor(j))
    assert back.dtype == dtype and back.shape == t.shape
    assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))
    if dtype.is_floating_point:
        np.testing.assert_array_equal(j.astype(np.float32),
                                      t.float().numpy())


# -- authentication ----------------------------------------------------------

def _auth(worker_side, master_side):
    """Run a worker-side and a master-side handshake against each other;
    (master result, worker result): True or the exception."""
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
        s = await asyncio.wait_for(done, 15)
        srv.close()
        return c, s
    return asyncio.run(go())


@pytest.mark.parametrize("worker,master", [
    (authenticate_as_worker, j_auth_master),
    (j_auth_worker, authenticate_as_master),
    (authenticate_as_worker, authenticate_as_master)],
    ids=["port-worker", "port-master", "port-both"])
def test_auth_both_ways(worker, master):
    ok = _auth(lambda r, w: worker(r, w, "secret"),
               lambda r, w: master(r, w, "secret"))
    assert ok == (True, True)
    bad = _auth(lambda r, w: worker(r, w, "secret"),
                lambda r, w: master(r, w, "other"))
    assert any(isinstance(e, (AuthError, JaxAuthError)) for e in bad)
    assert cluster_hash("k") == j_cluster_hash("k") != cluster_hash("k2")


# -- topology and strategy -----------------------------------------------------

TOPOLOGY_TEXTS = ["""
w0:
  host: 10.0.0.2:10128
  layers: ["model.layers.0-13"]
  tflops: 394
w1:
  host: 10.0.0.3:10128
  layers: ["model.layers.14-27"]
  memory_bytes: 17179869184
""", """
a:
  host: "127.0.0.1:5000"   # a comment
  layers:
  - model.layers.1-3
  - layers.4
  tflops: 1.5
  backend: cuda
b:
  host: 'localhost:10129'
  layers: []
  memory_bytes: 0
"""]


@pytest.mark.parametrize("text", TOPOLOGY_TEXTS, ids=["reference", "forms"])
def test_topology_reads_as_jax_reads_it(tmp_path, text):
    import yaml
    p = tmp_path / "topo.yml"
    p.write_text(text)
    assert load_yaml(text) == yaml.safe_load(text)
    mine, ref = Topology.from_path(str(p)), JaxTopology.from_path(str(p))
    assert mine.nodes.keys() == ref.nodes.keys()
    for name, n in mine.nodes.items():
        r = ref.nodes[name]
        assert (n.host, n.layers, n.memory_bytes, n.tflops, n.backend,
                n.addr, n.layer_range) == (
            r.host, r.layers, r.memory_bytes, r.tflops, r.backend, r.addr,
            r.layer_range)
    assert mine.to_dict() == ref.to_dict()
    assert expand_layer_specs(["model.layers.0-5", "layers.7", 9]) == \
        [0, 1, 2, 3, 4, 5, 7, 9]
    with pytest.raises(ValueError):
        expand_layer_specs(["model.layers.5-2"])
    with pytest.raises(ValueError, match="assigned twice"):
        Topology.from_dict({"a": {"host": "x:1", "layers": ["layers.0-3"]},
                            "b": {"host": "y:1", "layers": ["layers.3-5"]},
                            }).assigned_layers()


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: yes", "a: 0x10", "a: 010", "a: 1:30", "a: {b: 1}",
    "a: |\n  x", "---\na: 1", "a:\n\t  b: 1", "a: [1, [2]]",
    "a:\n  - b: 1", "a: !!str 1", "a: 2001-12-14", "a: .inf"])
def test_topology_refuses_yaml_outside_its_subset(text):
    with pytest.raises(ValueError):
        load_yaml(text)


@settings(max_examples=60, deadline=None)
@given(caps=st.lists(st.tuples(st.integers(0, 10**6),
                               st.floats(0.1, 1000), st.sampled_from(
                                   ["cuda", "cpu", "tpu", "metal"])),
                     min_size=1, max_size=5),
       sizes=st.lists(st.integers(0, 4000), min_size=1, max_size=40))
def test_strategy_assigns_as_jax(caps, sizes):
    mine = [WorkerCapacity(f"w{i}", m, t, b) for i, (m, t, b) in
            enumerate(caps)]
    ref = [JaxCapacity(f"w{i}", m, t, b) for i, (m, t, b) in
           enumerate(caps)]
    layers = list(range(len(sizes)))
    assert DefaultStrategy().assign_layers(mine, layers, sizes) == \
        JaxStrategy().assign_layers(ref, layers, sizes)


def test_layer_bytes_equal_jax(model_dir):
    d, *_ = model_dir
    with TensorStorage.from_model_dir(d) as s:
        mine = estimate_layer_bytes(s, 4, 1.5)
    j = JaxStorage.from_model_dir(d)
    assert mine == j_layer_bytes(j, 4, 1.5) and all(mine)
    j.close()


# -- weight streaming ----------------------------------------------------------

@pytest.mark.parametrize("zstd", [True, False], ids=["zstd", "no-zstd"])
def test_stream_is_accepted_by_jax_receiver(model_dir, tmp_path,
                                            monkeypatch, zstd):
    d, *_ = model_dir
    if not zstd:
        monkeypatch.setattr(transfer, "zstandard", None)
    s = TensorStorage.from_model_dir(d)
    names = transfer.subset_tensor_names(s, 1, 3, 4)
    assert names and all(".layers.1." in n or ".layers.2." in n
                         for n in names)
    total, chunks = transfer.synthesize_safetensors(s, names,
                                                    chunk_size=4096)
    js = JaxStorage.from_model_dir(d)
    jtotal, jchunks = jtransfer.synthesize_safetensors(
        js, jtransfer.subset_tensor_names(js, 1, 3, 4), chunk_size=4096)
    mine = list(chunks)
    assert total == jtotal and b"".join(mine) == b"".join(jchunks)
    recv = jtransfer.ModelReceiver(str(tmp_path / "cache"), "k-1")
    msgs = list(transfer.encode_chunks("model.safetensors", total, mine))
    assert len(msgs) >= 2
    if not zstd:
        assert not any(m["z"] for m in msgs)
    for m in msgs:
        recv.on_chunk(jproto.decode_payload(proto.encode_frame(m)[8:]))
    recv.finalize()
    out = JaxStorage.from_model_dir(recv.dir)
    for n in names:
        np.testing.assert_array_equal(out.read(n), js.read(n))
    assert transfer.has_valid_model_cache(str(tmp_path / "cache"), "k-1",
                                          {"model.safetensors": total})
    assert not transfer.has_valid_model_cache(
        str(tmp_path / "cache"), "k-1", {"model.safetensors": total + 1})
    s.close()
    js.close()
    out.close()


def test_stream_crc_resume_and_the_zstd_gate(model_dir, tmp_path,
                                             monkeypatch):
    d, *_ = model_dir
    s = TensorStorage.from_model_dir(d)
    names = transfer.subset_tensor_names(s, 0, 4, 4)
    total, chunks = transfer.synthesize_safetensors(s, names,
                                                    chunk_size=4096)
    full = list(chunks)
    # a corrupted chunk is refused
    bad = proto.model_chunk("f", 0, 1, b"hello", 12345, False, 0)
    with pytest.raises(proto.ProtocolError, match="CRC"):
        transfer.ModelReceiver(str(tmp_path / "c0"), "k").on_chunk(bad)
    # resume: half the stream, then the rest from the receiver's offset
    recv = transfer.ModelReceiver(str(tmp_path / "c1"), "k")
    msgs = list(transfer.encode_chunks("model.safetensors", total, full))
    for m in msgs[:len(msgs) // 2]:
        recv.on_chunk(m)
    for f in recv._files.values():
        f.flush()
    off = recv.resume_offset("model.safetensors")
    assert 0 < off < total
    rest = list(transfer.encode_chunks("model.safetensors", total, full,
                                       start_offset=off))
    assert rest[0]["off"] == off
    for m in rest:
        recv.on_chunk(m)
    recv.finalize()
    with open(os.path.join(recv.dir, "model.safetensors"), "rb") as f:
        assert f.read() == b"".join(full)
    # without zstandard a compressed chunk is refused, as the reference's
    z = next((m for m in msgs if m["z"]), None)
    if z is not None:
        monkeypatch.setattr(transfer, "zstandard", None)
        with pytest.raises(proto.ProtocolError, match="zstandard"):
            transfer.ModelReceiver(str(tmp_path / "c2"), "k").on_chunk(z)
    s.close()


def test_discovery_on_loopback():
    port = 19500 + os.getpid() % 400
    caps = {"backend": "cuda", "device": "NVIDIA H100 80GB HBM3",
            "n_devices": 1, "memory_bytes": 80 << 30, "tflops": 989.0}
    adv = WorkerAdvertiser("w-port", "key1", 12345, discovery_port=port,
                           caps=caps).start()
    try:
        found = discover_workers("key1", timeout=1.5, discovery_port=port,
                                 expected=1, addresses=["127.0.0.1"])
        assert len(found) == 1
        w = found[0]
        assert (w["name"], w["port"], w["caps"], w["host"]) == (
            "w-port", 12345, caps, "127.0.0.1")
        assert discover_workers("other-key", timeout=0.5,
                                discovery_port=port,
                                addresses=["127.0.0.1"]) == []
    finally:
        adv.stop()


# -- master and worker, end to end ---------------------------------------------

PROMPT = [1, 2, 3, 4, 5]


def test_port_master_and_worker_match_jax(model_dir, tmp_path):
    """The reference's contract (tests/test_cluster.py:319-365): the
    worker takes the middle layers, the master the rest; greedy output
    equals the JAX TextModel's, twice on one cluster; a second setup
    finds the worker's cache and pushes nothing."""
    d, _, cfg, ref = model_dir
    holder, t = start_port_worker("w0", KEY, str(tmp_path / "wc"))
    try:
        setup = master_setup(d, KEY, cfg, workers_of("w0", holder["port"]),
                             assignments={"w0": (1, 3)}, dtype_str="f32",
                             max_cache_len=64, device="cpu")
        assert [(s.kind, s.start, s.end) for s in setup.stages] == [
            ("local", 0, 1), ("remote", 1, 3), ("local", 3, 4)]
        assert setup.streams["w0"]["bytes"] > 0
        dist = DistributedTextModel(cfg, setup.master_params, setup.stages,
                                    dtype=torch.float32, device="cpu",
                                    max_cache_len=64)
        want = ref(PROMPT, 8)
        got, stats = dist.generate(PROMPT, max_new_tokens=8,
                                   sampling=GREEDY)
        assert got == want
        assert stats["decode_tokens"] == len(got) - 1
        rtt = stats["stage_rtts"]["w0[1:3]"]
        assert rtt["count"] == len(got) and "wire_p50_ms" in rtt
        got2, _ = dist.generate(PROMPT, max_new_tokens=8, sampling=GREEDY)
        assert got2 == want
        dist.close()
        again = master_setup(d, KEY, cfg, workers_of("w0", holder["port"]),
                             assignments={"w0": (1, 3)}, dtype_str="f32",
                             max_cache_len=64, device="cpu")
        assert again.streams["w0"] == dict(again.streams["w0"], bytes=0,
                                           cached=True)
        for c in again.clients:
            c.close()
    finally:
        stop_worker(holder, t)


def test_pipelined_prefill_matches_jax(model_dir, tmp_path):
    """A 70-token prompt at prefill_chunk 32 flows through the chain as 3
    pipelined chunks (fresh, then append); a short prompt takes the
    single pass (tests/test_cluster.py:585)."""
    d, _, cfg, ref = model_dir
    holder, t = start_port_worker("wp", KEY, str(tmp_path / "wc"))
    prompt = [(i * 7 + 3) % 250 for i in range(70)]
    try:
        setup = master_setup(d, KEY, cfg, workers_of("wp", holder["port"]),
                             assignments={"wp": (1, 3)}, dtype_str="f32",
                             max_cache_len=128, device="cpu")
        dist = DistributedTextModel(cfg, setup.master_params, setup.stages,
                                    dtype=torch.float32, device="cpu",
                                    max_cache_len=128, prefill_chunk=32)
        got, stats = dist.generate(prompt, max_new_tokens=8, sampling=GREEDY)
        assert stats["prefill"] == {"pipelined": True, "chunks": 3,
                                    "width": 32}
        assert got == ref(prompt, 8, 128)
        assert holder["server"].stats["chunks"] == {"fresh": 1,
                                                    "append": 2, "off": 0}
        got2, stats2 = dist.generate(prompt[:20], max_new_tokens=6,
                                     sampling=GREEDY)
        assert stats2["prefill"]["pipelined"] is False
        assert got2 == ref(prompt[:20], 6, 128)
        dist.close()
    finally:
        stop_worker(holder, t)


def test_fp8_native_streams_through_the_cluster(tmp_path):
    """An FP8 checkpoint (the port's writer, Qwen's block-wise layout)
    streamed with fp8_native: the worker's e4m3 tensors arrive as they
    are stored, every node keeps its projections native, and greedy
    output equals the port's single-process native model
    (tests/test_cluster.py:496)."""
    from cake_tpu_torch.bench import synth_checkpoint as sc
    from cake_tpu_torch.models import TextModel
    from cake_tpu_torch.runtime import build_text_model
    d = str(tmp_path / "fp8")
    conf = dict(CONFIG, hidden_size=128, intermediate_size=256, head_dim=32)
    cfg = config_from_hf_dict(conf)
    sc.write_fp8_model(d, conf, sc.model_params(conf, 11, torch.float32,
                                                "cpu"))
    local, _, _ = build_text_model(d, "f32", device="cpu", fp8_native=True,
                                   max_cache_len=64)
    assert isinstance(local, TextModel)
    want, _ = local.generate(PROMPT, max_new_tokens=8, sampling=GREEDY)
    holder, t = start_port_worker("w8", KEY, str(tmp_path / "wc"))
    try:
        setup = master_setup(d, KEY, cfg, workers_of("w8", holder["port"]),
                             assignments={"w8": (1, 3)}, dtype_str="f32",
                             max_cache_len=64, fp8_native=True,
                             device="cpu")
        stage = holder["server"].state.stage
        w = stage.params["layers"][0]["self_attn"]["q_proj"]["weight"]
        assert w["fp8"].dtype == torch.float8_e4m3fn
        dist = DistributedTextModel(cfg, setup.master_params, setup.stages,
                                    dtype=torch.float32, device="cpu",
                                    max_cache_len=64)
        got, _ = dist.generate(PROMPT, max_new_tokens=8, sampling=GREEDY)
        assert got == want
        dist.close()
    finally:
        stop_worker(holder, t)


def test_port_master_drives_a_jax_worker(model_dir, tmp_path):
    d, _, cfg, ref = model_dir
    holder, t = start_jax_worker("jw", KEY, str(tmp_path / "jwc"))
    try:
        setup = master_setup(d, KEY, cfg, workers_of("jw", holder["port"]),
                             assignments={"jw": (1, 3)}, dtype_str="f32",
                             max_cache_len=64, device="cpu", warm="decode")
        dist = DistributedTextModel(cfg, setup.master_params, setup.stages,
                                    dtype=torch.float32, device="cpu",
                                    max_cache_len=64)
        got, _ = dist.generate(PROMPT, max_new_tokens=8, sampling=GREEDY)
        assert got == ref(PROMPT, 8)
        dist.close()
    finally:
        stop_worker(holder, t)


def test_jax_master_drives_a_port_worker(model_dir, tmp_path):
    d, jcfg, _, ref = model_dir
    holder, t = start_port_worker("pw", KEY, str(tmp_path / "pwc"))
    try:
        setup = jax_master_setup(d, KEY, jcfg,
                                 workers_of("pw", holder["port"]),
                                 assignments={"pw": (1, 3)},
                                 dtype_str="f32", max_cache_len=64)
        dist = JaxDist(jcfg, setup.master_params, setup.stages,
                       dtype=jnp.float32, max_cache_len=64)
        got, _ = dist.generate(PROMPT, max_new_tokens=8, sampling=JGREEDY)
        assert got == ref(PROMPT, 8)
        for c in setup.clients:
            c.close()
    finally:
        stop_worker(holder, t)


def test_cli_serve_as_a_cluster_master(tmp_path):
    """`cli serve DIR --cluster-key K --topology FILE` on the CPU: the
    worker of the topology file takes its layers, a chat is answered
    over HTTP (one request at a time, the locked path), the topology
    route lists the node and the master's stages, /health answers 200
    with the worker's liveness."""
    from cake_tpu_torch import cli
    from cake_tpu_torch.bench import synth_checkpoint as sc
    d = str(tmp_path / "m")
    conf = dict(CONFIG, vocab_size=1024, eos_token_id=1001)
    cfg = config_from_hf_dict(conf)
    sc.write_model(d, conf, sc.model_params(conf, 5, torch.float32, "cpu"))
    sc.write_tokenizer(d, {"<|im_start|>": 1000, "<|im_end|>": 1001},
                       n_merges=60)
    holder, t = start_port_worker("w0", KEY, str(tmp_path / "wc"))
    topo = tmp_path / "topo.yml"
    topo.write_text(f"w0:\n  host: 127.0.0.1:{holder['port']}\n"
                    f"  layers: [\"model.layers.1-2\"]\n  backend: cpu\n")
    args = cli.parser().parse_args(
        ["serve", d, "--cpu", "--dtype", "f32", "--port", "0",
         "--cluster-key", KEY, "--topology", str(topo)])
    app = cli.build_server(args)
    app.start()
    try:
        req = urllib.request.Request(
            app.url + "/v1/chat/completions", data=json.dumps({
                "messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 6, "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert r.status == 200 and body["usage"]["completion_tokens"] >= 1
        with urllib.request.urlopen(app.url + "/api/v1/topology",
                                    timeout=30) as r:
            topo_body = json.loads(r.read())
        assert topo_body["nodes"]["w0"]["layer_range"] == [1, 3]
        assert [s["kind"] for s in topo_body["master"]["stages"]] == [
            "local", "remote", "local"]
        with urllib.request.urlopen(app.url + "/health", timeout=30) as r:
            health = json.loads(r.read())
        assert r.status == 200 and health["status"] == "ok"
        assert health["workers"][0]["name"] == "w0"
        assert health["workers"][0]["ops"] >= 1
        assert health["stale_workers"] == []
    finally:
        app.stop(drain_s=5)
        app.state.model.close()
        stop_worker(holder, t)
