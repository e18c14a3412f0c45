"""The port's image endpoints and job lane (api/images.py, api/qos.py:
run_admitted_job, serve/admission/jobs.py) on its standard-library
server, mirroring the reference's tests/test_api.py and tests/test_qos.py
image cases: b64_json and the legacy raw PNG (the port's PNG decoded by
Pillow equals the reference pipeline's to_pil array on the same
parameters, text embeddings and initial noise), `n` 1-4 with derived
seeds and its 400s, size clamping and CAKE_IMAGE_MAX_SIZE, QoS `batch` by
default / the override / an invalid class, 503 with no model and while
draining, the tenant quota's 429, the job's timeline (received, enqueue,
admit, finish), cancellation when the client disconnects, the lock rule
of the locked text path, and the executor's drain. No JAX job executor
is started: the reference pipeline is called directly."""
import base64
import gc
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.image import flux as jflux
from cake_tpu.models.image import mmdit as jmm
from cake_tpu.models.image import vae as jvae
from cake_tpu_torch.api import create_app
from cake_tpu_torch.models.image import flux as tflux
from cake_tpu_torch.obs import TIMELINES
from cake_tpu_torch.serve.admission import (AdmissionPlane, GenerationJob,
                                            JobCancelled, JobExecutor,
                                            JobsDraining, TenantRegistry)
from cake_tpu_torch.utils.png import RgbImage
from cake_tpu_torch.utils.weights import tree_from_numpy

torch.set_num_threads(1)
PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


class _Fixed:
    def __init__(self, txt, vec):
        self.txt, self.vec = txt, vec

    def __call__(self, prompt):
        return self.txt, self.vec


class _JaxNoise:
    """The port's pipeline with the reference's initial noise for a seed
    (jax.random), so a served image can equal the reference's."""

    def __init__(self, model):
        self.model = model

    def generate_image(self, prompt, **kw):
        lh, lw = tflux.latent_size(self.model.cfg, kw["width"], kw["height"])
        seed = kw.get("seed")
        noise = jax.random.normal(
            jax.random.PRNGKey(seed if seed is not None else 0),
            (1, self.model.cfg.vae.latent_channels, lh, lw), jnp.float32)
        return self.model.generate_image(
            prompt, noise=torch.from_numpy(np.asarray(noise)), **kw)


@pytest.fixture(scope="module")
def pair():
    """(reference FluxImageModel, the port's on the same parameters)."""
    cfg = jflux.tiny_flux_config()
    k1, k2 = jax.random.split(jax.random.PRNGKey(21))
    params = {"transformer": jmm.init_mmdit_params(cfg.mmdit, k1,
                                                   jnp.float32),
              "vae": jvae.init_vae_decoder_params(cfg.vae, k2, jnp.float32)}
    rng = np.random.default_rng(2)
    txt = rng.standard_normal((1, 6, cfg.mmdit.txt_dim), np.float32)
    vec = rng.standard_normal((1, cfg.mmdit.vec_dim), np.float32)
    ref = jflux.FluxImageModel(cfg, params=params, text_encoder=_Fixed(
        jnp.asarray(txt), jnp.asarray(vec)))
    port = tflux.FluxImageModel(
        cfg, params={k: tree_from_numpy(jax.tree.map(np.asarray, v), "cpu",
                                        torch.float32)
                     for k, v in params.items()},
        text_encoder=_Fixed(torch.from_numpy(txt), torch.from_numpy(vec)),
        device="cpu")
    return ref, port


class Server:
    def __init__(self, image_model, model=None, plane=None):
        self.app = create_app(model, None, None, port=0, plane=plane,
                              image_model=image_model).start()
        self.url = self.app.url

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.app.stop(drain_s=5)

    def post(self, path, body, headers=None):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(
            self.url + path, data=data,
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def get_json(self, path):
        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            return json.loads(r.read())


def _pixels(png: bytes) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _near(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_b64_and_raw_png_equal_the_reference(pair):
    ref, port = pair
    want = np.asarray(ref.generate_image("a cat", 32, 24, steps=2, seed=3))
    with Server(_JaxNoise(port)) as s:
        status, hdrs, raw = s.post("/v1/images/generations", {
            "prompt": "a cat", "size": "32x24", "steps": 2, "seed": 3})
        assert status == 200
        body = json.loads(raw)
        assert len(body["data"]) == 1 and isinstance(body["created"], int)
        png = base64.b64decode(body["data"][0]["b64_json"])
        assert png[:8] == PNG
        _near(_pixels(png), want)
        status, hdrs, raw = s.post("/api/v1/image", {
            "prompt": "a cat", "size": "32x24", "steps": 2, "seed": 3})
        assert status == 200 and hdrs["Content-Type"] == "image/png"
        assert raw == png
        status, hdrs, raw = s.post("/v1/images/generations", {
            "prompt": "a cat", "size": "32x24", "steps": 2, "seed": 3,
            "response_format": "png"})
        assert status == 200 and raw == png


def test_n_images_take_derived_seeds(pair):
    _, port = pair
    model = _JaxNoise(port)
    with Server(model) as s:
        status, _, raw = s.post("/v1/images/generations", {
            "prompt": "x", "size": "16x16", "steps": 1, "seed": 5, "n": 3})
        assert status == 200
        got = [_pixels(base64.b64decode(d["b64_json"]))
               for d in json.loads(raw)["data"]]
        assert len(got) == 3
        for i, pix in enumerate(got):
            want = np.asarray(model.generate_image(
                "x", width=16, height=16, steps=1, seed=5 + i))
            assert np.array_equal(pix, want)
        for n in (5, "many", -1):
            status, _, _ = s.post("/v1/images/generations", {
                "prompt": "x", "size": "16x16", "steps": 1, "n": n})
            assert status == 400, n
        # the reference reads `n or 1`: 0 and null ask for one image
        for n in (0, None):
            status, _, raw = s.post("/v1/images/generations", {
                "prompt": "x", "size": "16x16", "steps": 1, "n": n})
            assert status == 200 and len(json.loads(raw)["data"]) == 1
        assert s.post("/v1/images/generations", {
            "prompt": "x", "size": "16x16", "n": 2,
            "response_format": "png"})[0] == 400
        assert s.post("/api/v1/image", {"prompt": "x", "size": "16x16",
                                        "n": 2})[0] == 400


def test_size_clamped_and_bad_bodies(pair, monkeypatch):
    _, port = pair
    with Server(port) as s:
        for size in ("999999x64", "64x999999", "0x64", "-2x32", "axb"):
            assert s.post("/v1/images/generations",
                          {"prompt": "x", "size": size})[0] == 400, size
        monkeypatch.setenv("CAKE_IMAGE_MAX_SIZE", "64")
        assert s.post("/v1/images/generations",
                      {"prompt": "x", "size": "65x32"})[0] == 400
        assert s.post("/v1/images/generations",
                      {"prompt": "x", "size": "64x32", "steps": 1})[0] == 200
        assert s.post("/v1/images/generations", b"{not json")[0] == 400
        assert s.post("/v1/images/generations", {"size": "16x16"})[0] == 400
        status, _, raw = s.post("/v1/images/generations", {
            "prompt": "x", "size": "16x16", "init_image_b64": "AAAA"})
        assert status == 400 and b"SD-only" in raw
        assert s.post("/v1/images/generations", {
            "prompt": "x", "size": "16x16", "steps": "many"})[0] == 400


def _events(s, rid):
    return s.get_json(f"/api/v1/requests/{rid}")["events"]


def test_job_timeline_and_qos_classes(pair):
    _, port = pair
    with Server(port) as s:
        rid = "trace-img-torch-1"
        status, hdrs, _ = s.post("/v1/images/generations", {
            "prompt": "a cake", "size": "16x16", "steps": 1},
            headers={"X-Cake-Request-Id": rid})
        assert status == 200 and hdrs["X-Cake-Request-Id"] == rid
        ev = _events(s, rid)
        kinds = [e["kind"] for e in ev]
        assert kinds[:2] == ["received", "enqueue"]
        assert kinds.index("admit") < kinds.index("finish")
        admit = next(e for e in ev if e["kind"] == "admit")
        assert admit["qos"] == "batch" and admit["workload"] == "image"
        status, _, _ = s.post("/v1/images/generations", {
            "prompt": "x", "size": "16x16", "steps": 1,
            "qos": "interactive"}, headers={"X-Cake-Request-Id": "img-q1"})
        assert status == 200
        admit = next(e for e in _events(s, "img-q1") if e["kind"] == "admit")
        assert admit["qos"] == "interactive"
        assert s.post("/v1/images/generations",
                      {"prompt": "x", "size": "16x16"},
                      headers={"X-Cake-QoS": "premium"})[0] == 400
        status, _, raw = s.post("/v1/images/generations", {
            "prompt": "x", "size": "16x16", "steps": 1},
            headers={"X-Cake-Request-Id": "img-h"})
        with urllib.request.urlopen(s.url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert 'cake_serve_jobs_running{kind="image"} 0' in text
        assert 'cake_generations_total{kind="image",status="ok"}' in text
        adm = s.get_json("/health")["admission"]
        assert adm["jobs_running"] == 0 and adm["job_workers"] == 1


def test_503_without_model_or_while_draining(pair):
    _, port = pair
    with Server(None) as s:
        status, _, raw = s.post("/v1/images/generations", {"prompt": "x"})
        assert status == 503 and b"no image model" in raw
    with Server(port) as s:
        s.app.state.draining = True
        status, hdrs, _ = s.post("/api/v1/image", {"prompt": "x"})
        assert status == 503 and hdrs["Retry-After"] == "5"


def test_tenant_quota_answers_429(pair):
    _, port = pair
    plane = AdmissionPlane(TenantRegistry("t1:rps=0.001,burst=1"))
    with Server(port, plane=plane) as s:
        h = {"X-Cake-Tenant": "t1"}
        body = {"prompt": "x", "size": "16x16", "steps": 1}
        assert s.post("/v1/images/generations", body, h)[0] == 200
        status, hdrs, raw = s.post("/v1/images/generations", body, h)
        assert status == 429 and json.loads(raw)["type"] == "tenant_quota"
        assert "Retry-After" in hdrs
        assert s.post("/v1/images/generations", body,
                      {"X-Cake-Tenant": "t2"})[0] == 200


class _Slow:
    """Steps of 20 ms that report through on_step; records how many ran
    and whether the server's lock was held."""

    def __init__(self, lock=None):
        self.steps_run = 0
        self.lock = lock
        self.lock_held = None
        self.started = threading.Event()

    def generate_image(self, prompt, width, height, steps, guidance=None,
                       seed=None, negative_prompt=None, on_step=None):
        if self.lock is not None:
            self.lock_held = self.lock.locked()
        self.started.set()
        for i in range(steps):
            time.sleep(0.02)
            self.steps_run += 1
            on_step(i + 1, steps)
        return RgbImage(np.zeros((height, width, 3), np.uint8))


def test_client_disconnect_cancels_the_job():
    slow = _Slow()
    with Server(slow) as s:
        host, port = s.app.server_address[:2]
        body = json.dumps({"prompt": "x", "size": "16x16",
                           "steps": 500}).encode()
        sock = socket.create_connection((host, port))
        sock.sendall(b"POST /v1/images/generations HTTP/1.1\r\n"
                     b"Host: x\r\nContent-Type: application/json\r\n"
                     b"X-Cake-Request-Id: img-gone\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        assert slow.started.wait(30)
        sock.close()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            kinds = [(e["kind"], e.get("type")) for e in
                     _events(s, "img-gone")]
            if ("error", "cancelled") in kinds:
                break
            time.sleep(0.05)
        assert ("error", "cancelled") in kinds
        assert slow.steps_run < 500
        assert not any(k == "finish" for k, _ in kinds)


def test_lock_rule_of_the_locked_path():
    """With no engine and a text model, a job holds the server's lock;
    with no text model it does not."""
    app_lock = threading.Lock()
    slow = _Slow(lock=app_lock)
    with Server(slow, model=object()) as s:
        s.app.state.lock = app_lock
        assert s.post("/v1/images/generations", {
            "prompt": "x", "size": "16x16", "steps": 1})[0] == 200
        assert slow.lock_held is True
    slow = _Slow(lock=app_lock)
    with Server(slow) as s:
        s.app.state.lock = app_lock
        assert s.post("/v1/images/generations", {
            "prompt": "x", "size": "16x16", "steps": 1})[0] == 200
        assert slow.lock_held is False


def test_executor_drain_and_cancel():
    ex = JobExecutor(workers=1, max_queue=4)
    gate = threading.Event()
    done = []

    def blocked(job):
        gate.wait(10)
        done.append(job.id)
        return "ok"
    first = ex.submit(GenerationJob("image", blocked, request_id="d1"))
    queued = ex.submit(GenerationJob("image", blocked, request_id="d2"))
    assert first.admitted.wait(10)
    ex.begin_drain()
    with pytest.raises(JobsDraining):
        ex.submit(GenerationJob("image", blocked))
    assert ex.drain(timeout=0.1) is False
    gate.set()
    assert ex.drain(timeout=10) is True
    assert first.result["value"] == queued.result["value"] == "ok"
    assert done == ["d1", "d2"]
    ex.close()

    ex = JobExecutor(workers=1)
    job = GenerationJob("image", lambda j: [j.checkpoint()
                                            for _ in iter(int, 1)])
    job.cancel()
    with pytest.raises(JobCancelled):
        job.checkpoint()
    ex.submit(job)
    assert job.wait(10) and isinstance(job.result["error"], JobCancelled)
    late = GenerationJob("image", lambda j: 1)
    calls = []
    late.add_done_callback(lambda: calls.append(1))
    ex.submit(late)
    assert late.wait(10) and late.result["value"] == 1
    late.add_done_callback(lambda: calls.append(2))
    assert calls == [1, 2]
    ex.close()
    assert TIMELINES.get(job.id) is not None
