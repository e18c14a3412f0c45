"""SD on the port's image routes (api/images.py), against the reference's
pipeline called directly: img2img from `init_image_b64` (an RGBA PNG with
filtered rows; `strength`) answers the reference's pixels (equal, or one
level apart on under 1%); a broken image, a JPEG and broken base64 answer
400 `bad init_image_b64: ...`; a small PNG whose header claims a huge
image answers 400 from its header, never inflated, and a good one is
decoded in the job, not in the handler; FLUX keeps its img2img 400; a
decoder-only
SD answers 400 from inside the job; the operator's intermediate images
and profiler trace (`create_app(sd_intermediate_every=, sd_trace_dir=)`,
`cli serve --sd-intermediate-every --sd-trace-dir`) are written, and a
request body cannot ask for either."""
import base64
import gc
import glob
import io
import json
import os
import re
import struct
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cake_tpu.models.image import sd as jsd
from cake_tpu.models.image import vae as jvae
from cake_tpu_torch import cli
from cake_tpu_torch.api import images
from cake_tpu_torch.obs.profile import kernel_split
from cake_tpu_torch.models.image import flux as tflux
from cake_tpu_torch.models.image import sd as tsd
from cake_tpu_torch.utils.png import SIGNATURE
from cake_tpu_torch.utils.weights import sd_params_from_numpy
from test_torch_image_api import Server, _near, _pixels

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _collect_reference_models():
    yield
    gc.collect()


class _Enc:
    def __init__(self, ctx, wrap):
        self.ctx, self.wrap = ctx, wrap

    def __call__(self, prompt):
        return self.wrap(self.ctx[prompt]), self.wrap(np.zeros((1, 1),
                                                               np.float32))


class _JaxNoise:
    """The port's SD pipeline with the reference's noise for a seed."""

    def __init__(self, model):
        self.model = model

    def init_latent_from(self, img, width, height):
        return self.model.init_latent_from(img, width, height)

    def generate_image(self, prompt, **kw):
        lh, lw = tsd.latent_size(self.model.cfg, kw["width"], kw["height"])
        seed = kw.get("seed")
        noise = jax.random.normal(
            jax.random.PRNGKey(seed if seed is not None else 0),
            (1, 4, lh, lw), jnp.float32)
        return self.model.generate_image(
            prompt, noise=torch.from_numpy(np.asarray(noise)), **kw)


@pytest.fixture(scope="module")
def pair():
    cfg = jsd.tiny_sd_config()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(12), 3)
    params = {"unet": jsd.init_unet_params(cfg.unet, k1),
              "vae": jvae.init_vae_decoder_params(cfg.vae, k2),
              "vae_enc": jvae.init_vae_encoder_params(cfg.vae, k3)}
    rng = np.random.default_rng(3)
    ctx = {p: rng.standard_normal((1, 5, 32)).astype(np.float32)
           for p in ("a fox", "", "blurry")}
    ref = jsd.SDImageModel(cfg, params, _Enc(ctx, jnp.asarray))
    port = tsd.SDImageModel(
        cfg, sd_params_from_numpy(jax.tree.map(np.asarray, params), "cpu",
                                  torch.float32),
        _Enc(ctx, torch.from_numpy), device="cpu")
    return ref, port


def _rgba_png(h=40, w=28, seed=5) -> bytes:
    rgba = np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                                dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, "PNG", optimize=True)
    return buf.getvalue()


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def test_img2img_equals_the_reference(pair):
    ref, port = pair
    png = _rgba_png()
    z = ref.init_latent_from(Image.open(io.BytesIO(png)), 32, 24)
    want = np.asarray(ref.generate_image("a fox", 32, 24, 4, seed=3,
                                         init_image=z, strength=0.6,
                                         guidance=5.0))
    with Server(_JaxNoise(port)) as s:
        status, _, raw = s.post("/v1/images/generations", {
            "prompt": "a fox", "size": "32x24", "steps": 4, "seed": 3,
            "guidance": 5.0, "init_image_b64": _b64(png), "strength": 0.6})
        assert status == 200, raw
        got = _pixels(base64.b64decode(json.loads(raw)["data"][0]
                                       ["b64_json"]))
        _near(got, want)
        # the default strength, 0.8, starts at the reference's step
        status, _, raw = s.post("/api/v1/image", {
            "prompt": "a fox", "size": "32x24", "steps": 10, "seed": 3,
            "init_image_b64": _b64(png)})
        assert status == 200
        assert port.stats["steps"] == 10 - int(10 * (1.0 - 0.8)) == 9


def test_bad_init_images_answer_400(pair):
    _, port = pair
    jpeg = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpeg, "JPEG")
    with Server(port) as s:
        for init, match in ((_b64(b"not a picture"), "not a PNG"),
                            (_b64(jpeg.getvalue()), "JPEG"),
                            ("@@@@", "bad init_image_b64"),
                            (_b64(_rgba_png()[:-30]), "CRC|truncated")):
            status, _, raw = s.post("/v1/images/generations", {
                "prompt": "a fox", "size": "16x16", "steps": 1,
                "init_image_b64": init})
            err = json.loads(raw)["error"]
            assert status == 400 and err.startswith("bad init_image_b64")
            assert re.search(match, err), err
        status, _, raw = s.post("/v1/images/generations", {
            "prompt": "a fox", "size": "16x16", "steps": 1,
            "init_image_b64": _b64(_rgba_png()), "strength": "lots"})
        assert status == 400 and b"invalid parameters" in raw


def _bomb_png(side: int) -> bytes:
    """An RGBA PNG of side x side whose zero rows deflate from a few
    hundred KB to 4 * side**2 bytes."""
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    z = zlib.compressobj(9)
    row = bytes(side * 4 + 1)
    idat = b"".join(z.compress(row) for _ in range(side)) + z.flush()
    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", side, side,
                                                   8, 6, 0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def test_init_png_is_sized_by_its_header_and_decoded_in_the_job(
        pair, monkeypatch):
    _, port = pair
    threads = {"decode": [], "handler": []}
    decode, resolve = images.decode_png, images.resolve_admission

    def counted_decode(data):
        threads["decode"].append(threading.get_ident())
        return decode(data)

    def counted_resolve(handler, *args):
        threads["handler"].append(threading.get_ident())
        return resolve(handler, *args)
    monkeypatch.setattr(images, "decode_png", counted_decode)
    monkeypatch.setattr(images, "resolve_admission", counted_resolve)
    bomb = _bomb_png(6000)             # 144 MB of rows, past 2 x 2048
    assert len(bomb) < 200_000
    with Server(port) as s:
        status, _, raw = s.post("/v1/images/generations", {
            "prompt": "a fox", "size": "16x16", "steps": 1,
            "init_image_b64": _b64(bomb)})
        err = json.loads(raw)["error"]
        assert status == 400 and err.startswith("bad init_image_b64")
        assert "6000 x 6000" in err and "4096 a side" in err
        assert threads == {"decode": [], "handler": []}
        monkeypatch.setenv("CAKE_IMAGE_MAX_SIZE", "16")
        status, _, raw = s.post("/v1/images/generations", {
            "prompt": "a fox", "size": "16x16", "steps": 1,
            "init_image_b64": _b64(_rgba_png())})       # 28 x 40
        assert status == 400 and b"at most 32 a side" in raw
        monkeypatch.delenv("CAKE_IMAGE_MAX_SIZE")
        assert threads["decode"] == []
        status, _, _ = s.post("/v1/images/generations", {
            "prompt": "a fox", "size": "16x16", "steps": 1,
            "init_image_b64": _b64(_rgba_png())})
    assert status == 200 and len(threads["decode"]) == 1
    assert threads["decode"][0] not in threads["handler"]


def test_flux_keeps_its_400_and_decoder_only_sd_answers_400(pair):
    _, port = pair
    flux = tflux.FluxImageModel(tflux.tiny_flux_config(), device="cpu")
    with Server(flux) as s:
        status, _, raw = s.post("/v1/images/generations", {
            "prompt": "x", "size": "16x16", "init_image_b64": _b64(
                _rgba_png())})
        assert status == 400 and b"img2img is SD-only" in raw
    bare = tsd.SDImageModel(port.cfg, {k: v for k, v in port.params.items()
                                       if k != "vae_enc"},
                            port.text_encoder, device="cpu")
    with Server(bare) as s:
        status, _, raw = s.post("/v1/images/generations", {
            "prompt": "a fox", "size": "16x16", "steps": 1,
            "init_image_b64": _b64(_rgba_png())})
        assert status == 400 and b"no VAE encoder" in raw


def test_operator_intermediates_and_trace(pair, tmp_path, monkeypatch):
    _, port = pair
    monkeypatch.chdir(tmp_path)
    body = {"prompt": "a fox", "size": "16x16", "steps": 3, "seed": 1,
            # a body cannot ask for either
            "intermediate_every": 1, "trace_dir": str(tmp_path / "body")}
    with Server(port) as s:
        status, _, _ = s.post("/v1/images/generations", body)
    assert status == 200 and os.listdir(tmp_path) == []
    trace = str(tmp_path / "trace")
    app = cli.build_server(cli.parser().parse_args(
        ["serve", "--flagship", "--layers", "1", "--cpu", "--dtype", "f32",
         "--port", "0", "--slots", "0", "--image-model", "demo:sd",
         "--sd-intermediate-every", "1", "--sd-trace-dir", trace])).start()
    try:
        assert app.state.sd_intermediate_every == 1
        app.state.image_model = port
        s = Server.__new__(Server)
        s.url = app.url
        status, _, raw = s.post("/api/v1/image", body)
    finally:
        app.stop(drain_s=5)
    assert status == 200
    names = sorted(p.name for p in tmp_path.glob("sd_intermediate_*.png"))
    assert names == ["sd_intermediate_1.png", "sd_intermediate_2.png"]
    assert _pixels((tmp_path / names[0]).read_bytes()).shape == (16, 16, 3)
    files = glob.glob(os.path.join(trace, "*.json"))
    assert len(files) == 1 and not (tmp_path / "body").exists()
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    # the three steps' ranges are in the trace; the CPU launches no kernel
    split = kernel_split(events, "sd.unet_step")
    assert split["ranges"] == 3 and split["total"] == 0.0
    assert sum(e.get("name") == "sd.attention" for e in events) >= 3


def test_kernel_split_classes_kernels_by_what_launched_them():
    def ev(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "pid": 1, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    launch = "cudaLaunchKernel"
    events = [
        ev("user_annotation", "sd.unet_step", 0, 100),
        ev("user_annotation", "sd.attention", 10, 20),
        ev("cpu_op", "aten::einsum", 11, 5),
        ev("cpu_op", "aten::bmm", 12, 3),
        ev("cuda_runtime", launch, 13, 1, corr=1),     # attention
        ev("cpu_op", "aten::div_", 20, 2),
        ev("cuda_runtime", launch, 21, 1, corr=2),     # attention
        ev("cpu_op", "aten::conv2d", 40, 10),
        ev("cpu_op", "aten::convolution", 41, 8),
        ev("cuda_driver", "cuLaunchKernel", 42, 1, corr=3),   # conv
        ev("cpu_op", "aten::linear", 55, 5),
        ev("cpu_op", "aten::addmm", 56, 3),
        ev("cuda_runtime", launch, 57, 1, corr=4),     # gemm
        ev("cpu_op", "aten::mean", 62, 3),
        ev("cuda_runtime", launch, 63, 1, corr=5),     # other
        ev("cpu_op", "aten::add", 70, 3),
        ev("cuda_runtime", launch, 71, 1, corr=6),     # other
        ev("cpu_op", "aten::add", 200, 3),
        ev("cuda_runtime", launch, 201, 1, corr=7),    # outside the step
        ev("cuda_runtime", launch, 80, 1, tid=2, corr=8),  # another thread
    ]
    for corr, dur in zip(range(1, 9), (1000, 2000, 3000, 4000, 500, 250,
                                       7000, 9000)):
        events.append(ev("kernel", f"k{corr}", 1000 + corr, dur, tid=7,
                         corr=corr))
    split = kernel_split(events, "sd.unet_step")
    assert split == {"attention": 3.0, "conv": 3.0, "gemm": 4.0,
                     "other": 0.75, "total": 10.75, "ranges": 1}
