"""The port stands alone: with `jax` and `cake_tpu` blocked, and the
packages the card's machine lacks (`tokenizers`, `transformers`,
`safetensors`, `regex`, `ml_dtypes`, `huggingface_hub`, `PIL`,
`sentencepiece`) blocked too,
every module of cake_tpu_torch and chip_smoke.py imports (the metrics
plane, obs/, the admission plane, serve/admission/, api/qos.py and
api/obs_routes.py, and speculative decoding, spec/, among them), a tiny CPU chat is served by a contiguous
engine and by a paged one, each also answering a batch-class chat under
an adopted request id with its timeline, /metrics and /api/v1/trace,
and a chat is served
by `cli serve` from a checkpoint directory with a tokenizer.json and a
chat template (byte-level BPE for an OLMo2 and, streamed, a Gemma-style
byte-fallback BPE for a Gemma3), and tiny FP8 (kept native), AutoGPTQ
and GGUF checkpoints load through build_text_model and decode; an AST
scan finds no import of any of them in the port's sources. The cluster
(module 13a) runs there too, with `msgpack` and `yaml` blocked besides
(the port has its own msgpack codec and YAML reader) and `zstandard`
blocked (the port imports it only behind the reference's gate, which the
scan checks): a port worker on a thread and a `cli serve --cluster-key
--topology` master answer a chat. FLUX.1 (module 14a) runs there too: `cli
serve --image-model demo:flux` answers /v1/images/generations with a PNG
the port's own decoder reads, and a FLUX.1 bundle written by
bench/synth_flux.py loads native FP8 through build_image_model and
generates. SD (module 14b) runs there too: `cli serve --image-model DIR`
of a tiny SDXL directory with vocab.json + merges.txt tokenizers
(bench/synth_sd.py) answers an img2img request from a PNG. FLUX.2
(module 14c) and VibeVoice (module 14d) run there too: directories
written by bench/synth_flux2.py and bench/synth_vibevoice.py, with
byte-level BPE tokenizers read by utils/bpe.py, are served by `cli serve
--image-model DIR --audio-model DIR --voices-dir V` (an image, WAV and
PCM speech, a named voice), and `cli tts DIR` writes a WAV. LuxTTS
(module 14d's remainder) runs there too: a directory written by
bench/synth_luxtts.py is served by `cli serve --audio-model DIR` (WAV,
PCM and a voice_b64 clone) and spoken by `cli tts DIR`, and the modality
map (models/registry.py) imports. The fleet router (module 15a) runs
there too, with `aiohttp` blocked besides (the port depends on none):
`cli route` fronts a `cli serve` engine and answers a chat. And the
router tier stands apart from torch itself: with `torch` blocked as well,
`cake_tpu_torch.fleet` imports, a router serves its views, and `cli
route --help` / `cli top --help` run."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "cake_tpu", "tokenizers", "transformers",
           "safetensors", "regex", "ml_dtypes", "huggingface_hub",
           "msgpack", "yaml", "PIL", "sentencepiece", "aiohttp")
# optional packages the port may import only inside a try (the
# reference's gate), blocked in the run all the same
GATED = ("zstandard",)
PORT_FILES = sorted((ROOT / "cake_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

BLOCKED_RUN = r'''
import importlib, importlib.abc, json, pkgutil, sys, tempfile
import urllib.request
BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())

import torch
torch.set_num_threads(1)
import cake_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(cake_tpu_torch.__path__,
                                              "cake_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
for name in ("cake_tpu_torch.obs", "cake_tpu_torch.obs.metrics",
             "cake_tpu_torch.obs.spans", "cake_tpu_torch.obs.timeline",
             "cake_tpu_torch.obs.timing", "cake_tpu_torch.serve.admission",
             "cake_tpu_torch.serve.admission.plane",
             "cake_tpu_torch.serve.admission.queue",
             "cake_tpu_torch.serve.admission.tenants",
             "cake_tpu_torch.api.qos", "cake_tpu_torch.api.obs_routes",
             "cake_tpu_torch.spec", "cake_tpu_torch.spec.drafter",
             "cake_tpu_torch.spec.verify", "cake_tpu_torch.ops.fp8",
             "cake_tpu_torch.utils.quant", "cake_tpu_torch.utils.gguf",
             "cake_tpu_torch.models.common.expert_provider",
             "cake_tpu_torch.models.common.offload_model",
             "cake_tpu_torch.api.state", "cake_tpu_torch.utils.dtypes",
             "cake_tpu_torch.cluster", "cake_tpu_torch.cluster.codec",
             "cake_tpu_torch.cluster.proto", "cake_tpu_torch.cluster.auth",
             "cake_tpu_torch.cluster.topology",
             "cake_tpu_torch.cluster.strategy",
             "cake_tpu_torch.cluster.discovery",
             "cake_tpu_torch.cluster.transfer",
             "cake_tpu_torch.cluster.client",
             "cake_tpu_torch.cluster.worker",
             "cake_tpu_torch.cluster.master",
             "cake_tpu_torch.cluster.faults", "cake_tpu_torch.ops.conv",
             "cake_tpu_torch.ops.diffusion",
             "cake_tpu_torch.models.text_encoders",
             "cake_tpu_torch.models.text_encoders.clip",
             "cake_tpu_torch.models.text_encoders.t5",
             "cake_tpu_torch.models.image",
             "cake_tpu_torch.models.image.mmdit",
             "cake_tpu_torch.models.image.vae",
             "cake_tpu_torch.models.image.flux",
             "cake_tpu_torch.models.image.flux_loader",
             "cake_tpu_torch.utils.mapping", "cake_tpu_torch.utils.init",
             "cake_tpu_torch.utils.png",
             "cake_tpu_torch.serve.admission.jobs",
             "cake_tpu_torch.api.images", "cake_tpu_torch.bench.synth_flux",
             "cake_tpu_torch.models.image.sd",
             "cake_tpu_torch.models.image.sd_loader",
             "cake_tpu_torch.bench.synth_sd", "cake_tpu_torch.obs.profile",
             "cake_tpu_torch.models.image.flux2",
             "cake_tpu_torch.models.image.flux2_loader",
             "cake_tpu_torch.bench.synth_flux2",
             "cake_tpu_torch.models.audio",
             "cake_tpu_torch.models.audio.vibevoice",
             "cake_tpu_torch.models.audio.vibevoice_loader",
             "cake_tpu_torch.bench.synth_vibevoice",
             "cake_tpu_torch.models.audio.luxtts",
             "cake_tpu_torch.models.audio.luxtts_loader",
             "cake_tpu_torch.bench.synth_luxtts",
             "cake_tpu_torch.models.registry",
             "cake_tpu_torch.api.audio", "cake_tpu_torch.utils.wav",
             "cake_tpu_torch.obs.series", "cake_tpu_torch.fleet",
             "cake_tpu_torch.fleet.routing", "cake_tpu_torch.fleet.registry",
             "cake_tpu_torch.fleet.faults", "cake_tpu_torch.fleet.telemetry",
             "cake_tpu_torch.fleet.router", "cake_tpu_torch.fleet.top",
             "cake_tpu_torch.fleet.http", "cake_tpu_torch.fleet.knobs"):
    assert name in mods, name
import chip_smoke

from cake_tpu_torch.api import create_app
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.serve import ServeEngine
from cake_tpu_torch.tokenizer import ByteTokenizer
cfg = tiny_config("qwen3", vocab_size=258, max_position_embeddings=256)
tok = ByteTokenizer(256, 257)
model = TextModel(cfg, tokenizer=tok, dtype=torch.float32, device="cpu")
body = {"messages": [{"role": "user", "content": "hi"}],
        "temperature": 0, "max_tokens": 4}
for kw in ({}, {"kv_blocks": 32}):
    app = create_app(model, ServeEngine(model, slots=2, ctx_len=256, **kw),
                     tok, port=0).start()
    req = urllib.request.Request(app.url + "/v1/chat/completions",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        resp = json.loads(r.read())
    # the admission and metrics planes: a batch-class chat under an
    # adopted request id, its timeline, /metrics, the span recorder
    from cake_tpu_torch import obs
    obs.RECORDER.enable()
    rid = "iso-" + str(len(kw))
    req = urllib.request.Request(
        app.url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"X-Cake-QoS": "batch", "X-Cake-Request-Id": rid})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["X-Cake-Request-Id"] == rid
    with urllib.request.urlopen(app.url + "/api/v1/requests/" + rid,
                                timeout=60) as r:
        kinds = [e["kind"] for e in json.loads(r.read())["events"]]
    assert kinds[0] == "received" and kinds[-1] == "finish", kinds
    with urllib.request.urlopen(app.url + "/metrics", timeout=60) as r:
        assert b'cake_serve_qos_e2e_seconds_count{qos="batch"' in r.read()
    with urllib.request.urlopen(app.url + "/api/v1/trace", timeout=60) as r:
        assert b"serve.prefill_chunk" in r.read()
    app.stop()
    assert resp["usage"]["completion_tokens"] > 0, resp

# a checkpoint directory with a tokenizer.json and a chat template
from cake_tpu_torch import cli
from cake_tpu_torch.bench import synth_checkpoint as sc
d = tempfile.mkdtemp() + "/tiny-ckpt"
config = dict(architectures=["Olmo2ForCausalLM"], vocab_size=700,
              hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=256, eos_token_id=698)
sc.write_model(d, config, sc.model_params(config, 1, torch.float32))
sc.write_tokenizer(d, {"<|im_start|>": 697, "<|im_end|>": 698},
                   n_merges=100)
app = cli.build_server(cli.parser().parse_args(
    ["serve", d, "--cpu", "--dtype", "f32", "--port", "0", "--ctx", "256",
     "--kv-blocks", "32"])).start()
req = urllib.request.Request(app.url + "/v1/chat/completions",
                             data=json.dumps(body).encode())
with urllib.request.urlopen(req, timeout=60) as r:
    resp = json.loads(r.read())
app.stop()
assert resp["model"] == "tiny-ckpt", resp
assert resp["usage"]["completion_tokens"] > 0, resp

# a tiny Gemma3 with the Gemma-style byte-fallback tokenizer, paged
g = tempfile.mkdtemp() + "/tiny-gemma3"
config = dict(sc.FAMILIES["gemma3"], vocab_size=1024, hidden_size=64,
              intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=1, head_dim=256,
              sliding_window=16, sliding_window_pattern=2,
              max_position_embeddings=256)
sc.write_model(g, config, sc.model_params(config, 1, torch.float32, "cpu",
                                          randomize_norms=True))
sc.write_gemma_tokenizer(g, vocab_size=1024)
app = cli.build_server(cli.parser().parse_args(
    ["serve", g, "--cpu", "--dtype", "f32", "--port", "0", "--ctx", "256",
     "--kv-blocks", "32"])).start()
req = urllib.request.Request(app.url + "/v1/chat/completions",
                             data=json.dumps({**body, "stream": True}).encode())
with urllib.request.urlopen(req, timeout=60) as r:
    events = r.read().decode()
app.stop()
assert events.rstrip().endswith("data: [DONE]"), events
# quantized checkpoints: FP8 (kept native), AutoGPTQ 4-bit and GGUF
from cake_tpu_torch.runtime import build_text_model
q = dict(architectures=["Qwen3ForCausalLM"], vocab_size=256,
         hidden_size=256, intermediate_size=512, num_hidden_layers=1,
         num_attention_heads=4, num_key_value_heads=2, head_dim=64,
         max_position_embeddings=256, eos_token_id=2)
for kind in ("fp8", "gptq", "gguf"):
    qd = tempfile.mkdtemp() + "/" + kind
    if kind == "fp8":
        sc.write_fp8_model(qd, q, sc.model_params(q, 1, torch.float32))
    elif kind == "gptq":
        sc.write_gptq_model(qd, q, sc.model_params(q, 1, torch.float32))
    else:
        sc.write_gguf_model(qd, q, mix="q4_k_m")
    m, _, _ = build_text_model(qd, "f32", device="cpu",
                               fp8_native=kind == "fp8")
    assert m.generate([5, 6, 7], 3)[0], kind
# an MoE checkpoint with its experts offloaded, served by `cli serve
# --expert-offload` on the locked path (JSON and SSE)
md = tempfile.mkdtemp() + "/moe"
moe = dict(q, architectures=["Qwen3MoeForCausalLM"], vocab_size=700,
           eos_token_id=698, num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=64)
sc.write_model(md, moe, sc.model_params(moe, 1, torch.float32))
sc.write_tokenizer(md, {"<|im_start|>": 697, "<|im_end|>": 698},
                   n_merges=100)
app = cli.build_server(cli.parser().parse_args(
    ["serve", md, "--cpu", "--dtype", "f32", "--port", "0", "--ctx", "256",
     "--expert-offload"])).start()
assert app.state.engine is None
for stream in (False, True):
    req = urllib.request.Request(app.url + "/v1/chat/completions",
                                 data=json.dumps({**body,
                                                  "stream": stream}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200 and r.read()
app.stop()
# the cluster: a port worker on a thread, a `cli serve` master over a
# topology file, one chat; weights streamed uncompressed (no zstandard)
import asyncio, threading
from cake_tpu_torch.cluster import transfer
from cake_tpu_torch.cluster.worker import WorkerServer
assert transfer.zstandard is None
held, ready = {}, threading.Event()
def run_worker():
    async def main():
        held["w"] = await WorkerServer("w0", "iso", port=0, advertise=False,
                                       cache_root=tempfile.mkdtemp(),
                                       device="cpu").start()
        ready.set()
        await held["w"].serve_forever()
    try:
        asyncio.run(main())
    except Exception:
        pass
threading.Thread(target=run_worker, daemon=True).start()
assert ready.wait(30)
topo = tempfile.mkdtemp() + "/topo.yml"
with open(topo, "w") as f:
    f.write("w0:\n  host: 127.0.0.1:%%d\n  layers: [\"model.layers.1\"]\n"
            %% held["w"].port)
app = cli.build_server(cli.parser().parse_args(
    ["serve", d, "--cpu", "--dtype", "f32", "--port", "0", "--ctx", "256",
     "--cluster-key", "iso", "--topology", topo])).start()
req = urllib.request.Request(app.url + "/v1/chat/completions",
                             data=json.dumps(body).encode())
with urllib.request.urlopen(req, timeout=60) as r:
    assert r.status == 200 and json.loads(r.read())["usage"]
with urllib.request.urlopen(app.url + "/api/v1/topology", timeout=60) as r:
    assert json.loads(r.read())["nodes"]["w0"]["layer_range"] == [1, 2]
app.stop()
app.state.model.close()
assert held["w"].stats["ops"] > 0
# FLUX.1: `cli serve --image-model demo:flux` answers an image, and a
# written FLUX.1 bundle loads native FP8 and generates
import base64
from cake_tpu_torch.utils.png import decode_png
app = cli.build_server(cli.parser().parse_args(
    ["serve", "--flagship", "--layers", "1", "--cpu", "--dtype", "f32",
     "--port", "0", "--slots", "0", "--image-model", "demo:flux"])).start()
req = urllib.request.Request(
    app.url + "/v1/images/generations",
    data=json.dumps({"prompt": "a fox", "size": "24x16",
                     "steps": 2}).encode())
with urllib.request.urlopen(req, timeout=60) as r:
    png = base64.b64decode(json.loads(r.read())["data"][0]["b64_json"])
app.stop()
assert decode_png(png).shape == (16, 24, 3)
from cake_tpu_torch.bench.synth_flux import write_flux_checkpoint
from cake_tpu_torch.models.image import seeded_flux1, tiny_flux_config
from cake_tpu_torch.models.text_encoders import (tiny_clip_config,
                                                 tiny_t5_config)
from cake_tpu_torch.runtime import build_image_model
pipe = tiny_flux_config()
fcfgs = dict(mmdit=pipe.mmdit, vae=pipe.vae, clip=tiny_clip_config(),
             t5=tiny_t5_config())
seeded = seeded_flux1(fcfgs, torch.float32, "cpu", seed=2)
fd = tempfile.mkdtemp() + "/flux1"
write_flux_checkpoint(fd, fcfgs, {"transformer": seeded.params["transformer"],
                                  "vae": seeded.params["vae"],
                                  **seeded.text_encoder.params},
                      layout="split", fp8="plain")
flux = build_image_model(fd, "f32", fp8_native=True, device="cpu")
assert flux.generate_image("w1 w2", 16, 16, steps=1).size == (16, 16)
# SD (module 14b): a tiny SDXL directory with vocab.json + merges.txt
# tokenizers, served by `cli serve --image-model DIR`: img2img from a PNG
import numpy as np
from cake_tpu_torch.bench import synth_sd
from cake_tpu_torch.utils.png import encode_png
fam = synth_sd.tiny_family("sdxl")
sdd = tempfile.mkdtemp() + "/sdxl"
synth_sd.write_sd_checkpoint(sdd, fam, synth_sd.seeded_sd(
    fam, torch.float32, "cpu"))
app = cli.build_server(cli.parser().parse_args(
    ["serve", "--flagship", "--layers", "1", "--cpu", "--dtype", "f32",
     "--port", "0", "--slots", "0", "--image-model", sdd])).start()
init = base64.b64encode(encode_png(np.full((20, 24, 3), 90, np.uint8)))
req = urllib.request.Request(
    app.url + "/v1/images/generations",
    data=json.dumps({"prompt": "a fox", "size": "32x32", "steps": 2,
                     "init_image_b64": init.decode()}).encode())
with urllib.request.urlopen(req, timeout=60) as r:
    png = base64.b64decode(json.loads(r.read())["data"][0]["b64_json"])
app.stop()
assert type(app.state.image_model).__name__ == "SDXLImageModel"
assert decode_png(png).shape == (32, 32, 3)
# FLUX.2 (module 14c) and VibeVoice (module 14d): directories written by
# bench/synth_flux2.py and bench/synth_vibevoice.py (byte-level BPE
# tokenizers with Qwen's specials) served by `cli serve --image-model DIR
# --audio-model DIR --voices-dir V`: an image, a WAV, a PCM answer and a
# named voice; `cli tts DIR` writes a WAV
from cake_tpu_torch.bench.synth_flux2 import write_flux2_checkpoint
from cake_tpu_torch.bench.synth_vibevoice import (write_vibevoice_checkpoint,
                                                  write_voice_prompt)
from cake_tpu_torch.models.audio import VibeVoiceTTS, tiny_tts_config
from cake_tpu_torch.models.image import seeded_flux2, tiny_flux2_config
from cake_tpu_torch.utils.wav import decode_wav
import dataclasses
fp = tiny_flux2_config()
f2d = tempfile.mkdtemp() + "/flux2"
write_flux2_checkpoint(f2d, seeded_flux2(
    {"flux2": fp.transformer, "vae": fp.vae, "output_layers": (0, 1, 2),
     "encoder": dict(architectures=["Qwen3ForCausalLM"], vocab_size=1024,
                     hidden_size=32, intermediate_size=64,
                     num_hidden_layers=3, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=128)},
    torch.float32, "cpu", max_txt_len=16))
vc = tiny_tts_config()
vc = dataclasses.replace(
    vc, lm_base=dataclasses.replace(vc.lm_base, vocab_size=1024),
    lm_tts=dataclasses.replace(vc.lm_tts, vocab_size=1024))
vvd = tempfile.mkdtemp() + "/vibevoice"
write_vibevoice_checkpoint(vvd, VibeVoiceTTS(vc, dtype=torch.float32,
                                             device="cpu"))
voices = tempfile.mkdtemp()
write_voice_prompt(voices + "/alice.safetensors", vc, seq=3)
app = cli.build_server(cli.parser().parse_args(
    ["serve", "--flagship", "--layers", "1", "--cpu", "--dtype", "f32",
     "--port", "0", "--slots", "0", "--image-model", f2d, "--audio-model",
     vvd, "--voices-dir", voices])).start()
req = urllib.request.Request(
    app.url + "/v1/images/generations",
    data=json.dumps({"prompt": "a fox", "size": "32x32", "steps": 2}).encode())
with urllib.request.urlopen(req, timeout=60) as r:
    png = base64.b64decode(json.loads(r.read())["data"][0]["b64_json"])
assert decode_png(png).shape == (32, 32, 3)
assert type(app.state.image_model).__name__ == "Flux2ImageModel"
for fmt, voice in (("wav", None), ("pcm", None), ("wav", "alice")):
    req = urllib.request.Request(
        app.url + "/v1/audio/speech",
        data=json.dumps({"input": "hello there", "response_format": fmt,
                         "voice": voice, "steps": 2}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        audio = r.read()
        assert r.headers["Content-Type"] == ("audio/wav" if fmt == "wav"
                                             else "application/octet-stream")
    if fmt == "wav":
        assert len(decode_wav(audio)[0]) %% 16 == 0
app.stop()
wav_out = tempfile.mkdtemp() + "/speech.wav"
assert cli.main(["tts", vvd, "hi", "--out", wav_out, "--frames", "2",
                 "--cpu", "--dtype", "f32"]) == 0
assert decode_wav(open(wav_out, "rb").read())[1] == 24000
# LuxTTS (module 14d's remainder): a directory written by
# bench/synth_luxtts.py served by `cli serve --audio-model DIR` (a WAV, a
# PCM answer and a voice_b64 clone), `cli tts DIR` and demo:luxtts
from cake_tpu_torch.bench.synth_luxtts import write_luxtts_checkpoint
from cake_tpu_torch.models.audio import LuxTTS, tiny_luxtts_config
from cake_tpu_torch.models.registry import AUDIO_ARCHS, modality_for_arch
from cake_tpu_torch.utils.wav import encode_wav
luxd = tempfile.mkdtemp() + "/luxtts"
write_luxtts_checkpoint(luxd, LuxTTS(tiny_luxtts_config(), device="cpu"))
app = cli.build_server(cli.parser().parse_args(
    ["serve", "--flagship", "--layers", "1", "--cpu", "--dtype", "f32",
     "--port", "0", "--slots", "0", "--audio-model", luxd])).start()
clip = base64.b64encode(encode_wav(np.zeros(800, np.float32), 16000))
answers = {}
for fmt, extra in (("wav", {}), ("pcm", {}), ("wav", {"voice_b64":
                                                    clip.decode()})):
    req = urllib.request.Request(
        app.url + "/v1/audio/speech",
        data=json.dumps({"input": "hello there", "response_format": fmt,
                         "steps": 2, **extra}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        answers[fmt, bool(extra)] = r.read()
app.stop()
assert type(app.state.audio_model).__name__ == "LuxTTS"
assert decode_wav(answers["wav", False])[1] == 48000
assert answers["pcm", False] == answers["wav", False][44:]
assert decode_wav(answers["wav", True])[1] == 48000
assert cli.main(["tts", luxd, "hi", "--out", wav_out, "--steps", "2",
                 "--cpu", "--dtype", "f32"]) == 0
assert decode_wav(open(wav_out, "rb").read())[1] == 48000
assert cli.main(["tts", "demo:luxtts", "hi", "--out", wav_out, "--steps",
                 "1", "--cpu", "--dtype", "f32"]) == 0
assert modality_for_arch(next(iter(AUDIO_ARCHS))) == "audio"
# the fleet router (modules 15a and 15b) in front of a paged `cli serve`
# engine with the KV-share tier on: `cli route --autoscale` on the
# standard library, one chat through it, the replica's blob routes
import os, socket, subprocess, time
os.environ["CAKE_KVSHARE"] = "1"
app = cli.build_server(cli.parser().parse_args(
    ["serve", "--flagship", "--layers", "1", "--cpu", "--dtype", "f32",
     "--port", "0", "--slots", "2", "--ctx", "256", "--kv-blocks", "64",
     "--prefill-chunk", "16"])).start()
assert app.state.kvshare is not None
with socket.socket() as s_:
    s_.bind(("127.0.0.1", 0))
    rport = s_.getsockname()[1]
env = dict(os.environ, PYTHONPATH=os.getcwd())
router = subprocess.Popen(
    [sys.executable, "-m", "cake_tpu_torch.cli", "route", "--host",
     "127.0.0.1", "--port", str(rport), "--replica", "r0=" + app.url,
     "--autoscale"],
    env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
try:
    for _ in range(200):
        try:
            with urllib.request.urlopen(
                    "http://127.0.0.1:%%d/health" %% rport, timeout=5) as r:
                break
        except OSError:
            time.sleep(0.05)
    req = urllib.request.Request(
        "http://127.0.0.1:%%d/v1/chat/completions" %% rport,
        data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert json.loads(r.read())["usage"]["completion_tokens"] > 0
    with urllib.request.urlopen(
            "http://127.0.0.1:%%d/api/v1/fleet/autoscale" %% rport,
            timeout=30) as r:
        assert json.loads(r.read())["enabled"] is True
    for _ in range(100):
        with urllib.request.urlopen(app.url + "/health", timeout=30) as r:
            chains = json.loads(r.read())["engine"]["kvshare"]["chains"]
        if chains:
            break
        time.sleep(0.05)
    with urllib.request.urlopen(app.url + "/api/v1/kv/prefix/" + chains[0],
                                timeout=30) as r:
        assert r.headers["Content-Type"] == "application/x-cake-kv-blob"
        blob = r.read()
    assert blob.startswith(b"CAKEKV")
    # the blob posted back installs (deduped: the chain is cached here)
    with urllib.request.urlopen(urllib.request.Request(
            app.url + "/api/v1/kv/prefix/" + chains[0], data=blob),
            timeout=30) as r:
        assert json.loads(r.read())["installed_units"] >= 1
    for bad in (b"garbage", blob[:-1]):
        try:
            urllib.request.urlopen(urllib.request.Request(
                app.url + "/api/v1/kv/prefix/" + chains[0], data=bad),
                timeout=30)
            raise AssertionError("a broken blob installed")
        except urllib.error.HTTPError as e:
            assert e.code == 422
    try:
        urllib.request.urlopen(app.url + "/api/v1/kv/prefix/" + "ab" * 16,
                               timeout=30)
        raise AssertionError("an unknown chain was exported")
    except urllib.error.HTTPError as e:
        assert e.code == 404
finally:
    router.terminate()
    router.wait(30)
    app.stop()
leaked =[m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("OK", len(mods))
''' % (BLOCKED + GATED,)


TORCHLESS_RUN = r'''
import asyncio, importlib, importlib.abc, json, pkgutil, runpy, sys
BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())

import os
os.environ["CAKE_KVSHARE"] = "1"
import cake_tpu_torch.fleet as fleet
# every fleet module but the KV-share replica agent, which moves pool
# tensors and loads only in a replica
for m in pkgutil.walk_packages(fleet.__path__, "cake_tpu_torch.fleet."):
    if m.name != "cake_tpu_torch.fleet.kvshare.replica":
        importlib.import_module(m.name)
from cake_tpu_torch.fleet.kvshare import (KVBlobMismatch, decode_blob,
                                          encode_directory, parse_directory)
hdr = encode_directory([("http://a:1", ["aa", "bb"])])
assert parse_directory(hdr) == [("http://a:1", frozenset({"aa", "bb"}))]
try:
    decode_blob(b"garbage")
    raise AssertionError("garbage decoded")
except KVBlobMismatch:
    pass
import cake_tpu_torch.cli, cake_tpu_torch.obs.series
from cake_tpu_torch.cluster import discovery
from cake_tpu_torch.fleet.http import request


async def views():
    router = fleet.FleetRouter(fleet.ReplicaRegistry(), probe_s=30.0,
                               autoscale=True)
    assert router.kvshare
    app = fleet.create_router_app(router)
    host, port = await app.start("127.0.0.1", 0)
    try:
        out = {}
        for path in ("/health", "/api/v1/fleet", "/api/v1/fleet/telemetry",
                     "/api/v1/fleet/autoscale", "/metrics"):
            r = await request("GET", "http://%%s:%%d%%s" %% (host, port, path))
            async with r:
                out[path] = (r.status, await r.read())
        return out
    finally:
        await app.stop()
out = asyncio.run(views())
assert out["/health"][0] == 503                    # nothing routable
scale = json.loads(out["/api/v1/fleet/autoscale"][1])
# an empty fleet under CAKE_SCALE_MIN: scale out, with no template to run
assert scale["enabled"] is True and scale["decisions"][0]["kind"] == \
    "scale_out" and scale["decisions"][0]["reason"] == "below_min"
assert json.loads(out["/api/v1/fleet/telemetry"][1])["autoscale"]["min"] == 1
assert b"cake_fleet_replicas" in out["/metrics"][1]
for cmd in ("route", "top"):
    sys.argv = ["cake_tpu_torch.cli", cmd, "--help"]
    try:
        runpy.run_module("cake_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("OK")
''' % (BLOCKED + GATED + ("torch", "numpy"),)


def test_fleet_router_runs_without_torch():
    """The router tier imports no torch (nor numpy, jax, cake_tpu or
    aiohttp): the whole fleet package but the KV-share replica agent, the
    KV-share codecs, a router with the closed loop and the KV-share tier
    on (CAKE_KVSHARE=1, autoscale=True) serving its views, and `cli route
    --help` / `cli top --help`."""
    out = subprocess.run([sys.executable, "-c", TORCHLESS_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "usage: cake-tpu-torch route" in out.stdout
    assert "usage: cake-tpu-torch top" in out.stdout
    assert out.stdout.rstrip().endswith("OK")


def test_cli_module_imports_no_torch_until_a_command_runs():
    """`cli serve` and the other model commands still import as before;
    the cli module itself loads the model stack only inside them, and its
    parser's preempt modes are the engine's."""
    code = ("import sys; import cake_tpu_torch.cli as c; "
            "assert 'torch' not in sys.modules, 'torch'; "
            "from cake_tpu_torch.serve.engine import PREEMPT_MODES; "
            "assert c.PREEMPT_MODES == PREEMPT_MODES; print('OK')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_port_runs_with_jax_and_cake_tpu_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_cake_tpu_import_in_port_sources():
    assert len(PORT_FILES) > 20
    bad = [(p.relative_to(ROOT).as_posix(), name)
           for p in PORT_FILES for name in _imports(p)
           if name.split(".")[0] in BLOCKED]
    assert not bad, bad


def _gated_imports(path: pathlib.Path):
    """(module, inside a try) of every import of a GATED package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    tried = {id(n) for t in ast.walk(tree) if isinstance(t, ast.Try)
             for stmt in t.body for n in ast.walk(stmt)}
    for node in ast.walk(tree):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import)
                 else [node.module or ""]
                 if isinstance(node, ast.ImportFrom) and node.level == 0
                 else [])
        for name in names:
            if name.split(".")[0] in GATED:
                yield name, id(node) in tried


def test_optional_packages_only_behind_the_gate():
    found = [(p.relative_to(ROOT).as_posix(), name, gated)
             for p in PORT_FILES for name, gated in _gated_imports(p)]
    assert found == [("cake_tpu_torch/cluster/transfer.py", "zstandard",
                      True)], found
