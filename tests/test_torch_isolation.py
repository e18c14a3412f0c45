"""The port stands alone: with `jax` and `cake_tpu` blocked, and the
packages the card's machine lacks (`tokenizers`, `transformers`,
`safetensors`, `regex`, `ml_dtypes`, `huggingface_hub`) blocked too,
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
scan finds no import of any of them in the port's sources."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "cake_tpu", "tokenizers", "transformers",
           "safetensors", "regex", "ml_dtypes", "huggingface_hub")
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
             "cake_tpu_torch.api.state"):
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
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("OK", len(mods))
''' % (BLOCKED,)


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
