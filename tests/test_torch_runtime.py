"""The port's way from a model name to a served chat: resolve_model on a
fake Hugging Face cache (a repo id that is not cached raises with the
path it probed), the configs and directories the port refuses (families
not ported yet, a .gguf that is not GGUF) and the quantized configs it
now detects as the JAX package does, `cli serve` on a tiny checkpoint
directory answering a chat over HTTP with the directory's basename as
the model id and the directory's tokenizer and template, a prompt the
request cannot build answering 400 where a server fault answers 500, and
an `attn_scale` other than D**-0.5 carried through flash (fresh and
append), masked and paged attention, against the JAX model at the golden
bar."""
import contextvars
import dataclasses
import io
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu_torch import cli
from cake_tpu_torch.api.server import AppState
from cake_tpu_torch.api.text import chat_completions
from cake_tpu_torch.bench import synth_checkpoint as sc
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common.config import config_from_hf_dict
from cake_tpu_torch.models.common.graphs import DecodeCarries
from cake_tpu_torch.runtime import CakeTokenizer, load_config_and_quant
from cake_tpu_torch.serve.paged import PagedKV
from cake_tpu_torch.tokenizer import PromptError
from cake_tpu_torch.utils import hub
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
ATOL = 1e-3


def test_resolve_model_local_and_cached(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert hub.resolve_model(str(tmp_path)) == str(tmp_path)
    snaps = tmp_path / "hf" / "hub" / "models--org--tiny" / "snapshots"
    for name, weights in (("aaa", True), ("zzz", False)):
        (snaps / name).mkdir(parents=True)
        (snaps / name / "config.json").write_text("{}")
        if weights:
            (snaps / name / "model.safetensors").write_bytes(b"")
    assert hub.looks_like_repo_id("org/tiny")
    # the newest snapshot without weights (an interrupted pull) is skipped
    assert hub.resolve_model("org/tiny") == str(snaps / "aaa")
    with pytest.raises(FileNotFoundError,
                       match="models--org--missing.snapshots"):
        hub.resolve_model("org/missing")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        hub.resolve_model(str(tmp_path / "no" / "such" / "dir"))


@pytest.mark.parametrize("over,match", [
    ({"quantization_config": {"quant_method": "gptq", "bits": 4}}, None),
    ({"quantization_config": {"quant_method": "fp8"}}, None),
    ({"architectures": ["Gemma3ForConditionalGeneration"]},
     "ROADMAP module 6"),
    ({"architectures": ["Qwen3MoeForCausalLM"], "num_experts": 8,
      "moe_intermediate_size": 64,
      "quantization_config": {"quant_method": "gptq", "bits": 4}}, None),
    ({"architectures": ["Qwen3NextForCausalLM"], "num_experts": 8,
      "moe_intermediate_size": 64, "shared_expert_intermediate_size": 64,
      "quantization_config": {"quant_method": "fp8"}}, None),
    ({"architectures": ["SomethingElseForCausalLM"]}, "not ported"),
])
def test_refused_configs_raise(tmp_path, over, match):
    """Configs the port does not adapt raise; the quantized ones it once
    refused (match None) now load, their quantization detected as the
    JAX package detects it."""
    d = dict(sc.flagship_config(layers=1), **over)
    (tmp_path / "config.json").write_text(json.dumps(d))
    if match is not None:
        with pytest.raises((NotImplementedError, ValueError), match=match):
            load_config_and_quant(str(tmp_path))
        return
    from cake_tpu.utils.quant import detect_quantization as jax_detect
    cfg, quant, raw = load_config_and_quant(str(tmp_path))
    want = jax_detect(d)
    assert raw == d and cfg.arch == config_from_hf_dict(d).arch
    assert (type(quant).__name__, quant.name, quant.vram_factor,
            getattr(quant, "group_size", None)) == \
        (type(want).__name__, want.name, want.vram_factor,
         getattr(want, "group_size", None))


def test_gguf_only_directory_raises(tmp_path):
    """A .gguf that is not a GGUF file raises as the JAX package's reader
    does; a directory with neither config.json nor a .gguf raises
    FileNotFoundError."""
    from cake_tpu.runtime import load_config_and_quant as jax_load_config
    (tmp_path / "model.gguf").write_bytes(b"NOPE" + bytes(20))
    for load in (load_config_and_quant, jax_load_config):
        with pytest.raises(ValueError, match="not a GGUF file"):
            load(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_config_and_quant(str(tmp_path / "empty"))


def tiny_checkpoint(root, name="tiny-qwen3") -> str:
    """A qwen3 checkpoint directory at tiny width, with a byte-level BPE
    tokenizer.json and a ChatML template whose specials fit its vocab."""
    d = os.path.join(root, name)
    config = dict(architectures=["Qwen3ForCausalLM"], vocab_size=800,
                  hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  rms_norm_eps=1e-6, max_position_embeddings=512,
                  tie_word_embeddings=True, eos_token_id=[797, 798])
    sc.write_model(d, config, sc.model_params(config, 3, torch.float32,
                                              randomize_norms=True))
    sc.write_tokenizer(d, {"<|endoftext|>": 797, "<|im_start|>": 796,
                           "<|im_end|>": 798}, n_merges=200)
    return d


def test_cli_serve_checkpoint_directory(tmp_path):
    d = tiny_checkpoint(str(tmp_path))
    args = cli.parser().parse_args(
        ["serve", d, "--cpu", "--dtype", "f32", "--port", "0", "--slots",
         "2", "--ctx", "256", "--prefill-chunk", "64"])
    app = cli.build_server(args).start()
    msgs = [{"role": "user", "content": "Hello, card 🚀"}]
    try:
        body = {"messages": msgs, "temperature": 0, "max_tokens": 6}
        req = urllib.request.Request(app.url + "/v1/chat/completions",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            resp = json.loads(r.read())
        with urllib.request.urlopen(app.url + "/v1/models",
                                    timeout=30) as r:
            models = json.loads(r.read())
    finally:
        app.stop()
    assert resp["model"] == "tiny-qwen3"
    assert models["data"][0]["id"] == "tiny-qwen3"
    tok = CakeTokenizer(d)
    ids = tok.chat_prompt_ids(msgs)
    assert ids[0] == 796 and tok.decode(ids) == tok.apply_chat(msgs)
    assert resp["usage"]["prompt_tokens"] == len(ids)
    assert resp["usage"]["completion_tokens"] > 0
    model, _, _ = cli.load_model(args, max_cache_len=256)
    want, _ = model.generate(ids, max_new_tokens=6)
    stop = resp["choices"][0]["finish_reason"] == "stop"
    assert len(want) == resp["usage"]["completion_tokens"]
    content = want[:-1] if stop else want
    assert resp["choices"][0]["message"]["content"] == tok.decode(content)


class _FakeHandler:
    """What chat_completions reads of a request handler, and the reply."""

    def __init__(self, body: dict):
        data = json.dumps(body).encode()
        self.headers = {"Content-Length": str(len(data))}
        self.rfile = io.BytesIO(data)
        self.sent = None

    def send_json(self, obj, status=200, headers=None):
        self.sent = (status, obj)


def _template_error():
    import jinja2
    return jinja2.TemplateError("unknown role")


@pytest.mark.parametrize("fault,status", [
    (lambda: PromptError("no tokenizer available"), 400),
    (_template_error, 400),
    (lambda: IndexError("list index out of range"), 500),
], ids=["raw_ids_text", "template_raise", "server_bug"])
def test_prompt_faults_map_to_status(fault, status):
    """A prompt the request makes unbuildable answers 400; any other
    fault while building it is the server's and answers 500."""
    class Tok:
        def chat_prompt_ids(self, messages):
            raise fault()
    state = AppState(model=None, engine=None, tokenizer=Tok())
    h = _FakeHandler({"messages": [{"role": "user", "content": "hi"}]})
    # in a context of its own, as the server's handler thread has: the
    # request id the handler adopts must not leak into this worker's
    # later tests
    contextvars.copy_context().run(chat_completions, h, state)
    assert h.sent[0] == status
    if status == 500:
        assert "list index" not in h.sent[1]["error"]


# -- attn_scale through every attention path ----------------------------------

SCALE = 0.3          # head_dim 16: the default would be 0.25
CTX = 1024


@pytest.fixture(scope="module")
def scaled_pair():
    over = dict(max_position_embeddings=CTX)
    jcfg = dataclasses.replace(jax_tiny_config("qwen3", **over),
                               attn_scale=SCALE)
    jm = JaxTextModel(jcfg, dtype=jnp.float32, seed=5, max_cache_len=CTX)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    cfg = dataclasses.replace(tiny_config("qwen3", **over), attn_scale=SCALE)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   dtype=torch.float32, device="cpu", max_cache_len=CTX)
    return jm, tm


def test_attn_scale_flash_and_masked_match_jax(scaled_pair):
    """560 tokens: flash fresh in one bucket; then chunks of 256 (flash
    fresh, flash append) and a 48-token masked tail; 4 masked decode
    steps."""
    jm, tm = scaled_pair
    ids = [int(t) for t in np.random.default_rng(2).integers(3, 256, 560)]
    want, jcache = jm.prefill(jm.new_cache(), ids)
    got, cache = tm.prefill(tm.new_cache(), ids)
    assert tm.last_prefill_mode == "fresh"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    chunked, modes = tm.new_cache(), []
    for p0 in (0, 256, 512):
        got2, chunked = tm.prefill(chunked, ids[p0:p0 + 256], p0)
        modes.append(tm.last_prefill_mode)
    assert modes == ["fresh", "append", "append"]
    np.testing.assert_allclose(got2.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    plain = dataclasses.replace(tm.cfg, attn_scale=None)
    other = TextModel(plain, tm.params, dtype=torch.float32, device="cpu",
                      max_cache_len=CTX)
    assert (other.prefill(other.new_cache(), ids)[0] - got).abs().max() \
        > 10 * ATOL
    c = DecodeCarries.build(1, tm.cfg.vocab_size, 64, "cpu")
    tok = int(np.argmax(np.asarray(want)[0]))
    c.toks.fill_(tok)
    c.pos.fill_(len(ids))
    c.active.fill_(True)
    for _ in range(4):
        lg, jcache = jm.decode_logits(jcache, tok)
        tm.decode_slots_into(cache["layers"], c)
        np.testing.assert_allclose(c.logits[0].numpy(), np.asarray(lg)[0],
                                   atol=ATOL, rtol=0)
        tok = int(np.argmax(np.asarray(lg)[0]))
        c.toks.fill_(tok)


def test_attn_scale_paged_matches_jax(scaled_pair):
    """The same through a paged pool: chunked paged prefill, then 4 decode
    steps through the paged decode path's plain version."""
    jm, tm = scaled_pair
    ids = [int(t) for t in np.random.default_rng(3).integers(3, 256, 540)]
    want, jcache = jm.prefill(jm.new_cache(), ids)
    pk = PagedKV.build(tm, 1, CTX, 48, 16, 256)
    for p0 in (0, 256, 512):
        part = ids[p0:p0 + 256]
        assert pk.reserve_range(0, p0, len(part))
        logits = pk.prefill_into(0, part, p0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    c = DecodeCarries.build(1, tm.cfg.vocab_size, 64, "cpu")
    tok = int(np.argmax(np.asarray(want)[0]))
    c.toks.fill_(tok)
    c.pos.fill_(len(ids))
    c.active.fill_(True)
    for step in range(4):
        assert pk.reserve_range(0, len(ids) + step, 1)
        lg, jcache = jm.decode_logits(jcache, tok)
        tm.decode_slots_paged_into(pk.pool, pk.rows, pk.tables, c)
        np.testing.assert_allclose(c.logits[0].numpy(), np.asarray(lg)[0],
                                   atol=ATOL, rtol=0)
        tok = int(np.argmax(np.asarray(lg)[0]))
        c.toks.fill_(tok)


def test_family_configs_read_as_published():
    """The smoke's six configurations resolve to the shapes the kernels
    are held at: (Hq, Hkv, D, window, rotary dim, layer kinds); Gemma-3-1B
    has its global layers at 5, 11, 17 and 23; Qwen3-Next a full layer
    every fourth, gated, and 512 experts top 10 with a shared expert."""
    got = {}
    for fam in sc.FAMILIES:
        cfg = config_from_hf_dict(sc.family_config(fam, layers=4))
        got[fam] = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim, cfg.sliding_window, cfg.rotary_dim,
                    [(s.kind, s.use_rope, s.norm_style)
                     for s in cfg.layer_specs()])
    local = ("swa", True, "post")
    assert got == {
        "olmo2": (16, 16, 128, None, 128, [("full", True, "post")] * 4),
        "exaone4": (32, 8, 64, 4096, 64, [local] * 3
                    + [("full", False, "post")]),
        "phi4": (24, 8, 128, None, 96, [("full", True, "pre")] * 4),
        "gemma3": (4, 1, 256, 512, 256, [("swa", True, "sandwich")] * 4),
        "qwen3_next": (16, 2, 256, None, 64, [("linear", False, "pre")] * 3
                       + [("full", True, "pre")]),
        "qwen3_moe": (32, 4, 128, None, 128, [("full", True, "pre")] * 4),
    }
    g = config_from_hf_dict(sc.family_config("gemma3"))
    assert [i for i, s in enumerate(g.layer_specs()) if s.window is None] \
        == [5, 11, 17, 23]
    assert (g.hidden_act, g.embed_scale, g.attn_scale,
            g.local_rope_theta, g.rope_theta, g.eos_token_ids) == \
        ("gelu_tanh", 1152 ** 0.5, 256 ** -0.5, 1e4, 1e6, (1, 106))
    n = config_from_hf_dict(sc.family_config("qwen3_next"))
    assert [i for i, s in enumerate(n.layer_specs()) if s.kind == "full"] \
        == list(range(3, 48, 4))
    assert all(s.is_moe for s in n.layer_specs())
    assert (n.num_experts, n.num_experts_per_tok, n.moe_intermediate_size,
            n.shared_expert_intermediate_size, n.norm_topk_prob,
            n.attn_output_gate, n.residual_rms_norm, n.model_prefix) == \
        (512, 10, 512, 512, True, True, True, "model")
    la = n.linear_attn
    assert (la.num_key_heads, la.key_head_dim, la.num_value_heads,
            la.value_head_dim, la.conv_kernel_dim) == (16, 128, 32, 128, 4)
    m = config_from_hf_dict(sc.family_config("qwen3_moe"))
    assert (m.num_experts, m.num_experts_per_tok, m.moe_intermediate_size,
            m.linear_attn, m.attn_output_gate) == (128, 8, 768, None, False)




def _module10_dicts() -> dict:
    """Tiny config.json dicts of the four module-10 architectures: flat
    (Qwen3-MoE, Qwen3-Next) and under text_config (Qwen3.5)."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=4, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-6,
                max_position_embeddings=128, eos_token_id=2)
    moe = dict(num_experts=8, num_experts_per_tok=2,
               moe_intermediate_size=32)
    gdn = dict(layer_types=["linear_attention"] * 3 + ["full_attention"],
               linear_num_key_heads=2, linear_key_head_dim=16,
               linear_num_value_heads=4, linear_value_head_dim=16,
               rope_theta=1e6, partial_rotary_factor=0.25)
    return {
        "Qwen3MoeForCausalLM": dict(base, **moe),
        "Qwen3_5ForConditionalGeneration": dict(text_config=dict(base,
                                                                 **gdn)),
        "Qwen3_5MoeForConditionalGeneration": dict(text_config=dict(
            base, **gdn, **moe, shared_expert_intermediate_size=24)),
        "Qwen3NextForCausalLM": dict(base, **gdn, **moe,
                                     shared_expert_intermediate_size=24),
    }


@pytest.mark.parametrize("arch", sorted(_module10_dicts()))
def test_module10_configs_read_as_jax_reads_them(arch):
    """config_from_hf_dict of each module-10 architecture gives the JAX
    package's ModelConfig field for field and layer for layer."""
    from cake_tpu.models.common.config import config_from_hf_dict as jax_cfg
    d = dict(_module10_dicts()[arch], architectures=[arch])
    got, want = config_from_hf_dict(d), jax_cfg(d)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "linear_attn" and g is not None:
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, f.name
    assert [(s.kind, s.use_rope, s.window, s.is_moe, s.norm_style)
            for s in got.layer_specs()] == \
        [(s.kind, s.use_rope, s.window, s.is_moe, s.norm_style)
         for s in want.layer_specs()]


def test_reference_reads_full_attention_interval_as_all_full(caplog):
    """A Qwen3-Next config with transformers' full_attention_interval and
    no layer_types: the JAX package builds no linear layer (every layer
    full attention, gated); the port reads it the same way and logs that
    the interval is not read."""
    from cake_tpu.models.common.config import config_from_hf_dict as jax_cfg
    d = dict(_module10_dicts()["Qwen3NextForCausalLM"],
             architectures=["Qwen3NextForCausalLM"],
             full_attention_interval=4)
    del d["layer_types"]
    want = jax_cfg(d)
    assert want.linear_attn is None and want.attn_output_gate
    assert {s.kind for s in want.layer_specs()} == {"full"}
    with caplog.at_level("WARNING"):
        got = config_from_hf_dict(d)
    assert got.linear_attn is None
    assert [s.kind for s in got.layer_specs()] == ["full"] * 4
    assert "full_attention_interval is not read" in caplog.text
