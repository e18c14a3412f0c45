"""The serve engine's shape from the environment (fault 6): the port's
serve/engine.py maybe_engine and engine_knobs against the JAX package's
maybe_engine on tiny llamas of the same max_cache_len, under the same
CAKE_* variables:

  * each of CAKE_SERVE_SLOTS, CAKE_MAX_QUEUE, CAKE_SERVE_CTX (capped by
    the model's cache), CAKE_PREFILL_CHUNK (clamped to a power of two),
    CAKE_PREFIX_CACHE_MB (0 turns the cache off), CAKE_KV_BLOCKS (a paged
    pool) and CAKE_KV_BLOCK_TOKENS gives the same slots, ctx, queue
    bound, chunk, prefix-cache bytes, pool kind, blocks and block tokens;
  * CAKE_SERVE_SLOTS=0 gives no engine in both, as does an offloaded
    model in the port;
  * a flag given to `cli serve` wins over its variable, and the server
    `cli serve` builds follows the variables (CAKE_KV_BLOCKS=… a paged
    pool, CAKE_SERVE_SLOTS=0 the locked path);
  * the shutdown drain budget follows CAKE_DRAIN_TIMEOUT_S (30 s
    unset), as the reference's server reads it."""
import gc
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny
from cake_tpu.serve import maybe_engine as jax_maybe_engine
from cake_tpu_torch import cli
from cake_tpu_torch.api import server as api_server
from cake_tpu_torch.bench import synth_checkpoint as sc
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.serve.engine import ENGINE_KNOBS, engine_knobs, maybe_engine
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _collect_reference_engines():
    """Collect, after each test, the JAX serve engines it dropped: their
    admission queues sit in reference cycles, and a JAX queue finalized by
    a later automatic collection, while its thread holds the reference's
    board lock, deadlocks the process (ROADMAP §3, "Not a port fault")."""
    yield
    gc.collect()


CTX = 128
KNOB_NAMES = [name for _, name, _, _ in ENGINE_KNOBS]


@pytest.fixture(scope="module")
def pair():
    jm = JaxTextModel(jax_tiny("llama", max_position_embeddings=CTX),
                      dtype=jnp.float32, max_cache_len=CTX)
    cfg = tiny_config("llama", max_position_embeddings=CTX)
    tm = TextModel(cfg, params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jm.params), "cpu",
        torch.float32), dtype=torch.float32, device="cpu",
        max_cache_len=CTX)
    return jm, tm


@pytest.fixture
def clean_env(monkeypatch):
    for name in KNOB_NAMES + ["CAKE_DRAIN_TIMEOUT_S"]:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _shape(eng) -> dict | None:
    if eng is None:
        return None
    pc = eng.prefix_cache
    return {"slots": eng.slots, "ctx": eng.ctx,
            "queue": eng.queue.maxsize, "chunk": eng.chunk,
            "prefix_bytes": None if pc is None else pc.capacity,
            "paged": eng.paged is not None,
            "blocks": eng.paged.num_blocks if eng.paged else 0,
            "block_tokens": eng.paged.bt if eng.paged else None}


ENVS = {
    "defaults": {},
    "slots": {"CAKE_SERVE_SLOTS": "2"},
    "queue": {"CAKE_MAX_QUEUE": "7"},
    "ctx": {"CAKE_SERVE_CTX": "64"},
    "ctx_capped": {"CAKE_SERVE_CTX": "100000"},
    "chunk": {"CAKE_PREFILL_CHUNK": "40"},
    "prefix_off": {"CAKE_PREFIX_CACHE_MB": "0"},
    "prefix_mb": {"CAKE_PREFIX_CACHE_MB": "1.5"},
    "paged": {"CAKE_KV_BLOCKS": "24"},
    "paged_bt": {"CAKE_KV_BLOCKS": "40", "CAKE_KV_BLOCK_TOKENS": "8",
                 "CAKE_PREFILL_CHUNK": "32"},
    "slots_0": {"CAKE_SERVE_SLOTS": "0"},
}


@pytest.mark.parametrize("case", sorted(ENVS))
def test_engine_shape_follows_the_environment_as_jax(pair, clean_env, case):
    jm, tm = pair
    for k, v in ENVS[case].items():
        clean_env.setenv(k, v)
    want = jax_maybe_engine(jm)
    got = maybe_engine(tm)
    try:
        assert _shape(got) == _shape(want)
        if case == "slots_0":
            assert got is None
        if case.startswith("paged"):
            assert got.paged is not None
    finally:
        for eng in (want, got):
            if eng is not None:
                eng.close()


def test_flags_win_and_offloaded_models_get_no_engine(pair, clean_env):
    _, tm = pair
    clean_env.setenv("CAKE_SERVE_SLOTS", "5")
    clean_env.setenv("CAKE_KV_BLOCKS", "64")
    shape = engine_knobs(os.environ, slots=3, kv_blocks=None,
                         preempt_mode="recompute")
    assert shape["slots"] == 3 and shape["kv_blocks"] == 64
    assert shape["preempt_mode"] == "recompute"
    assert engine_knobs({}) == {kw: default
                                for kw, _, _, default in ENGINE_KNOBS}
    offloaded = types.SimpleNamespace(cfg=tm.cfg, max_cache_len=CTX)
    assert maybe_engine(offloaded) is None


def _tiny_dir(root) -> str:
    config = dict(architectures=["Qwen3ForCausalLM"], vocab_size=256,
                  hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  rms_norm_eps=1e-6, max_position_embeddings=256,
                  eos_token_id=2)
    d = str(root / "tiny")
    sc.write_model(d, config, sc.model_params(config, 0, torch.float32))
    return d


@pytest.mark.parametrize("case", ["paged_by_env", "flag_wins", "slots_0"])
def test_cli_serve_builds_the_engine_the_knobs_ask(tmp_path, clean_env,
                                                   case):
    d = _tiny_dir(tmp_path)
    argv = ["serve", d, "--cpu", "--dtype", "f32", "--port", "0", "--ctx",
            "256", "--prefill-chunk", "64"]
    if case == "paged_by_env":
        clean_env.setenv("CAKE_KV_BLOCKS", "48")
    elif case == "flag_wins":
        clean_env.setenv("CAKE_KV_BLOCKS", "48")
        clean_env.setenv("CAKE_SERVE_SLOTS", "3")
        argv += ["--kv-blocks", "0", "--slots", "2"]
    else:
        clean_env.setenv("CAKE_SERVE_SLOTS", "0")
    app = cli.build_server(cli.parser().parse_args(argv))
    try:
        eng = app.state.engine
        if case == "paged_by_env":
            assert eng.paged is not None and eng.paged.num_blocks == 48
            assert eng.slots == 4 and eng.ctx == 256 and eng.chunk == 64
        elif case == "flag_wins":
            assert eng.paged is None and eng.slots == 2
        else:
            assert eng is None
    finally:
        app.stop(drain_s=0.1)


class _RecordingEngine:
    """A stand-in engine that records the drain budget it is given."""

    def __init__(self):
        self.drained = []
        self.closed = False

    def drain(self, timeout=None):
        self.drained.append(timeout)
        return True

    def close(self):
        self.closed = True


@pytest.mark.parametrize("value,want", [(None, 30.0), ("7.5", 7.5)])
def test_drain_budget_follows_cake_drain_timeout_s(pair, clean_env, value,
                                                   want):
    _, tm = pair
    if value is not None:
        clean_env.setenv("CAKE_DRAIN_TIMEOUT_S", value)
    assert api_server.drain_timeout_s(os.environ) == want
    eng = _RecordingEngine()
    app = api_server.create_app(tm, eng, tm.tokenizer, port=0).start()
    app.stop()
    assert eng.drained == [want] and eng.closed
    assert app.state.draining
