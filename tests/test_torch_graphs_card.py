"""The captured decode programs on the card, on a small bf16 config with
the flagship's head size (D 128, so both kernels take it): 16 graph
replays equal 16 eager steps token for token, logit for logit, KV byte
for byte and carry for carry, contiguous and paged, over greedy and
sampled rows and a free one; the launch counts include replays (and not
the capture); generate's captured chunks equal the step-by-step loop; the
engine serves through its graph. Every test is marked `cuda` and skips
without a card. This file imports no JAX, so it runs on the card's
machine, which has none:

    python -m pytest tests/test_torch_graphs_card.py -m cuda -s --noconftest
"""
import pytest
import torch

from cake_tpu_torch.bench.graph_cases import (build_state, graph_vs_eager,
                                              step_by_step)
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.models.common.graphs import DecodeGraph
from cake_tpu_torch.ops import paged_attention as pa
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import ServeEngine

GREEDY = SamplingConfig(temperature=0.0)
SAMPLED = SamplingConfig(temperature=0.8, top_k=50)
CTX = 1024


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tiny_config("qwen3", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      head_dim=128, max_position_embeddings=CTX,
                      eos_token_id=None)
    return TextModel(cfg, dtype=torch.bfloat16, device="cuda", seed=1)


def _state(model, kv_blocks):
    # 300: fresh + masked tail; 520: fresh + append + masked tail
    return build_state(model, [300, 100, None, 520],
                       [GREEDY, SAMPLED, GREEDY, SAMPLED], CTX,
                       kv_blocks=kv_blocks, headroom=64)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_blocks", [0, 256], ids=["contiguous", "paged"])
def test_graph_equals_eager_on_card(model, kv_blocks):
    r = graph_vs_eager(model, _state(model, kv_blocks), 16)
    print(f"graph vs eager ({'paged' if kv_blocks else 'contiguous'}): "
          f"max_abs logit diff {r['max_logit_diff']:.3e}")
    assert r["graph"].graph is not None
    assert r["tokens_equal"] and r["kv_equal"] and r["carries_equal"]
    assert r["max_logit_diff"] == 0.0
    assert len(set(r["tokens"][:, 1, 1].tolist())) > 1    # sampled row


@pytest.mark.cuda
def test_launch_counts_include_replays(model):
    state = _state(model, 256)
    layers = model.cfg.num_hidden_layers
    pa.reset_launches()
    graph = DecodeGraph(state.step_fn(model), model.device)
    # the warm-up launched; the capture did not
    assert pa.launch_counts()["bf16"] == 2 * layers
    pa.reset_launches()
    state.activate()
    for _ in range(5):
        graph.step()
    torch.cuda.synchronize()
    assert pa.launch_counts() == {"bf16": 5 * layers, "f32": 0}
    assert graph.steps == 5


@pytest.mark.cuda
@pytest.mark.parametrize("max_new,scfg", [(37, GREEDY), (40, SAMPLED)])
def test_generate_chunks_equal_the_loop_on_card(model, max_new, scfg):
    ids = list(range(5, 305))
    got, _ = model.generate(ids, max_new, scfg, seed=3)
    assert got == step_by_step(model, ids, max_new, scfg, seed=3)
    assert len(got) == max_new


@pytest.mark.cuda
def test_engine_serves_through_its_graph(model):
    """A paged engine launches the paged kernel once per layer in every
    replay, and each request (the first admission sampled) is the same
    alone and in company."""
    jobs = [(list(range(40, 90)), SAMPLED), (list(range(7, 300)), GREEDY),
            ([3, 4, 5], GREEDY)]

    def serve(jobs):
        eng = ServeEngine(model, slots=2, ctx_len=CTX, kv_blocks=128)
        try:
            assert eng.graph.graph is not None
            pa.reset_launches()
            reqs = [eng.submit(p, 24, s) for p, s in jobs]
            for r in reqs:
                assert r.wait(300) and "error" not in r.result
            torch.cuda.synchronize()
            assert pa.launch_counts()["bf16"] == \
                model.cfg.num_hidden_layers * eng.graph.steps > 0
            return [r.result["tokens"] for r in reqs]
        finally:
            eng.close()
    together = serve(jobs)
    assert [serve([job])[0] for job in jobs] == together
