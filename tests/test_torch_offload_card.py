"""Expert offload on the card (module 10b), at a small size: a two-layer
Qwen3-MoE written from seeds (bf16, and Qwen's FP8 block-wise layout),
served with its experts offloaded against the same checkpoint loaded
resident. Every test is marked `cuda` and skips without a card. This
file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_offload_card.py -m cuda -s --noconftest

  * bf16: 16 greedy tokens of a 300-token prompt equal the resident
    model's (its captured generate), the first step's logits within the
    bf16 bar, one flash (bf16, fresh) launch per full-attention layer of
    each offloaded prefill, and less device memory after load;
  * FP8: the offloaded model's tokens equal the resident model's
    (dequantized at load), and the dequant kernel launches three times
    (gate, up, down) per expert read."""
import pytest
import torch

from cake_tpu_torch.bench import synth_checkpoint as sc
from cake_tpu_torch.models.common.offload_model import OffloadedTextModel
from cake_tpu_torch.ops import flash
from cake_tpu_torch.ops import fp8
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.runtime import build_text_model, load_config_and_quant
from cake_tpu_torch.utils.loaders import load_model_params

CONFIG = dict(architectures=["Qwen3MoeForCausalLM"], vocab_size=512,
              hidden_size=256, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=64,
              rms_norm_eps=1e-6, max_position_embeddings=1024,
              tie_word_embeddings=False, eos_token_id=2, num_experts=8,
              num_experts_per_tok=2, moe_intermediate_size=128)
GREEDY = SamplingConfig(temperature=0.0)
PROMPT = [3 + (i * 37) % 500 for i in range(300)]
BF16_BAR = 2e-2


def _build(d, lru=None):
    """The checkpoint in bf16 on the card: resident through the runtime,
    or (lru given) offloaded with an LRU of `lru` experts per layer, small
    enough that the 8 experts evict. Returns (model, bytes allocated)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    if lru is None:
        model, _, _ = build_text_model(d, dtype="bf16", max_cache_len=1024)
    else:
        cfg, quant, _ = load_config_and_quant(d)
        model = OffloadedTextModel(cfg, load_model_params(
            cfg, d, torch.bfloat16, "cuda", quant, expert_offload=True,
            expert_lru_size=lru), dtype=torch.bfloat16, device="cuda",
            max_cache_len=1024)
    torch.cuda.synchronize()
    return model, torch.cuda.memory_allocated() - before


@pytest.mark.cuda
def test_offloaded_bf16_equals_resident_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = str(tmp_path / "bf16")
    sc.write_model(d, CONFIG, sc.model_params(CONFIG, 7, torch.float32))
    resident, res_bytes = _build(d)
    want, _ = resident.generate(PROMPT, 16, GREEDY, spec=False)
    want_logits = resident.prefill(resident.new_cache(1, 512), PROMPT)[0]
    del resident
    torch.cuda.empty_cache()
    off, off_bytes = _build(d, lru=4)
    assert off_bytes < res_bytes
    flash.reset_launches()
    got, stats = off.generate(PROMPT, 16, GREEDY)
    torch.cuda.synchronize()
    assert flash.launch_counts()["bf16"]["fresh"] == 2   # one per layer
    assert got == want
    logits = off.prefill(off.new_cache(1, 512), PROMPT)[0]
    err = (logits.float() - want_logits.float()).abs().max().item()
    print(f"offloaded vs resident first-step logits max abs err {err:.3g}")
    assert err <= BF16_BAR
    assert stats["expert_reads"] > 0


@pytest.mark.cuda
def test_offloaded_fp8_dequantizes_each_expert_read_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = str(tmp_path / "fp8")
    sc.write_fp8_model(d, CONFIG, sc.model_params(CONFIG, 8, torch.float32))
    resident, _ = _build(d)
    want, _ = resident.generate(PROMPT, 16, GREEDY, spec=False)
    del resident
    torch.cuda.empty_cache()
    off, _ = _build(d, lru=4)
    fp8.reset_launches()
    got, stats = off.generate(PROMPT, 16, GREEDY)
    torch.cuda.synchronize()
    assert got == want
    assert stats["expert_reads"] > 0
    assert fp8.launch_counts()["bf16"] == 3 * stats["expert_reads"]
