"""Quantized checkpoints in the port (ops/fp8.py, utils/quant.py,
utils/loaders.py, runtime.build_text_model) against the JAX package on
the same seeded inputs:

* FP8 block-wise: the plain dequant, in float32 and bfloat16, bit for bit
  against cake_tpu.ops.fp8 over every e4m3 code (NaN positions equal, the
  other bits equal); quant bytes and scale_inv bit for bit; the cropped
  edge blocks of 200 x 300 and 1 x 1.
* AutoGPTQ 4-bit: unpack_int4 and dequantize_gptq_4bit, sequential and
  through a permuted g_idx, bit for bit.
* detect_quantization: the same strategy and fields as the JAX function
  on eight configs, and the same refusals.
* End to end, tiny qwen3 checkpoints written by the port's writers (FP8,
  GPTQ with and without desc_act) and a tiny qwen3_moe FP8 one (experts
  quantized, loaded dense): both packages' loaders give the same bits,
  f32 and bf16 (native FP8 pairs included), prefill logits within the
  golden bar (atol 1e-3), greedy tokens identical; the port's native
  model equals its at-load model bit for bit in f32 and bf16; and an
  FP8-native model served by ServeEngine in both pools gives the at-load
  model's tokens.
* `--fp8-native` on a checkpoint that is not FP8 raises in both packages.

The kernel itself runs only on a card: tests/test_torch_fp8_card.py."""
import json
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models.common.config import config_from_hf_dict as jax_config
from cake_tpu.ops import fp8 as jfp8
from cake_tpu.utils import quant as jquant
from cake_tpu.utils.loaders import load_model_params as jax_load
from cake_tpu_torch.bench import synth_checkpoint as sc
from cake_tpu_torch.ops import fp8
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.runtime import build_text_model, load_config_and_quant
from cake_tpu_torch.serve import ServeEngine
from cake_tpu_torch.utils import quant

torch.set_num_threads(1)
ATOL = 1e-3
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _fp8_inputs(o: int, i: int, seed: int):
    """Seeded e4m3 bytes (every code, NaN included, where the shape has
    room) and positive float32 scales over 5 decades."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (o, i), dtype=np.uint8)
    raw.reshape(-1)[:min(256, o * i)] = np.arange(min(256, o * i))
    so, si = fp8.scale_shape(o, i)
    s = (10.0 ** rng.uniform(-5, 0, (so, si))).astype(np.float32)
    return raw, s


def _same_bits(got: torch.Tensor, want: np.ndarray) -> None:
    """NaN at the same places and every other value bit for bit."""
    want = torch.from_numpy(np.asarray(want, np.float32)).to(got.dtype)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    ib = BITS[got.dtype]
    assert torch.equal(got[~nan].view(ib), want[~nan].view(ib))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(256, 384), (200, 300), (1, 1)],
                         ids=["256x384", "200x300", "1x1"])
def test_fp8_dequant_plain_matches_jax(shape, dtype):
    raw, s = _fp8_inputs(*shape, seed=shape[0])
    tdt, jdt = DTYPES[dtype]
    w = torch.from_numpy(raw).view(torch.float8_e4m3fn)
    got = fp8.dequant_fp8_blockwise(w, torch.from_numpy(s), tdt)
    assert got.dtype == tdt and tuple(got.shape) == shape
    want = jfp8.dequant_fp8_blockwise(
        jnp.asarray(raw.view(ml_dtypes.float8_e4m3fn)), jnp.asarray(s),
        out_dtype=jdt)
    _same_bits(got, np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("shape", [(256, 384), (200, 300), (1, 1)],
                         ids=["256x384", "200x300", "1x1"])
def test_fp8_quant_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    w = (rng.standard_normal(shape)
         * 10.0 ** rng.uniform(-4, 1, shape)).astype(np.float32)
    q, s = fp8.quant_fp8_blockwise(torch.from_numpy(w))
    jq, js = jfp8.quant_fp8_blockwise(jnp.asarray(w))
    assert q.dtype == torch.float8_e4m3fn and s.dtype == torch.float32
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the round trip stays within e4m3's half ulp (2^-4) of each block max
    back = fp8.dequant_fp8_blockwise(q, s, torch.float32)
    amax = np.abs(w).max()
    assert np.abs(back.numpy() - w).max() <= amax * 2.0 ** -4


def test_fp8_every_code_dequantizes_exactly():
    """All 256 codes times 2^-3: the float32 value of each code, scaled
    exactly, NaN for 0x7f and 0xff, -0.0 for 0x80."""
    codes = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
    out = fp8.dequant_fp8_blockwise(codes.reshape(2, 128),
                                    torch.full((1, 1), 0.125),
                                    torch.float32).reshape(-1)
    want = codes.float() * 0.125
    assert torch.isnan(out).nonzero().reshape(-1).tolist() == [127, 255]
    ok = ~torch.isnan(want)
    assert torch.equal(out[ok].view(torch.int32), want[ok].view(torch.int32))
    assert out[128].item() == 0.0 and torch.signbit(out[128])


# -- GPTQ -------------------------------------------------------------------------


def _gptq_inputs(i: int, o: int, group: int, seed: int):
    rng = np.random.default_rng(seed)
    qweight = rng.integers(-2 ** 31, 2 ** 31, (i // 8, o), dtype=np.int64
                           ).astype(np.int32)
    qzeros = rng.integers(-2 ** 31, 2 ** 31, (i // group, o // 8),
                          dtype=np.int64).astype(np.int32)
    scales = rng.uniform(1e-3, 1e-2, (i // group, o)).astype(np.float16)
    g_idx = rng.permutation(np.arange(i) // group).astype(np.int32)
    return qweight, qzeros, scales, g_idx


@pytest.mark.parametrize("axis", [0, 1])
def test_unpack_int4_matches_jax(axis):
    qweight, qzeros, _, _ = _gptq_inputs(64, 48, 32, 1)
    packed = qweight if axis == 0 else qzeros
    got = quant.unpack_int4(torch.from_numpy(packed), axis)
    want = jquant.unpack_int4(packed.view(np.uint32), axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("permuted", [False, True], ids=["seq", "g_idx"])
def test_gptq_dequant_matches_jax(permuted):
    qweight, qzeros, scales, g_idx = _gptq_inputs(256, 96, 64, 2)
    got = quant.dequantize_gptq_4bit(
        torch.from_numpy(qweight), torch.from_numpy(scales).float(),
        torch.from_numpy(qzeros), 64,
        torch.from_numpy(g_idx).long() if permuted else None)
    want = jquant.dequantize_gptq_4bit(
        qweight.view(np.uint32), scales.astype(np.float32),
        qzeros.view(np.uint32), 64,
        g_idx.astype(np.int64) if permuted else None)
    assert got.shape == (96, 256)
    np.testing.assert_array_equal(got.numpy(), want)


# -- detection --------------------------------------------------------------------

DETECT = {
    "none": {},
    "fp8_qwen": {"quantization_config": dict(sc.FP8_CONFIG)},
    "fp8_fmt": {"quantization_config": {"fmt": "float8_e4m3fn"}},
    "gptq": {"quantization_config": {"quant_method": "gptq", "bits": 4,
                                     "group_size": 64, "desc_act": True}},
    "affine4": {"quantization_config": {"mode": "affine", "bits": 4}},
    "text_config": {"text_config": {"quantization_config": {
        "quant_method": "fp8"}}},
    "gptq8": {"quantization_config": {"quant_method": "gptq", "bits": 8}},
    "awq": {"quantization_config": {"quant_method": "awq", "bits": 4}},
}


def _fields(q) -> tuple:
    return (type(q).__name__, q.name, q.vram_factor,
            getattr(q, "keep_native", None), getattr(q, "group_size", None),
            getattr(q, "desc_act", None))


@pytest.mark.parametrize("case", sorted(DETECT))
def test_detect_quantization_matches_jax(case):
    cfg = DETECT[case]
    try:
        want = _fields(jquant.detect_quantization(cfg))
    except NotImplementedError as e:
        with pytest.raises(NotImplementedError, match=re.escape(str(e))):
            quant.detect_quantization(cfg)
        return
    assert _fields(quant.detect_quantization(cfg)) == want
    assert _fields(quant.fp8_native_quant()) == \
        _fields(jquant.fp8_native_quant())


# -- end to end: tiny checkpoints in each format --------------------------------

# widths that are not multiples of 128, so FP8's edge blocks are cropped
TINY = dict(architectures=["Qwen3ForCausalLM"], vocab_size=256,
            hidden_size=192, intermediate_size=320, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=48,
            rms_norm_eps=1e-6, max_position_embeddings=256,
            tie_word_embeddings=False, eos_token_id=2)
# GPTQ groups: every in-feature count a multiple of 64
TINY_GPTQ = dict(TINY, hidden_size=128, intermediate_size=256, head_dim=32)
TINY_MOE = dict(TINY, architectures=["Qwen3MoeForCausalLM"],
                num_hidden_layers=2, num_experts=4, num_experts_per_tok=2,
                moe_intermediate_size=64)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _port_bits(tree) -> dict:
    out = {}
    for k, v in _flat(tree):
        if v.dtype == torch.float8_e4m3fn:
            v = v.view(torch.uint8)
        elif v.element_size() == 2:
            v = v.view(torch.int16)
        out[k] = v.numpy()
    return out


def _jax_bits(tree) -> dict:
    out = {}
    for k, v in _flat(tree):
        if k.endswith(".rope") or ".rope." in k:
            continue
        a = np.asarray(v)
        out[k] = a.view(np.uint8) if a.dtype.itemsize == 1 and \
            a.dtype.kind == "V" else (a.view(np.int16)
                                      if a.dtype.itemsize == 2 else a)
    return out


def _write(kind: str, d: str) -> dict:
    if kind == "fp8":
        config = TINY
        sc.write_fp8_model(d, config, sc.model_params(
            config, 3, torch.float32, randomize_norms=True))
    elif kind == "moe_fp8":
        config = TINY_MOE
        sc.write_fp8_model(d, config, sc.model_params(
            config, 4, torch.float32, randomize_norms=True))
    else:
        config = TINY_GPTQ
        sc.write_gptq_model(d, config, sc.model_params(
            config, 5, torch.float32, randomize_norms=True), seed=6,
            group_size=64, desc_act=kind == "gptq_act")
    return config


def _jax_quant(kind: str, native: bool, d: str):
    raw = json.load(open(f"{d}/config.json"))
    q = jquant.detect_quantization(raw)
    return jquant.fp8_native_quant() if native else q


CASES = [("fp8", False), ("fp8", True), ("gptq", False), ("gptq_act", False),
         ("moe_fp8", True)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,native", CASES,
                         ids=[f"{k}{'_native' if n else ''}"
                              for k, n in CASES])
def test_quantized_checkpoint_loads_as_jax_loads_it(tmp_path, kind, native,
                                                    dtype):
    d = str(tmp_path / "ckpt")
    config = _write(kind, d)
    tdt, jdt = DTYPES[dtype]
    jcfg = jax_config(config)
    want = jax_load(jcfg, d, jdt, quant=_jax_quant(kind, native, d))
    tm, _, _ = build_text_model(d, dtype=dtype, device="cpu",
                                max_cache_len=256, fp8_native=native)
    got = _port_bits(tm.params)
    jbits = _jax_bits(want)
    assert got.keys() == jbits.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], jbits[k], err_msg=k)
    attn = tm.params["layers"][0]["self_attn"]["q_proj"]["weight"]
    assert fp8.is_fp8(attn) == native
    if kind == "moe_fp8":
        assert tm.params["layers"][0]["mlp"]["experts"]["up_proj"].dtype \
            == tdt                                 # experts load dense
    if dtype == "bf16":
        return
    jm = JaxTextModel(jcfg, params=want, dtype=jnp.float32,
                      max_cache_len=256)
    ids = [int(t) for t in np.random.default_rng(5).integers(8, 256, 40)]
    jl, _ = jm.prefill(jm.new_cache(), ids)
    tl, _ = tm.prefill(tm.new_cache(), ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    jtoks, _ = jm.generate(ids, max_new_tokens=12, spec=False)
    ttoks, _ = tm.generate(ids, max_new_tokens=12)
    assert ttoks == jtoks


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["fp8", "moe_fp8"])
def test_fp8_native_equals_at_load(tmp_path, kind, dtype):
    """Native pairs dequantized per use give the at-load weights' bits:
    prefill logits and greedy tokens identical."""
    d = str(tmp_path / "ckpt")
    _write(kind, d)
    at_load, _, _ = build_text_model(d, dtype=dtype, device="cpu",
                                     max_cache_len=256)
    native, _, _ = build_text_model(d, dtype=dtype, device="cpu",
                                    max_cache_len=256, fp8_native=True)
    ids = [int(t) for t in np.random.default_rng(6).integers(8, 256, 70)]
    a, _ = at_load.prefill(at_load.new_cache(), ids)
    n, _ = native.prefill(native.new_cache(), ids)
    assert torch.equal(a, n)
    assert at_load.generate(ids, 8)[0] == native.generate(ids, 8)[0]


def test_fp8_native_engine_equals_at_load(tmp_path):
    """An FP8-native model behind ServeEngine, contiguous and paged (the
    eager in-place step on the CPU), gives the at-load model's tokens for
    three concurrent greedy requests."""
    d = str(tmp_path / "ckpt")
    _write("fp8", d)
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(8, 256, n)] for n in (70, 20,
                                                                  130)]
    greedy = SamplingConfig(temperature=0.0)
    tokens = {}
    for native in (False, True):
        m, _, _ = build_text_model(d, dtype="f32", device="cpu",
                                   max_cache_len=256, fp8_native=native)
        for kw in ({}, {"kv_blocks": 48}):
            eng = ServeEngine(m, slots=2, ctx_len=256, prefill_chunk=64,
                              **kw)
            try:
                reqs = [eng.submit(p, 8, greedy) for p in prompts]
                for r in reqs:
                    assert r.wait(120)
                tokens[native, bool(kw)] = [r.result["tokens"]
                                            for r in reqs]
            finally:
                eng.close()
    assert tokens[True, False] == tokens[False, False]
    assert tokens[True, True] == tokens[False, True] == tokens[False, False]


def test_fp8_native_requires_an_fp8_checkpoint(tmp_path):
    """As in the reference: --fp8-native on another checkpoint raises."""
    d = str(tmp_path / "ckpt")
    _write("gptq", d)
    from cake_tpu.runtime import build_text_model as jax_build
    for build, kw in ((build_text_model, {"device": "cpu"}),
                      (jax_build, {})):
        with pytest.raises(ValueError, match="requires an FP8 checkpoint"):
            build(d, dtype="f32", fp8_native=True, **kw)
    cfg, q, raw = load_config_and_quant(d)
    assert (q.name, q.group_size, q.desc_act) == ("gptq", 64, False)
    assert raw["quantization_config"]["bits"] == 4
    assert cfg.hidden_size == 128
