"""The port's MoE ops (ops/moe.py) and block (layers.moe_forward) against
the JAX package (cake_tpu/ops/moe.py, layers.moe_forward) in float32 on
the CPU, inputs drawn from numpy seeds, within TOL (1e-5):

  * router_topk, softmax and sigmoid gates, with and without
    norm_topk_prob;
  * every route of the port ("gathered", "grouped", "dense") against both
    of the reference's dispatches (the dense combine below 32 tokens, the
    sort-based ragged segment GEMM from 32 up) at T 5 and 40, SiLU and
    GELU experts;
  * the block with its shared expert and sigmoid shared_expert_gate;
  * the dispatch choice: rows -> gathered, a chunk -> grouped in bfloat16
    and dense in float32, another dtype refused;
  * on the rows' route, a token's output does not depend on the other
    rows of the step (the engine steps every pool row whatever the
    occupancy, so "alone" and "in company" differ in the other rows'
    tokens, never in shape): bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.models.common.layers import init_moe_params as jax_init_moe
from cake_tpu.models.common.layers import moe_forward as jax_moe_forward
from cake_tpu.ops import moe as jmoe
from cake_tpu_torch.models import tiny_config
from cake_tpu_torch.models.common.layers import moe_forward
from cake_tpu_torch.ops import moe

torch.set_num_threads(1)
TOL = 1e-5          # absolute and relative: float32 summation orders
E, I, H, K = 8, 16, 32, 2


def _bank(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.3, shape).astype(np.float32)
            for shape in ((E, H), (E, I, H), (E, I, H), (E, H, I))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("gate_act", ["softmax", "sigmoid"])
def test_router_topk_matches_jax(gate_act, norm):
    logits = np.random.default_rng(1).normal(0, 2, (12, E)).astype(
        np.float32)
    jw, ji = jmoe.router_topk(jnp.asarray(logits), K, norm, gate_act)
    tw, ti = moe.router_topk(torch.from_numpy(logits), K, norm, gate_act)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert tw.dtype == torch.float32 and ti.dtype == torch.int32
    _close(tw, jw)
    w = moe.combine_weights(tw, ti, E)
    _close(w, jmoe.combine_weights(jw, ji, E))


def _jax_moe(x, bank, ragged: bool, gate_act, act):
    """The reference's moe_ffn forced to one of its two dispatches."""
    router, gp, up, dp = map(jnp.asarray, bank)
    xj = jnp.asarray(x)
    if not ragged:
        logits = jnp.einsum("th,eh->te", xj, router,
                            preferred_element_type=jnp.float32)
        w, idx = jmoe.router_topk(logits, K, True, gate_act)
        w_te = jmoe.combine_weights(w, idx, E)
        g = jnp.einsum("th,eih->tei", xj, gp)
        u = jnp.einsum("th,eih->tei", xj, up)
        y = jnp.einsum("tei,ehi->teh", jmoe._expert_act(g, u, act), dp)
        return jnp.einsum("te,teh->th", w_te, y)
    if not jmoe._ragged_available():
        pytest.skip("installed jax lacks lax.ragged_dot_general")
    logits = jnp.einsum("th,eh->te", xj, router,
                        preferred_element_type=jnp.float32)
    w, idx = jmoe.router_topk(logits, K, True, gate_act)
    return jmoe._moe_ragged(xj, w, idx, gp, up, dp, act)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("route", moe.ROUTES)
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("t", [5, 40])
def test_moe_routes_match_jax_dispatches(t, ragged, route, act):
    bank = _bank(2)
    x = np.random.default_rng(3).normal(0, 1, (t, H)).astype(np.float32)
    want = _jax_moe(x, bank, ragged, "softmax", act)
    got = moe.moe_ffn(torch.from_numpy(x),
                      *map(torch.from_numpy, bank), K, True, "softmax", act,
                      route)
    _close(got, want)
    # and the reference's moe_ffn, whichever dispatch it takes at t
    _close(got, jmoe.moe_ffn(jnp.asarray(x), *map(jnp.asarray, bank), K,
                             True, "softmax", act))


@pytest.mark.parametrize("t", [3, 36])
def test_block_with_shared_expert_matches_jax(t):
    """Router (sigmoid gate too), experts, the shared expert and its
    sigmoid gate, through the block function of each package."""
    for gate_act in ("softmax", "sigmoid"):
        over = dict(shared_expert_intermediate_size=24)
        jcfg = dataclasses.replace(jax_tiny_config("qwen3_5_moe", **over),
                                   moe_gate_act=gate_act)
        cfg = dataclasses.replace(tiny_config("qwen3_5_moe", **over),
                                  moe_gate_act=gate_act)
        p = jax_init_moe(jcfg, jax.random.PRNGKey(t), jnp.float32)
        rng = np.random.default_rng(t)
        tree = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), p)
        x = rng.normal(0, 1, (1, t, cfg.hidden_size)).astype(np.float32)
        want = jax_moe_forward(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                            tree),
                               jnp.asarray(x))
        tp = jax.tree_util.tree_map(torch.from_numpy, tree)
        for rows in (False, True):
            _close(moe_forward(cfg, tp, torch.from_numpy(x), rows), want)


def test_route_choice():
    x = torch.zeros(4, H)
    assert moe.moe_route(x, rows=True) == "gathered"
    assert moe.moe_route(x, rows=False) == "dense"
    assert moe.moe_route(x.bfloat16(), rows=False) == "grouped"
    assert moe.moe_route(x.bfloat16(), rows=True) == "gathered"
    # float16 (module 16) takes the dense route: torch._grouped_mm
    # takes bfloat16 only
    assert moe.moe_route(x.half(), rows=False) == "dense"
    with pytest.raises(ValueError, match="no MoE prefill route"):
        moe.moe_route(x.double(), rows=False)
    with pytest.raises(ValueError, match="unknown MoE route"):
        moe.moe_ffn(x, *map(torch.from_numpy, _bank(0)), K, True,
                    route="ragged")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_alone_equals_in_company(dtype):
    """Row 3 of an 8-row step beside idle rows (zeros) and beside seven
    other tokens: the same bits (its k experts' products, its own
    combine)."""
    bank = [torch.from_numpy(b).to(dtype) for b in _bank(4)]
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (8, H)).astype(np.float32)).to(dtype)
    alone = torch.zeros_like(x)
    alone[3] = x[3]
    got = moe.moe_ffn(x, *bank, K, True, route="gathered")
    want = moe.moe_ffn(alone, *bank, K, True, route="gathered")
    assert torch.equal(got[3], want[3])
