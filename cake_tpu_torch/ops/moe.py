"""Mixture-of-Experts routing and dispatch (counterpart of
cake_tpu/ops/moe.py: router_topk, combine_weights, moe_ffn).

One router for every route: softmax (or sigmoid) scores over the experts
in float32, top-k, optional renormalisation of the k weights. The expert
banks are stacked: gate/up [E, I, H], down [E, H, I]. The reference picks
its dispatch by the static token count (dense combine below 32 tokens, a
sort-based ragged segment GEMM from 32 up). The port picks by what the
tokens are and by dtype, never by catching a failure:

  * "gathered" (decode and verify rows: tokens of different requests):
    each (token, expert) assignment's slices are gathered by index into a
    static [T*k, ...] batch and multiplied there, so a row reads only its
    own k experts (not the E banks the dense combine reads) and its
    result depends on no other row. No host read and no data-dependent
    shape, so a captured decode or verify graph replays it;
  * "grouped" (a bf16 prefill chunk: one request's tokens): the T*k
    assignments are sorted by expert on the device, group ends found by
    searchsorted, and each expert's contiguous slice multiplied by
    PyTorch's grouped GEMM (`torch._grouped_mm`, device-side offsets; a
    library GEMM where the reference uses XLA's ragged_dot_general), the
    reference's `_moe_ragged` formula; capturable;
  * "dense" (a float32 prefill chunk): the reference's dense formula,
    every expert on every token and a [T, E] combine matrix.

"gathered" and "grouped" combine the k expert outputs in float32 with
the router's float32 weights, as `_moe_ragged` does, and un-sort by a
permutation (no atomic adds), so a captured program and its eager run
give the same bits. "dense" casts the combine matrix to the model dtype,
as the reference's dense path does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ROUTES = ("gathered", "grouped", "dense")


def router_topk(logits: torch.Tensor, k: int, norm_topk_prob: bool,
                gate_act: str = "softmax"):
    """logits [T, E] -> (weights [T, k] float32, idx [T, k] int32)."""
    lf = logits.float()
    if gate_act == "softmax":
        probs = torch.softmax(lf, dim=-1)
    elif gate_act == "sigmoid":
        probs = torch.sigmoid(lf)
    else:
        raise ValueError(f"unknown gate activation {gate_act}")
    weights, idx = torch.topk(probs, k, dim=-1)
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx.to(torch.int32)


def combine_weights(weights: torch.Tensor, idx: torch.Tensor,
                    num_experts: int) -> torch.Tensor:
    """Top-k (weight, index) scattered into a dense [T, E] matrix."""
    w = torch.zeros(weights.shape[0], num_experts, dtype=weights.dtype,
                    device=weights.device)
    return w.scatter_add_(1, idx.long(), weights)


def _act(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(g) * u
    return F.gelu(g, approximate="tanh") * u


def moe_route(x: torch.Tensor, rows: bool) -> str:
    """The route of T tokens: `rows` (tokens of different requests, the
    decode and verify steps) -> "gathered"; a prefill chunk -> "grouped"
    in bfloat16 (torch._grouped_mm takes bfloat16 only), "dense" in
    float32 and float16."""
    if rows:
        return "gathered"
    if x.dtype == torch.bfloat16:
        return "grouped"
    if x.dtype in (torch.float32, torch.float16):
        return "dense"
    raise ValueError(f"no MoE prefill route for dtype {x.dtype}")


def moe_ffn(x: torch.Tensor, router_weight: torch.Tensor,
            gate_proj: torch.Tensor, up_proj: torch.Tensor,
            down_proj: torch.Tensor, k: int, norm_topk_prob: bool,
            gate_act: str = "softmax", act: str = "silu",
            route: str = "gathered") -> torch.Tensor:
    """x [T, H] -> [T, H] in x.dtype. The router's logits are float32
    products, as the reference's einsum with a float32 result."""
    logits = torch.matmul(x.float(), router_weight.float().t())
    weights, idx = router_topk(logits, k, norm_topk_prob, gate_act)
    if route == "gathered":
        return moe_gathered(x, weights, idx, gate_proj, up_proj, down_proj,
                            act)
    if route == "grouped":
        return moe_grouped(x, weights, idx, gate_proj, up_proj, down_proj,
                           act)
    if route == "dense":
        return moe_dense(x, weights, idx, gate_proj, up_proj, down_proj,
                         act)
    raise ValueError(f"unknown MoE route {route!r} (one of {ROUTES})")


def _combine(y: torch.Tensor, weights: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """y [T*k, H] in assignment order -> sum over each token's k in
    float32, in a fixed order."""
    t, k = weights.shape
    y = y.float().view(t, k, -1)
    return (y * weights[..., None]).sum(dim=1).to(dtype)


def moe_gathered(x, weights, idx, gate_proj, up_proj, down_proj,
                 act: str = "silu") -> torch.Tensor:
    """Each assignment multiplies its own expert's slices, gathered into a
    [T*k, I, H] batch: one matrix-vector product per assignment."""
    k = idx.shape[1]
    flat = idx.reshape(-1).long()
    xs = x.repeat_interleave(k, dim=0)[:, :, None]          # [T*k, H, 1]
    g = torch.bmm(gate_proj.index_select(0, flat), xs)[..., 0]
    u = torch.bmm(up_proj.index_select(0, flat), xs)[..., 0]
    a = _act(g, u, act)
    y = torch.bmm(down_proj.index_select(0, flat), a[:, :, None])[..., 0]
    return _combine(y, weights, x.dtype)


def moe_grouped(x, weights, idx, gate_proj, up_proj, down_proj,
                act: str = "silu") -> torch.Tensor:
    """The assignments sorted by expert (stable), each expert's contiguous
    slice through one grouped GEMM per projection, offsets on the device."""
    if not hasattr(torch, "_grouped_mm"):
        raise RuntimeError("the grouped MoE route needs torch._grouped_mm, "
                           f"which torch {torch.__version__} lacks")
    t, k = idx.shape
    e = gate_proj.shape[0]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ends = torch.searchsorted(
        flat.index_select(0, order),
        torch.arange(e, dtype=flat.dtype, device=flat.device),
        right=True).to(torch.int32)                         # [E] group ends
    xs = x.index_select(0, torch.div(order, k, rounding_mode="floor"))
    g = torch._grouped_mm(xs, gate_proj.transpose(1, 2), offs=ends)
    u = torch._grouped_mm(xs, up_proj.transpose(1, 2), offs=ends)
    a = _act(g, u, act).to(x.dtype)
    y = torch._grouped_mm(a, down_proj.transpose(1, 2), offs=ends)
    y = torch.empty_like(y).index_copy_(0, order, y)        # un-sort
    return _combine(y, weights, x.dtype)


def moe_dense(x, weights, idx, gate_proj, up_proj, down_proj,
              act: str = "silu") -> torch.Tensor:
    """The reference's dense combine: every expert on every token."""
    w_te = combine_weights(weights, idx, gate_proj.shape[0]).to(x.dtype)
    g = torch.einsum("th,eih->tei", x, gate_proj)
    u = torch.einsum("th,eih->tei", x, up_proj)
    y_e = torch.einsum("tei,ehi->teh", _act(g, u, act), down_proj)
    return torch.einsum("te,teh->th", w_te, y_e).to(x.dtype)
