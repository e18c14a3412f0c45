"""Generic decoder block (counterpart of
cake_tpu/models/common/layers.py): attention or Gated DeltaNet, MLP or
routed experts.

Parameters are nested dicts of tensors with the reference's keys
(`layers[i].self_attn.q_proj.weight`, ...), so a JAX parameter tree
carries across one to one (utils/weights.py). Forwards are plain
functions closed over the static ModelConfig/LayerSpec.

Positions: `pos0` is a host int for prefill (one sequence), a 0-d
device tensor for the traced prefill that a captured graph replays (with
`valid_len` a 0-d tensor too), or a [B] tensor of per-row positions for
the batched one-token decode step, where `valid_len` is then a [B] 0/1
tensor (a 0 row writes nothing), and for the batched speculative verify
(S = k + 1 tokens per row), where `valid_len` [B] is each row's count of
real tokens.

A layer cache is either a contiguous row cache {k, v, pos} or, in the
paged decode step and the paged verify, a layer's block pool with the
step's block tables {k, v, pos, tables} (see cache.init_paged_layers). In the traced prefill
it also carries "meta", the chunk's device int32 [3] {row, pos0,
valid_len}: the chunk's row of the cache's batch axis is meta[0], read
on the card (a slot of the pool, or 0 for a batch-1 view).
"""
from __future__ import annotations

import functools

import torch

from ...ops import (apply_rope, embedding, gelu_mul, linear,
                    make_attention_mask, multi_head_attention, rms_norm,
                    rope_tables, silu_mul)
from ...ops import flash as flash_ops
from ...ops import paged_attention as paged_ops
from ...ops.moe import moe_ffn, moe_route
from ..qwen3_5 import gdn_forward, init_gdn_params
from .cache import paged_write_entries, paged_write_entry, update_kv_cache
from .expert_provider import moe_ffn_offloaded
from .config import LayerSpec, ModelConfig

INIT_STD = 0.02


NORM_NAMES = {"pre": ("input_layernorm", "post_attention_layernorm"),
              "post": ("post_attention_layernorm",
                       "post_feedforward_layernorm"),
              "sandwich": ("input_layernorm", "post_attention_layernorm",
                           "pre_feedforward_layernorm",
                           "post_feedforward_layernorm")}

# the gated MLP's activation by config.hidden_act
ACTIVATIONS = {"silu": silu_mul, "gelu_tanh": gelu_mul}


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16, device="cpu",
                gen_device="cpu") -> dict:
    """Seeded random weights (std 0.02, ones for the norms). Drawn in
    float32 from a `torch.Generator` on `gen_device` and then cast and
    moved: with the default CPU generator one seed gives the same weights
    on every device; a generator on the card draws a model too large to
    draw on the host quickly (other bits than the CPU's for the seed)."""
    gen = torch.Generator(device=gen_device).manual_seed(seed)

    def normal(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen_device) * INIT_STD
        return w.to(device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    h, i = cfg.hidden_size, cfg.intermediate_size
    sq, skv = cfg.size_q, cfg.size_kv
    layers = []
    for spec in cfg.layer_specs():
        layer = {}
        if spec.kind == "linear":
            layer["linear_attn"] = init_gdn_params(cfg, normal, dtype,
                                                   device)
        else:
            layer["self_attn"] = _init_attention(cfg, spec, normal, ones,
                                                 dtype, device)
        layer["mlp"] = (_init_moe(cfg, normal) if spec.is_moe
                        else _init_mlp(normal, h, i))
        for name in NORM_NAMES[spec.norm_style]:
            layer[name] = {"weight": ones(h)}
        layers.append(layer)
    params = {"layers": layers,
              "embed_tokens": {"weight": normal(cfg.vocab_size, h)},
              "norm": {"weight": ones(h)}}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": normal(cfg.vocab_size, h)}
    return params


def _init_attention(cfg, spec, normal, ones, dtype, device) -> dict:
    h, sq, skv = cfg.hidden_size, cfg.size_q, cfg.size_kv
    # a gated layer's q_proj emits [q, gate] per head
    q_out = 2 * sq if gated_attention(cfg, spec) else sq
    attn = {"q_proj": {"weight": normal(q_out, h)},
            "k_proj": {"weight": normal(skv, h)},
            "v_proj": {"weight": normal(skv, h)},
            "o_proj": {"weight": normal(h, sq)}}
    if cfg.qkv_bias:
        for name, n in (("q_proj", q_out), ("k_proj", skv),
                        ("v_proj", skv)):
            attn[name]["bias"] = torch.zeros(n, dtype=dtype, device=device)
    if cfg.qk_norm:
        # OLMo2 norms the whole projection, the others each head
        pre = cfg.qk_norm_pre_reshape
        attn["q_norm"] = {"weight": ones(sq if pre else cfg.head_dim)}
        attn["k_norm"] = {"weight": ones(skv if pre else cfg.head_dim)}
    return attn


def _init_mlp(normal, h: int, i: int) -> dict:
    return {"gate_proj": {"weight": normal(i, h)},
            "up_proj": {"weight": normal(i, h)},
            "down_proj": {"weight": normal(h, i)}}


def _init_moe(cfg, normal) -> dict:
    """The router, the stacked expert banks (gate/up [E, I, H], down [E,
    H, I]) and, when configured, the shared expert and its gate."""
    h, e, i = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    p = {"gate": {"weight": normal(e, h)},
         "experts": {"gate_proj": normal(e, i, h),
                     "up_proj": normal(e, i, h),
                     "down_proj": normal(e, h, i)}}
    if cfg.shared_expert_intermediate_size:
        p["shared_expert"] = _init_mlp(normal, h,
                                       cfg.shared_expert_intermediate_size)
        p["shared_expert_gate"] = {"weight": normal(1, h)}
    return p


def gated_attention(cfg: ModelConfig, spec: LayerSpec) -> bool:
    """A full-attention layer with the sigmoid output gate (Qwen3.5)."""
    return cfg.attn_output_gate and spec.kind == "full"


def make_rope(cfg: ModelConfig, device) -> dict:
    """{cos, sin}, and for Gemma3 {cos_local, sin_local} at
    rope_local_base_freq, never scaled (the reference's make_rope)."""
    cos, sin = rope_tables(cfg.max_seq_len, cfg.rotary_dim, cfg.rope_theta,
                           cfg.rope_scaling, device=device)
    rope = {"cos": cos, "sin": sin}
    if cfg.local_rope_theta is not None:
        rope["cos_local"], rope["sin_local"] = rope_tables(
            cfg.max_seq_len, cfg.rotary_dim, cfg.local_rope_theta,
            device=device)
    return rope


def _positions(pos0, s: int, device) -> torch.Tensor:
    """[S] positions for a host int or 0-d tensor pos0, [B, S] for a [B]
    tensor."""
    ar = torch.arange(s, device=device)
    if torch.is_tensor(pos0) and pos0.dim():
        return pos0.long()[:, None] + ar[None, :]
    return pos0 + ar


def _chunk_row(layer_cache: dict, name: str) -> torch.Tensor:
    """The batch-1 row a prefill chunk attends over: the buffer itself when
    it is batch 1 (an eager row view, a paged view), else row meta[0] of
    a traced prefill's pool, taken on the card."""
    buf = layer_cache[name]
    if buf.shape[0] == 1:
        return buf
    return buf.index_select(0, layer_cache["meta"][:1].long())


def attention_forward(cfg: ModelConfig, spec: LayerSpec, p: dict,
                      x: torch.Tensor, layer_cache: dict, pos0,
                      rope: dict, valid_len=None, flash_mode: str = "off"):
    """x: [B, S, H]. Returns (y [B, S, H], layer_cache updated in place).

    Flash dispatch as the reference's (layers.py:221-267): a chunk of
    width >= FLASH_MIN_SEQ takes the flash kernel in "fresh" mode (pos0 0:
    causal over the in-pass K/V, window included) or "append" mode
    (scatter the chunk into the unwrapped cache row, then flash over the
    row with q_offset = pos0). On a CPU tensor the flash wrapper computes
    its plain version, so the CPU walks the same branch as the card.

    A traced prefill (layer_cache["meta"] present) takes the same branches
    with nothing read on the host: flash in its device-meta form (append
    over the whole pool, row meta[0]), the traced cache write, and the
    masked path over the chunk's row taken on the card."""
    b, s, _ = x.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    scale = cfg.attn_scale
    q = linear(x, p["q_proj"]["weight"], p["q_proj"].get("bias"))
    k = linear(x, p["k_proj"]["weight"], p["k_proj"].get("bias"))
    v = linear(x, p["v_proj"]["weight"], p["v_proj"].get("bias"))
    gate = None
    if gated_attention(cfg, spec):
        # per head [q, gate]: the gate's sigmoid scales the output
        qg = q.reshape(b, s, hq, 2 * d)
        q = qg[..., :d].reshape(b, s, hq * d)
        gate = qg[..., d:].reshape(b, s, hq * d)
    if cfg.qk_norm and cfg.qk_norm_pre_reshape:
        q = rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps)
    q = q.reshape(b, s, hq, d)
    k = k.reshape(b, s, hkv, d)
    v = v.reshape(b, s, hkv, d)
    if cfg.qk_norm and not cfg.qk_norm_pre_reshape:
        q = rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps)
    positions = _positions(pos0, s, x.device)
    if spec.use_rope:
        suffix = "_local" if spec.local_rope_table else ""
        cos, sin = rope["cos" + suffix], rope["sin" + suffix]
        rp = positions
        if positions.dim() == 2 and s > 1:
            # a verify's padded tail may run past the table near the end
            # of the context: those rows are never used
            rp = positions.clamp(max=cos.shape[0] - 1)
        q = apply_rope(q, cos, sin, rp, cfg.rotary_dim)
        k = apply_rope(k, cos, sin, rp, cfg.rotary_dim)

    use_flash = s >= flash_ops.FLASH_MIN_SEQ and (
        flash_mode == "fresh"
        or (flash_mode == "append" and spec.window is None))
    meta = None if layer_cache is None else layer_cache.get("meta")
    row = None if meta is None else meta[:1]
    if layer_cache is None:
        # stateless (an encoder: the reference's cache=None branch with
        # flash off): causal over the in-pass keys, pad keys (index >=
        # valid_len) invisible
        q_pos = positions[None, :].expand(b, s)
        kv_pos = q_pos if valid_len is None else torch.where(
            torch.arange(s, device=x.device) < valid_len, q_pos, -1)
        mask = make_attention_mask(q_pos, kv_pos, window=spec.window)
        y = multi_head_attention(q, k, v, mask, scale)
    elif use_flash and flash_mode == "fresh":
        if meta is None:
            y = flash_ops.flash_attention(q, k, v, scale=scale,
                                          valid_len=valid_len,
                                          window=spec.window, mode="fresh")
        else:
            y = flash_ops.flash_attention_meta(q, k, v, meta, "fresh",
                                               scale=scale,
                                               window=spec.window)
        update_kv_cache(layer_cache, k, v, pos0, valid_len, row)
    elif use_flash:
        update_kv_cache(layer_cache, k, v, pos0, valid_len, row)
        if meta is None:
            y = flash_ops.flash_attention(q, layer_cache["k"],
                                          layer_cache["v"], scale=scale,
                                          valid_len=valid_len, q_offset=pos0,
                                          mode="append")
        else:
            y = flash_ops.flash_attention_meta(q, layer_cache["k"],
                                               layer_cache["v"], meta,
                                               "append", scale=scale)
    elif s == 1 and "tables" in layer_cache:
        # paged decode: write the new entry into its block, then attend
        # over the row's live blocks through the table (the kernel on the
        # card)
        write = (torch.ones(b, dtype=torch.bool, device=x.device)
                 if valid_len is None else valid_len.bool())
        paged_write_entry(layer_cache, layer_cache["tables"], k, v, pos0,
                          write)
        y = paged_ops.paged_decode_attention(
            q.contiguous(), layer_cache["k"], layer_cache["v"], layer_cache["pos"],
            layer_cache["tables"], pos0.to(torch.int32), scale)
    elif "tables" in layer_cache:
        # paged verify: write the k + 1 entries into their reserved blocks
        # (padding and inactive rows to the sink), then one paged kernel
        # call over the flattened rows, row (b, i) at frontier pos[b] + i:
        # causal among the drafts by the kernel's visibility rule. The
        # model drops the rejected entries once the accept is known
        paged_write_entries(layer_cache, layer_cache["tables"], k, v, pos0,
                            valid_len)
        y = paged_ops.paged_verify_attention(
            q.contiguous(), layer_cache["k"], layer_cache["v"],
            layer_cache["pos"], layer_cache["tables"], pos0.to(torch.int32),
            scale)
    elif s == 1:
        # decode: write the new entry first, then attend over the buffer
        # (for a ring, the overwritten slot is exactly the one the window
        # mask hides)
        update_kv_cache(layer_cache, k, v, pos0, valid_len)
        q_pos = positions if torch.is_tensor(pos0) else \
            positions[None, :].expand(b, s)
        mask = make_attention_mask(q_pos, layer_cache["pos"],
                                   window=spec.window)
        y = multi_head_attention(q, layer_cache["k"], layer_cache["v"], mask,
                                 scale)
    else:
        # a chunk too short for flash (one row's prefill chunk, or the
        # batched verify's k + 1 tokens per row): attend over [cache ;
        # chunk]; pad keys (index >= valid_len: a host int, a 0-d tensor,
        # or [B] per row) are invisible
        batched = positions.dim() == 2
        ck, cv, cp = ((layer_cache[n] if batched else _chunk_row(layer_cache,
                                                                 n))
                      for n in ("k", "v", "pos"))
        q_pos = positions if batched else positions[None, :].expand(b, s)
        kv_pos_new = q_pos
        if valid_len is not None:
            vl = valid_len[:, None] if batched else valid_len
            kv_pos_new = torch.where(torch.arange(s, device=x.device)
                                     < vl, q_pos, -1)
        kv_pos = torch.cat([cp, kv_pos_new.to(cp.dtype)], 1)
        mask = make_attention_mask(q_pos, kv_pos, window=spec.window)
        y = multi_head_attention(q, torch.cat([ck, k], 1),
                                 torch.cat([cv, v], 1), mask, scale)
        if batched:
            # the verify's entries are held back until the accept is
            # known, then only the committed ones are written (the model's
            # commit): a ring row keeps every entry its window still needs
            layer_cache["held"] = (k, v)
        else:
            update_kv_cache(layer_cache, k, v, pos0, valid_len, row)
    y = y.reshape(b, s, hq * d)
    if gate is not None:
        y = y * torch.sigmoid(gate.float()).to(y.dtype)
    return linear(y, p["o_proj"]["weight"]), layer_cache


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS.get(cfg.hidden_act)
    if act is None:
        raise ValueError(f"hidden_act {cfg.hidden_act!r} is not ported")
    gate = linear(x, p["gate_proj"]["weight"])
    up = linear(x, p["up_proj"]["weight"])
    return linear(act(gate, up), p["down_proj"]["weight"])


def moe_forward(cfg: ModelConfig, p: dict, x: torch.Tensor,
                rows: bool) -> torch.Tensor:
    """Routed experts (ops/moe.py; `rows`: the tokens are decode or verify
    rows, else one prefill chunk) plus, when present, the always-active
    shared expert scaled by sigmoid(shared_expert_gate). A layer loaded
    with expert offload holds a `_provider` in place of the banks: its
    experts are read on demand (expert_provider.moe_ffn_offloaded, the
    reference's branch), eagerly only."""
    b, s, h = x.shape
    flat = x.reshape(b * s, h)
    act = "gelu" if cfg.hidden_act == "gelu_tanh" else "silu"
    if "_provider" in p:
        y = moe_ffn_offloaded(flat, p["gate"]["weight"], p["_provider"],
                              cfg.num_experts_per_tok, cfg.norm_topk_prob,
                              cfg.moe_gate_act, act, rows)
    else:
        e = p["experts"]
        y = moe_ffn(flat, p["gate"]["weight"], e["gate_proj"],
                    e["up_proj"], e["down_proj"], cfg.num_experts_per_tok,
                    cfg.norm_topk_prob, cfg.moe_gate_act, act,
                    moe_route(flat, rows))
    if "shared_expert" in p:
        sh = mlp_forward(cfg, p["shared_expert"], flat)
        g = torch.sigmoid(linear(flat, p["shared_expert_gate"]["weight"])
                          .float())
        y = y + sh * g.to(sh.dtype)
    return y.reshape(b, s, h)


def _ffn(cfg, spec, p, x, pos0):
    if spec.is_moe:
        return moe_forward(cfg, p["mlp"], x,
                           torch.is_tensor(pos0) and pos0.dim() == 1)
    return mlp_forward(cfg, p["mlp"], x)


def _attn(cfg, spec, p, x, layer_cache, pos0, rope, valid_len, flash_mode):
    if spec.kind == "linear":
        return gdn_forward(cfg, p["linear_attn"], x, layer_cache, pos0,
                           valid_len)
    return attention_forward(cfg, spec, p["self_attn"], x, layer_cache,
                             pos0, rope, valid_len, flash_mode)


def block_forward(cfg: ModelConfig, spec: LayerSpec, p: dict,
                  x: torch.Tensor, layer_cache: dict, pos0,
                  rope: dict, valid_len=None, flash_mode: str = "off"):
    """One decoder block: pre-norm (norm, sublayer, residual add),
    post-norm (OLMo2, EXAONE4: sublayer, norm of its output, residual
    add; no input_layernorm) or sandwich (Gemma3: norm, sublayer, norm of
    its output, residual add, for both sublayers). The attention sublayer
    is a Gated DeltaNet on a linear layer, the MLP routed experts on an
    MoE layer."""
    eps = cfg.rms_norm_eps
    if spec.norm_style == "pre":
        h = rms_norm(x, p["input_layernorm"]["weight"], eps)
        attn_out, layer_cache = _attn(cfg, spec, p, h, layer_cache, pos0,
                                      rope, valid_len, flash_mode)
        x = x + attn_out
        h = rms_norm(x, p["post_attention_layernorm"]["weight"], eps)
        return x + _ffn(cfg, spec, p, h, pos0), layer_cache
    if spec.norm_style == "post":
        attn_out, layer_cache = _attn(cfg, spec, p, x, layer_cache, pos0,
                                      rope, valid_len, flash_mode)
        x = x + rms_norm(attn_out, p["post_attention_layernorm"]["weight"],
                         eps)
        return x + rms_norm(_ffn(cfg, spec, p, x, pos0),
                            p["post_feedforward_layernorm"]["weight"],
                            eps), layer_cache
    if spec.norm_style == "sandwich":
        h = rms_norm(x, p["input_layernorm"]["weight"], eps)
        attn_out, layer_cache = _attn(cfg, spec, p, h, layer_cache, pos0,
                                      rope, valid_len, flash_mode)
        x = x + rms_norm(attn_out, p["post_attention_layernorm"]["weight"],
                         eps)
        h = rms_norm(x, p["pre_feedforward_layernorm"]["weight"], eps)
        return x + rms_norm(_ffn(cfg, spec, p, h, pos0),
                            p["post_feedforward_layernorm"]["weight"],
                            eps), layer_cache
    raise ValueError(f"norm style {spec.norm_style!r} is not ported")


def forward_layers(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   layers: list[dict], pos0, rope: dict,
                   valid_len=None, flash_mode: str = "off",
                   layer_range: tuple[int, int] | None = None
                   ) -> torch.Tensor:
    """Run the blocks over hidden states x; `layers` (the per-layer cache
    list) is updated in place, or None: stateless, causal attention over
    the pass alone (an encoder's). layer_range [lo, hi): run only those
    blocks, with params["layers"] and `layers` holding that range alone
    (a cluster stage's; the reference's forward_layers(layer_range=));
    default every block."""
    lo, hi = layer_range or (0, cfg.num_hidden_layers)
    for j, spec in enumerate(cfg.layer_specs()[lo:hi]):
        x, _ = block_forward(cfg, spec, params["layers"][j], x,
                             None if layers is None else layers[j],
                             pos0, rope, valid_len, flash_mode)
    return x


def embed_tokens(cfg: ModelConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = embedding(tokens, params["embed_tokens"]["weight"])
    if cfg.embed_scale is not None:
        # Gemma: the scale is rounded to the model dtype first (sqrt(1152)
        # = 33.94 is 34.0 in bf16), as the reference multiplies by
        # jnp.asarray(embed_scale, x.dtype); a host number, so that a
        # captured program copies nothing to the card
        x = x * _rounded(cfg.embed_scale, x.dtype)
    return x


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """value rounded to dtype, as a host float."""
    return float(torch.tensor(value, dtype=dtype))


def lm_head_logits(cfg: ModelConfig, params: dict,
                   x_last: torch.Tensor) -> torch.Tensor:
    """Final norm + head -> float32 logits."""
    h = rms_norm(x_last, params["norm"]["weight"], cfg.rms_norm_eps)
    w = (params["embed_tokens"]["weight"] if cfg.tie_word_embeddings
         else params["lm_head"]["weight"])
    return linear(h, w).float()
