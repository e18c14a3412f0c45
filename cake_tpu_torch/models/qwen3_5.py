"""Qwen3.5 / Qwen3-Next hybrid Gated DeltaNet linear attention
(counterpart of cake_tpu/models/qwen3_5.py).

Semantics are the reference's:
  1. fused in_proj -> [Q | K | V (the conv channels) | a | b | z];
  2. causal depthwise conv1d + SiLU over the conv channels, with a
     [B, C, K-1] carry of the last K-1 valid inputs;
  3. q and k L2-normalised per head, q also scaled by Dk^-0.5; key heads
     repeated up to the value heads;
  4. gates g = -exp(A_log) * softplus(a + dt_bias), beta = sigmoid(b);
  5. the delta rule in float32, per step: S = S * exp(g); r = S^T k;
     S += k (beta (v - r))^T; o = S^T q; a step at or past the valid
     length leaves S as it was;
  6. output: rms_norm(o) * w * silu(z) (w as stored), then out_proj.

The recurrence is plain torch over time (the reference's lax.scan): one
small batch of ops per step, which a captured graph replays as they are.

A layer's cache is {"conv": [B, C, K-1] in the model dtype, "state":
[B, Hv, Dk, Dv] float32}, written IN PLACE. The forms follow
layers.attention_forward's: a host-int prefill into a batch-1 row view;
a traced prefill (layer_cache["meta"], its row meta[0], pos0 and
valid_len 0-d device tensors), which reads nothing on the host; and the
batched rows of a decode step (S 1, valid_len [B] 0/1) or of a verify
(S k + 1, valid_len [B] the real tokens). A verify writes nothing in its
pass: it stashes each step's state and the conv inputs in
layer_cache["held_linear"], and `gdn_commit` installs the state after the
committed tokens once the accept is known, which equals the reference's
re-forward at valid_len = n_acc + 1 without running it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.linear import linear
from ..ops.norms import rms_norm_gated

CONV_STD = 0.2      # the reference's init of the conv weights
# parameters kept in float32 whatever the model dtype (the reference's
# loader keeps them so: they feed exp() and softplus() every step)
F32_PARAMS = ("A_log", "dt_bias")


def _dims(cfg):
    la = cfg.linear_attn
    key_dim = la.num_key_heads * la.key_head_dim
    value_dim = la.num_value_heads * la.value_head_dim
    conv_dim = 2 * key_dim + value_dim
    total = conv_dim + 2 * la.num_value_heads + value_dim
    return la, key_dim, value_dim, conv_dim, total


def init_gdn_params(cfg, normal, dtype, device) -> dict:
    """`normal(*shape)`: the caller's seeded N(0, 0.02^2) draw in dtype."""
    la, key_dim, value_dim, conv_dim, total = _dims(cfg)
    h = cfg.hidden_size
    hv = la.num_value_heads
    return {
        "in_proj": {"weight": normal(total, h)},
        "conv1d": {"weight": normal(conv_dim, 1, la.conv_kernel_dim)
                   * (CONV_STD / 0.02)},
        "dt_bias": torch.zeros(hv, dtype=torch.float32, device=device),
        "A_log": torch.zeros(hv, dtype=torch.float32, device=device),
        "norm": {"weight": torch.ones(la.value_head_dim, dtype=dtype,
                                      device=device)},
        "out_proj": {"weight": normal(h, value_dim)},
    }


def init_linear_cache(cfg, batch: int, dtype: torch.dtype, device) -> dict:
    la, key_dim, value_dim, conv_dim, total = _dims(cfg)
    return {
        "conv": torch.zeros(batch, conv_dim, la.conv_kernel_dim - 1,
                            dtype=dtype, device=device),
        "state": torch.zeros(batch, la.num_value_heads, la.key_head_dim,
                             la.value_head_dim, dtype=torch.float32,
                             device=device),
    }


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _conv_carry(padded: torch.Tensor, vl, width: int) -> torch.Tensor:
    """The K-1 conv inputs ending at the last valid one: padded[:, :, vl :
    vl + K-1] for a host int, per row for a [B] tensor."""
    if not torch.is_tensor(vl):
        return padded[:, :, vl:vl + width]
    idx = vl.long()[:, None] + torch.arange(width, device=padded.device)
    return torch.gather(padded, 2, idx[:, None, :].expand(
        padded.shape[0], padded.shape[1], width))


def gdn_forward(cfg, p: dict, x: torch.Tensor, layer_cache: dict, pos0,
                valid_len=None):
    """x [B, S, H] -> (y [B, S, H], layer_cache updated in place)."""
    la, key_dim, value_dim, conv_dim, total = _dims(cfg)
    b, s, _ = x.shape
    hk, hv = la.num_key_heads, la.num_value_heads
    dk, dv = la.key_head_dim, la.value_head_dim
    kw = la.conv_kernel_dim - 1
    dev = x.device
    meta = layer_cache.get("meta")
    rows = torch.is_tensor(pos0) and pos0.dim() == 1
    conv0, state0 = layer_cache["conv"], layer_cache["state"]
    row = None
    if meta is not None and conv0.shape[0] != b:
        row = meta[:1].long()
        conv0, state0 = conv0.index_select(0, row), state0.index_select(0,
                                                                       row)
    # per-row valid lengths: [B] for rows, [1] for a traced chunk, a host
    # int for an eager chunk
    if valid_len is None:
        vl = s
    elif torch.is_tensor(valid_len):
        vl = valid_len.reshape(-1).expand(b) if valid_len.dim() == 0 \
            else valid_len
    else:
        vl = max(0, min(int(valid_len), s))

    proj = linear(x, p["in_proj"]["weight"]).float()
    mixed = proj[..., :conv_dim]
    a = proj[..., conv_dim:conv_dim + hv]
    bg = proj[..., conv_dim + hv:conv_dim + 2 * hv]
    z = proj[..., conv_dim + 2 * hv:]

    # causal depthwise conv + SiLU over [carry ; chunk], a fixed order of
    # K products per output
    padded = torch.cat([conv0.float(), mixed.transpose(1, 2)], dim=2)
    w = p["conv1d"]["weight"].float()[:, 0]                  # [C, K]
    y = padded[:, :, 0:s] * w[None, :, 0:1]
    for j in range(1, kw + 1):
        y = y + padded[:, :, j:j + s] * w[None, :, j:j + 1]
    y = F.silu(y).transpose(1, 2)                            # [B, S, C]

    q = y[..., :key_dim].reshape(b, s, hk, dk)
    k = y[..., key_dim:2 * key_dim].reshape(b, s, hk, dk)
    v = y[..., 2 * key_dim:].reshape(b, s, hv, dv)
    if hk < hv:
        q = q.repeat_interleave(hv // hk, dim=2)
        k = k.repeat_interleave(hv // hk, dim=2)
    q = _l2norm(q) / (dk ** 0.5)
    k = _l2norm(k)
    g = -torch.exp(p["A_log"].float()) * F.softplus(a + p["dt_bias"].float())
    beta = torch.sigmoid(bg)

    # the delta rule over time, inputs time-major so each step's slices
    # are contiguous
    decay = torch.exp(g).transpose(0, 1).contiguous()        # [S, B, Hv]
    beta_t = beta.transpose(0, 1).contiguous()
    q_t = q.transpose(0, 1).contiguous()                     # [S, B, Hv, Dk]
    k_t = k.transpose(0, 1).contiguous()
    v_t = v.transpose(0, 1).contiguous()                     # [S, B, Hv, Dv]
    steps = torch.arange(s, device=dev)
    ok = (steps[:, None] < vl[None, :] if torch.is_tensor(vl)
          else (steps < vl)[:, None].expand(s, b))           # [S, B]
    held = rows and s > 1
    state = state0
    outs, states = [], []
    for t in range(s):
        decayed = state * decay[t][..., None, None]
        kt = k_t[t][:, :, None, :]                           # [B, Hv, 1, Dk]
        retrieved = torch.matmul(kt, decayed)                # [B, Hv, 1, Dv]
        delta = (v_t[t][:, :, None, :] - retrieved) * beta_t[t][..., None,
                                                                None]
        updated = decayed + kt.transpose(-1, -2) * delta
        outs.append(torch.matmul(q_t[t][:, :, None, :], updated))
        state = torch.where(ok[t][:, None, None, None], updated, state)
        if held:
            states.append(state)
    out = torch.cat(outs, dim=2).transpose(1, 2)             # [B, S, Hv, Dv]

    o = rms_norm_gated(out, z.reshape(b, s, hv, dv),
                       p["norm"]["weight"].float(), cfg.rms_norm_eps)
    y_out = linear(o.reshape(b, s, value_dim).to(x.dtype),
                   p["out_proj"]["weight"])

    if held:
        layer_cache["held_linear"] = (padded, torch.stack(states, 1), state0)
        return y_out, layer_cache
    conv = _conv_carry(padded, vl, kw).to(layer_cache["conv"].dtype)
    if row is not None:
        layer_cache["conv"].index_copy_(0, row, conv)
        layer_cache["state"].index_copy_(0, row, state)
    else:
        layer_cache["conv"].copy_(conv)
        layer_cache["state"].copy_(state)
    return y_out, layer_cache


def gdn_commit(layer_cache: dict, held, commit: torch.Tensor) -> dict:
    """Install a verify's linear state after `commit` [B] tokens per row
    (0: the row keeps its state), in place: the conv carry of the K-1
    inputs ending at the last committed one, and the recurrent state after
    the last committed step."""
    padded, states, state0 = held
    b = states.shape[0]
    kw = layer_cache["conv"].shape[2]
    c = commit.long()
    layer_cache["conv"].copy_(_conv_carry(padded, c, kw).to(
        layer_cache["conv"].dtype))
    last = states[torch.arange(b, device=c.device), (c - 1).clamp(min=0)]
    layer_cache["state"].copy_(torch.where((c > 0)[:, None, None, None],
                                           last, state0))
    return layer_cache


# -- checkpoint IO ----------------------------------------------------------


def flat_from_hf_qkvz_ba(cfg, qkvz: torch.Tensor,
                         ba: torch.Tensor) -> torch.Tensor:
    """HF Qwen3-Next `in_proj_qkvz` / `in_proj_ba` -> the fused [Q | K | V |
    a | b | z] rows. HF packs per key head [q (dk), k (dk), v (n dv), z (n
    dv)] and [b (n), a (n)], n = Hv / Hk."""
    la, key_dim, value_dim, conv_dim, total = _dims(cfg)
    ng, hv = la.num_key_heads, la.num_value_heads
    n, dk, dv = hv // ng, la.key_head_dim, la.value_head_dim
    h = qkvz.shape[-1]
    qkvz = qkvz.reshape(ng, 2 * dk + 2 * n * dv, h)
    q, k = qkvz[:, :dk], qkvz[:, dk:2 * dk]
    v, z = qkvz[:, 2 * dk:2 * dk + n * dv], qkvz[:, 2 * dk + n * dv:]
    ba = ba.reshape(ng, 2 * n, h)
    bb, a = ba[:, :n], ba[:, n:]
    return torch.cat([q.reshape(key_dim, h), k.reshape(key_dim, h),
                      v.reshape(value_dim, h), a.reshape(hv, h),
                      bb.reshape(hv, h), z.reshape(value_dim, h)], dim=0)


def hf_qkvz_ba_from_flat(cfg, in_proj: torch.Tensor):
    """Inverse of flat_from_hf_qkvz_ba: (qkvz, ba)."""
    la, key_dim, value_dim, conv_dim, total = _dims(cfg)
    ng, hv = la.num_key_heads, la.num_value_heads
    n, dk, dv = hv // ng, la.key_head_dim, la.value_head_dim
    w = in_proj
    h = w.shape[-1]
    q = w[:key_dim].reshape(ng, dk, h)
    k = w[key_dim:2 * key_dim].reshape(ng, dk, h)
    v = w[2 * key_dim:conv_dim].reshape(ng, n * dv, h)
    a = w[conv_dim:conv_dim + hv].reshape(ng, n, h)
    bb = w[conv_dim + hv:conv_dim + 2 * hv].reshape(ng, n, h)
    z = w[conv_dim + 2 * hv:].reshape(ng, n * dv, h)
    qkvz = torch.cat([q, k, v, z], dim=1).reshape(
        2 * key_dim + 2 * value_dim, h)
    ba = torch.cat([bb, a], dim=1).reshape(2 * hv, h)
    return qkvz, ba


def load_gdn_params(loader, lp: str) -> dict:
    """A linear layer's parameters under `{lp}.linear_attn.`: in_proj
    fused, as HF Qwen3-Next's qkvz + ba, or split qkv / a / b / z; conv1d
    as [C, 1, K] or [C, K, 1]; A_log and dt_bias in float32; the gated
    norm's weight as stored. Every tensor loads dense (a native FP8 one
    dequantized), as the reference's loader reads them."""
    cfg = loader.cfg
    base = f"{lp}.linear_attn"
    get = loader._get_dense
    if loader._has(f"{base}.in_proj.weight"):
        in_proj = get(f"{base}.in_proj.weight")
    elif loader._has(f"{base}.in_proj_qkvz.weight"):
        in_proj = flat_from_hf_qkvz_ba(cfg, get(f"{base}.in_proj_qkvz.weight"),
                                       get(f"{base}.in_proj_ba.weight"))
    else:
        in_proj = torch.cat([get(f"{base}.in_proj_{n}.weight")
                             for n in ("qkv", "a", "b", "z")], dim=0)
    conv = get(f"{base}.conv1d.weight")
    if conv.dim() == 3 and conv.shape[1] != 1:              # [C, K, 1]
        conv = conv.transpose(1, 2).contiguous()
    return {
        "in_proj": {"weight": in_proj},
        "conv1d": {"weight": conv},
        "dt_bias": get(f"{base}.dt_bias", torch.float32),
        "A_log": get(f"{base}.A_log", torch.float32),
        "norm": {"weight": get(f"{base}.norm.weight")},
        "out_proj": {"weight": get(f"{base}.out_proj.weight")},
    }


def export_gdn_params(cfg, p: dict, lp: str) -> dict:
    """HF Qwen3-Next names: in_proj as in_proj_qkvz + in_proj_ba."""
    base = f"{lp}.linear_attn"
    qkvz, ba = hf_qkvz_ba_from_flat(cfg, p["in_proj"]["weight"])
    return {
        f"{base}.in_proj_qkvz.weight": qkvz.contiguous(),
        f"{base}.in_proj_ba.weight": ba.contiguous(),
        f"{base}.conv1d.weight": p["conv1d"]["weight"],
        f"{base}.dt_bias": p["dt_bias"],
        f"{base}.A_log": p["A_log"],
        f"{base}.norm.weight": p["norm"]["weight"],
        f"{base}.out_proj.weight": p["out_proj"]["weight"],
    }
