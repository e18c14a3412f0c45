#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py    # every phase (needs one card)

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print `nvidia-smi` name and power limit;
  2. build: compile every CUDA kernel of the port from this checkout (the
     two flash sources and the paged decode source, one nvcc each, all
     started together), print each source's ptxas report (registers,
     shared memory, spills) and the count of HGMMA (wgmma) instructions
     in the bf16 flash kernel's SASS, which must not be 0;
  3. kernels: hold each kernel against its plain PyTorch version on the
     card (flash: bf16 on the tensor-core kernel, f32 on the FMA kernel;
     paged decode: both routes over ragged frontiers, an all-NULL row,
     stale tenants and a shared block, bt 16 and 64, D 128 and 64), then
     time kernel, plain version and the PyTorch library call as device
     time (CUDA events around calls queued behind a spin kernel, so the
     card runs them back to back), beside the issue rate of back-to-back
     calls, the card's bound and the library call's backend;
  4. model parity: the flagship at full width and 2 layers in f32 prefills
     a 600-token prompt in chunks (fresh flash, append flash, masked tail)
     and decodes 16 greedy tokens, once into a contiguous cache and once
     through a paged pool (bt 16, decode on the paged kernel's f32 route),
     on the card, against the contiguous run on the CPU: logits agree
     within 2e-3 and the greedy tokens are identical;
  5. serving: the full flagship (28 layers, bf16, seed 0) behind the
     port's HTTP server with 4 slots and ctx 4096 (contiguous pool, prefix
     cache on at its default) answers 4 concurrent chats and one SSE chat;
     each concurrent result equals the same request sent alone (a rerun
     may hit the prefix cache), and the bf16 flash kernel's launch counts
     show both modes ran;
  6. prefix and paged serving, same model and server: (a) a paged pool of
     1024 blocks of 16 tokens answers phase 5's chats, each equal to the
     same request alone, with 28 paged decode launches per decode step
     and both flash modes launched by the paged prefill;
     (b) four chats sharing a 560-character system message hit at least
     512 prompt tokens after the first, in both modes (blocks shared
     while they run, in paged mode), with tokens equal to the same mode
     with the cache off; (c) (a)'s chats on a 96-block pool, the last two
     arriving while the first two decode: at least one swap preemption,
     no failure, tokens equal to (a)'s;
  7. prints the kernels line, the card line, and the result line last.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

BF16_TOL = 2e-2     # bf16 output rounding (ulp 2^-7 near 1) + sum order
F32_TOL = 1e-4      # float32 summation order only
LOGIT_TOL = 2e-3    # f32 model on card vs CPU (cuBLAS vs MKL sum order)

H100_PEAK_FLOPS = {"bf16": 989e12,   # dense tensor-core peak, H100 SXM
                   "f32": 67e12}     # float32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"   # the CUDA toolkit's

class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# -- phase 2: build ----------------------------------------------------------


def phase_build() -> None:
    from cake_tpu_torch.kernels.build import build_all
    from cake_tpu_torch.ops import flash
    t = time.perf_counter()
    built = build_all()
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.1f}s", flush=True)
        for ln in info["log"].splitlines():
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "smem", "wgmma", "arning")):
                print(f"  {ln.strip()}")
    print(f"build total {time.perf_counter() - t:.1f}s", flush=True)
    cuobjdump = shutil.which("cuobjdump") or (
        CUOBJDUMP if os.path.exists(CUOBJDUMP) else None)
    if cuobjdump is None:
        print("cuobjdump not found: HGMMA count not taken", flush=True)
        return
    lib = built[flash.LIBRARIES["bf16"]]["path"]
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
    n = sum("HGMMA" in ln for ln in sass.stdout.splitlines())
    print(f"HGMMA instructions in {flash.SOURCES['bf16']}: {n}", flush=True)
    check(n > 0, "the bf16 flash kernel has no HGMMA (wgmma) instruction")


# -- phase 3: kernels --------------------------------------------------------


def flash_case(name, dtype, sq=256, skv=None, hq=16, hkv=8, d=128,
               valid_len=None, q_offset=None, window=None, pool_rows=None):
    """Inputs of one flash case on the card. With pool_rows, K/V are a
    strided batch-1 view of row 1 of a [3, pool_rows, Hkv, D] pool, as
    in append mode."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(
        sum(map(ord, name)))
    skv = sq if skv is None else skv

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = rnd(1, sq, hq, d)
    if pool_rows:
        k = rnd(3, pool_rows, hkv, d)[1:2]
        v = rnd(3, pool_rows, hkv, d)[1:2]
    else:
        k, v = rnd(1, skv, hkv, d), rnd(1, skv, hkv, d)
    kw = dict(valid_len=valid_len, q_offset=q_offset, window=window)
    return q, k, v, kw


FLASH_CASES = [
    ("fresh", {}),
    ("fresh_valid200", dict(valid_len=200)),
    ("sq300", dict(sq=300)),
    ("window128", dict(window=128)),
    ("append", dict(pool_rows=4096, q_offset=256, valid_len=256)),
    ("d64_mha", dict(hq=8, hkv=8, d=64)),
]


def visible_pairs(sq, limit, q_offset, window, skv) -> int:
    """(query, key) pairs the masks leave visible: the work this run's
    data needs."""
    import torch
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(min(limit, skv))[None, :]
    m = kp <= qp
    if window:
        m &= kp > qp - window
    return int(m.sum())


def flash_bound_ms(q, k, kw) -> tuple[float, str]:
    """Least time on an H100 SXM: the larger of FLOPs over the peak for
    q's type (bf16 tensor cores, or float32 outside them) and bytes (q
    read, K/V rows below the limit read, output written, once each) over
    HBM bandwidth."""
    import torch
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    off = kw.get("q_offset") or 0
    limit = off + (kw.get("valid_len") or sq)
    rows = min(limit, k.shape[1])
    flops = 4.0 * visible_pairs(sq, limit, off, kw.get("window"),
                                k.shape[1]) * hq * d * b
    el = q.element_size()
    nbytes = el * b * (2 * sq * hq * d + 2 * rows * hkv * d)
    peak = H100_PEAK_FLOPS["bf16" if q.dtype == torch.bfloat16 else "f32"]
    t_ops, t_bytes = flops / peak, nbytes / H100_HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _library_args(q, k, v, kw):
    """Arguments of scaled_dot_product_attention for the same function:
    [B, H, S, D] views, and a causal flag or an explicit mask."""
    import torch
    off = kw.get("q_offset") or 0
    limit = off + (kw.get("valid_len") or q.shape[1])
    qt = q.transpose(1, 2)
    kt = k[:, :limit].transpose(1, 2)
    vt = v[:, :limit].transpose(1, 2)
    if off == 0 and limit >= k.shape[1] and not kw.get("window"):
        return (qt, kt, vt), dict(is_causal=True, enable_gqa=True)
    qp = off + torch.arange(q.shape[1], device="cuda")[:, None]
    kp = torch.arange(kt.shape[2], device="cuda")[None, :]
    mask = kp <= qp
    if kw.get("window"):
        mask &= kp > qp - kw["window"]
    return (qt, kt, vt), dict(attn_mask=mask, enable_gqa=True)


def library_call(q, k, v, kw):
    """One PyTorch call computing the same function (yardstick only: the
    port never calls it): scaled_dot_product_attention on [B, H, S, D]."""
    import torch.nn.functional as F
    args, sdpa_kw = _library_args(q, k, v, kw)
    return lambda: F.scaled_dot_product_attention(*args, **sdpa_kw)


def library_backend(q, k, v, kw) -> str:
    """The backend scaled_dot_product_attention picks for these inputs
    (the choice its dispatcher makes, read without running it)."""
    import torch
    from torch.nn.attention import SDPBackend
    args, sdpa_kw = _library_args(q, k, v, kw)
    return SDPBackend(torch._fused_sdp_choice(*args, **sdpa_kw)).name


def phase_kernels() -> dict:
    import torch
    from cake_tpu_torch.bench.timing import device_ms, issue_ms
    from cake_tpu_torch.ops.flash import (flash_attention_kernel,
                                          flash_attention_ref, kernel_route)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for name, spec in FLASH_CASES:
            q, k, v, kw = flash_case(name, dtype, **spec)
            got = flash_attention_kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, **kw)
            err = (got.float() - want.float()).abs().max().item()
            print(f"flash {name:15s} {kernel_route(dtype)} max_abs_err "
                  f"{err:.3e} (tol {tol:g})", flush=True)
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"flash {name} {dtype}: max_abs_err {err} > {tol}")
    timings = {}
    for entry, dtype, spec in (
            ("fresh", torch.bfloat16, {}),
            ("append", torch.bfloat16, FLASH_CASES[4][1]),
            ("f32", torch.float32, {})):
        q, k, v, kw = flash_case(entry, dtype, **spec)
        err = (flash_attention_kernel(q, k, v, **kw).float()
               - flash_attention_ref(q, k, v, **kw).float()).abs().max()

        def kern():
            return flash_attention_kernel(q, k, v, **kw)
        # device time: events around calls queued behind a spin, so the
        # host's issue rate (issue_ms) does not set it
        t = {
            "max_abs_err": err.item(), "ms": device_ms(kern),
            "issue_ms": issue_ms(kern),
            "plain_ms": device_ms(
                lambda: flash_attention_ref(q, k, v, **kw), iters=10),
            "library_ms": device_ms(library_call(q, k, v, kw)),
        }
        t["bound_ms"], t["bound_by"] = flash_bound_ms(q, k, kw)
        timings[entry] = t
        print(f"flash timing {entry}: {kernel_route(dtype)} Sq=256 Hq/Hkv="
              f"16/8 D=128 Skv_row={k.shape[1]} device ms: kernel "
              f"{t['ms']:.5f} plain {t['plain_ms']:.5f} library "
              f"{t['library_ms']:.5f}; kernel issue_ms {t['issue_ms']:.5f}; "
              f"bound_ms {t['bound_ms']:.5f} ({t['bound_by']}), share of "
              f"bound {t['bound_ms'] / t['ms']:.3f}", flush=True)
        print(f"  library backend: {library_backend(q, k, v, kw)}",
              flush=True)
    return timings


# -- phase 3b: the paged decode kernel -----------------------------------------


def paged_bound_ms(c) -> tuple[float, str]:
    """Least time on an H100 SXM for one paged decode call: the larger of
    bytes (each row's live K/V entries, their positions and table entries,
    q and o, once each) over HBM bandwidth and FLOPs (4 per visible key,
    head and channel) over the peak of q's type."""
    import torch
    q, k = c["q"], c["k"]
    b, _, hq, d = q.shape
    bt, hkv = k.shape[1], k.shape[2]
    el = q.element_size()
    fr = [int(p) for p in c["frontier"].tolist()]
    live = sum(p + 1 for p in fr)
    nbytes = (live * (2 * hkv * d * el + 4) + 2 * q.numel() * el
              + 4 * sum(p // bt + 1 for p in fr) + 4 * b)
    flops = 4.0 * live * hq * d
    peak = H100_PEAK_FLOPS["bf16" if q.dtype == torch.bfloat16 else "f32"]
    t_ops, t_bytes = flops / peak, nbytes / H100_HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _paged_library_args(c):
    """scaled_dot_product_attention's inputs for the same function: each
    row's live rows gathered (outside the timed call) into contiguous
    [B, Hkv, T, D] K/V, T = the longest row, with a boolean mask."""
    from cake_tpu_torch.models.common.cache import paged_gather_layer
    view = paged_gather_layer({n: c[n] for n in ("k", "v", "pos")},
                              c["tables"], c["frontier"] + 1)
    t = int(c["frontier"].max()) + 1
    kk = view["k"][:, :t].transpose(1, 2).contiguous()
    vv = view["v"][:, :t].transpose(1, 2).contiguous()
    mask = (view["pos"][:, :t] >= 0)[:, None, None, :]
    return (c["q"].transpose(1, 2), kk, vv), dict(attn_mask=mask,
                                                 enable_gqa=True)


def phase_paged_kernels() -> dict:
    """The paged decode kernel against its plain version in every case,
    then timed at the serving shape (4 rows at p = 620, bt 16) in both
    routes, and at 4 rows at p = 4000 in bf16."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from cake_tpu_torch.bench.paged_cases import (CARD_CASES, case_args,
                                                  paged_case)
    from cake_tpu_torch.bench.timing import device_ms, issue_ms
    from cake_tpu_torch.ops import paged_attention as pa
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for name, spec in CARD_CASES:
            c = paged_case(dtype=dtype, device="cuda", **spec)
            got = pa.paged_decode_attention_kernel(*case_args(c))
            torch.cuda.synchronize()
            want = pa.paged_decode_attention_ref(*case_args(c))
            rows = c["visible_rows"]
            err = (got[rows].float() - want[rows].float()).abs().max().item()
            print(f"paged decode {name:22s} {pa.kernel_route(dtype)} "
                  f"max_abs_err {err:.3e} (tol {tol:g})", flush=True)
            check(err <= tol and torch.isfinite(got).all().item(),
                  f"paged decode {name} {dtype}: max_abs_err {err} > {tol}")
    timings = {}
    for entry, dtype, p in (("bf16", torch.bfloat16, 620),
                            ("f32", torch.float32, 620),
                            ("bf16_p4000", torch.bfloat16, 4000)):
        c = paged_case([p] * 4, dtype=dtype, device="cuda", seed=p)
        args = case_args(c)
        err = (pa.paged_decode_attention_kernel(*args).float()
               - pa.paged_decode_attention_ref(*args).float()).abs().max()
        lib_args, lib_kw = _paged_library_args(c)

        def kern():
            return pa.paged_decode_attention_kernel(*args)
        t = {"max_abs_err": err.item(), "ms": device_ms(kern),
             "issue_ms": issue_ms(kern),
             "plain_ms": device_ms(
                 lambda: pa.paged_decode_attention_ref(*args), iters=10),
             "library_ms": device_ms(
                 lambda: F.scaled_dot_product_attention(*lib_args,
                                                        **lib_kw))}
        t["bound_ms"], t["bound_by"] = paged_bound_ms(c)
        timings[entry] = t
        backend = SDPBackend(torch._fused_sdp_choice(*lib_args,
                                                     **lib_kw)).name
        print(f"paged decode timing {entry}: 4 rows at p={p}, bt 16, Hq/Hkv="
              f"16/8 D=128, device ms: kernel {t['ms']:.5f} plain "
              f"{t['plain_ms']:.5f} library {t['library_ms']:.5f} ({backend}"
              f", over pre-gathered live rows: gather not timed); kernel "
              f"issue_ms {t['issue_ms']:.5f}; bound_ms {t['bound_ms']:.5f} "
              f"({t['bound_by']}), share of bound "
              f"{t['bound_ms'] / t['ms']:.3f}; max_abs_err "
              f"{t['max_abs_err']:.3e}", flush=True)
    return timings


# -- phase 4: model parity ---------------------------------------------------


def _greedy(model, logits, n, decode, n_greedy):
    """n_greedy greedy tokens off prefill logits; decode(tok, pos, recent,
    carries, active) runs one batch-1 decode step at host position p."""
    import torch
    from cake_tpu_torch.ops.sampling import SamplingConfig
    dev = model.device
    recent = torch.full((1, 64), -1, dtype=torch.int32, device=dev)
    tok = model.sample_one(logits, None, SamplingConfig(), recent)
    toks = [int(tok[0])]
    pos = torch.tensor([n], dtype=torch.int32, device=dev)
    greedy = [torch.tensor([v], dtype=dt, device=dev) for v, dt in (
        (0.0, torch.float32), (model.cfg.vocab_size, torch.int32),
        (1.0, torch.float32), (1.0, torch.float32))]
    active = torch.ones(1, dtype=torch.bool, device=dev)
    while len(toks) < n_greedy:
        _, tok, pos, recent = decode(n + len(toks) - 1, tok, pos, recent,
                                     greedy, active)
        toks.append(int(tok[0]))
    return toks


def chunked_prefill_and_greedy(model, ids, n_greedy=16):
    """Prefill `ids` in 256-token chunks into a 4096-row cache, then
    greedy-decode n_greedy tokens. Returns (last logits, tokens, flash
    launches by mode during the prefill)."""
    from cake_tpu_torch.ops import flash
    cache = model.new_cache(1, kv_len=4096)
    flash.reset_launches()
    logits = None
    for p0 in range(0, len(ids), 256):
        logits, cache = model.prefill(cache, ids[p0:p0 + 256], p0)
    launches = flash.launch_counts()
    toks = _greedy(model, logits, len(ids),
                   lambda p, tok, pos, rec, g, act: model.decode_slots(
                       cache["layers"], tok, pos, rec, *g, act), n_greedy)
    return logits.float().cpu(), toks, launches


def paged_prefill_and_greedy(model, ids, n_greedy=16):
    """The same through a paged pool (one slot, ctx 4096, blocks of 16):
    prefill_chunk_paged per chunk, decode_slots_paged per token, blocks
    reserved ahead as the engine does. Returns (last logits, tokens, paged
    decode launches by route)."""
    from cake_tpu_torch.ops import paged_attention as pa
    from cake_tpu_torch.serve.paged import PagedKV
    pk = PagedKV.build(model, 1, 4096, 64, 16, 256)
    pa.reset_launches()
    logits = None
    for p0 in range(0, len(ids), 256):
        chunk = ids[p0:p0 + 256]
        check(pk.reserve_range(0, p0, len(chunk)), "paged pool too small")
        logits = pk.prefill_into(0, chunk, p0)

    def decode(p, tok, pos, rec, g, act):
        check(pk.reserve_range(0, p, 1), "paged pool too small")
        return model.decode_slots_paged(pk.pool, pk.rows, pk.tables, tok,
                                        pos, rec, *g, act)
    toks = _greedy(model, logits, len(ids), decode, n_greedy)
    return logits.float().cpu(), toks, pa.launch_counts()


def phase_parity() -> tuple[dict, int]:
    """600 tokens in chunks of 256: fresh flash, append flash, then a
    88-token tail (bucket 128 < FLASH_MIN_SEQ) on the masked path, then 16
    greedy tokens; contiguous and paged on the card against contiguous on
    the CPU. Returns the f32 flash launches by mode and the f32 paged
    decode launches."""
    import torch
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.models import TextModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_flagship(layers=2, dtype="f32", seed=1, device="cpu")
    params = _to_device(cpu.params, "cuda")
    gpu = TextModel(cpu.cfg, params, dtype=torch.float32, device="cuda")
    ids = [int(x) for x in torch.randint(
        0, cpu.cfg.vocab_size, (600,),
        generator=torch.Generator().manual_seed(5))]
    lg, tg, launches = chunked_prefill_and_greedy(gpu, ids)
    lp, tp, paged_launches = paged_prefill_and_greedy(gpu, ids)
    lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
    err = (lg - lc).abs().max().item()
    err_p = (lp - lc).abs().max().item()
    print(f"parity flagship width, 2 layers, f32, 600-token chunked "
          f"prefill: flash launches {launches}; logits max_abs_err "
          f"{err:.3e} (tol {LOGIT_TOL:g}); 16 greedy tokens identical "
          f"{tg == tc}", flush=True)
    print(f"parity paged (bt 16): paged decode launches {paged_launches}; "
          f"logits max_abs_err {err_p:.3e} (tol {LOGIT_TOL:g}); 16 greedy "
          f"tokens identical {tp == tc}", flush=True)
    check(launches == {"bf16": {"fresh": 0, "append": 0},
                       "f32": {"fresh": 2, "append": 2}},
          f"unexpected flash launches {launches}")
    check(err <= LOGIT_TOL, f"logits differ by {err}")
    check(tg == tc, f"greedy tokens differ: {tg} vs {tc}")
    check(paged_launches == {"bf16": 0, "f32": 2 * 15},
          f"unexpected paged decode launches {paged_launches}")
    check(err_p <= LOGIT_TOL, f"paged logits differ by {err_p}")
    check(tp == tc, f"paged greedy tokens differ: {tp} vs {tc}")
    return launches["f32"], paged_launches["f32"]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# -- phases 5 and 6: serving -------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _prompt(i: int) -> str:
    words = ("tensor", "kernel", "warp", "slot", "chunk", "prefill",
             "decode", "cache", "token", "stream")
    text = " ".join(words[(i * 7 + j * 3) % len(words)] for j in range(90))
    return f"request {i}: {text}"[:600]


SYSTEM = ("You are the support desk of a GPU cloud. Answer in short, plain "
          "sentences, name the card and its power limit beside every "
          "number, and never guess a figure you were not given. " * 4)[:560]


def chat_body(i: int, stream: bool = False, shared: bool = False) -> dict:
    """Phase 5's chat i, or (shared) a question under the common system
    message, whose first 512 prompt tokens are the same for every i."""
    messages = [{"role": "user", "content": _prompt(i)}]
    if shared:
        messages = [{"role": "system", "content": SYSTEM},
                    {"role": "user", "content": f"question {i}: which card "
                     f"serves slot {i} and at what limit?"}]
    return {"messages": messages, "temperature": 0, "max_tokens": 32,
            "stream": stream}


class Served:
    """The model behind the port's HTTP server with one engine (4 slots,
    ctx 4096); keeps every ServeRequest by id, for its token ids."""

    def __init__(self, model, **engine_kw):
        from cake_tpu_torch.api import create_app
        from cake_tpu_torch.serve import ServeEngine
        self.engine = ServeEngine(model, slots=4, ctx_len=4096, **engine_kw)
        self.app = create_app(model, self.engine, model.tokenizer,
                              port=0).start()
        self.reqs = {}
        submit = self.engine.submit

        def recording_submit(*a, **kw):
            r = submit(*a, **kw)
            self.reqs[r.id] = r
            return r
        self.engine.submit = recording_submit

    def chat(self, body: dict) -> dict:
        """POST one chat; returns {status, resp (JSON) or events (SSE),
        tokens, stats, seconds}."""
        t = time.perf_counter()
        status, raw = _post(self.app.url, body)
        out = {"status": status, "seconds": time.perf_counter() - t}
        if body.get("stream"):
            out["events"] = [ln[6:] for ln in raw.decode().splitlines()
                             if ln.startswith("data: ")]
            rid = json.loads(out["events"][0])["id"]
        else:
            out["resp"] = json.loads(raw)
            rid = out["resp"]["id"]
        out["tokens"] = self.reqs[rid].result["tokens"]
        out["stats"] = self.reqs[rid].result["stats"]
        return out

    def concurrent(self, bodies: list[dict], during=None) -> list[dict]:
        """POST the bodies at once; `during()` is polled while they run.
        Fails on any error or hang."""
        results, errors = [None] * len(bodies), []

        def worker(i):
            try:
                results[i] = self.chat(bodies[i])
            except Exception as e:     # reported below, phase fails
                errors.append(f"request {i}: {e!r}")
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        while during is not None and any(th.is_alive() for th in threads):
            during()
            time.sleep(0.005)
        for th in threads:
            th.join(timeout=900)
        check(not errors, f"serving errors: {errors}")
        check(all(not th.is_alive() for th in threads), "requests hung")
        for i, r in enumerate(results):
            check(r["status"] == 200, f"request {i}: HTTP {r['status']}")
        return results

    def close(self):
        self.app.stop()


def _check_chats(results: list[dict], label: str) -> None:
    for i, r in enumerate(results):
        if "events" in r:
            ev = r["events"]
            check(ev and ev[-1] == "[DONE]",
                  f"{label}: SSE stream did not end with [DONE]")
            n = sum(1 for e in ev[:-1]
                    if json.loads(e)["choices"][0]["delta"].get("content"))
            check(n > 0, f"{label}: SSE stream carried no content")
        else:
            check(r["resp"]["usage"]["completion_tokens"] > 0,
                  f"{label} request {i}: no completion tokens")


def _alone_equals_concurrent(served, bodies, results, label) -> list[int]:
    """Send each non-streamed body again alone; its tokens and content
    must equal the concurrent run's. Returns each rerun's prefix hit."""
    hits = []
    for i, body in enumerate(bodies):
        if body.get("stream"):
            continue
        alone = served.chat(body)
        check(alone["status"] == 200, f"{label} alone {i}: HTTP "
              f"{alone['status']}")
        check(alone["tokens"] == results[i]["tokens"],
              f"{label} request {i}: concurrent tokens "
              f"{results[i]['tokens']} != alone {alone['tokens']}")
        check(alone["resp"]["choices"][0]["message"]["content"]
              == results[i]["resp"]["choices"][0]["message"]["content"],
              f"{label} request {i}: content differs alone vs concurrent")
        hits.append(alone["stats"]["prefix_hit_tokens"])
    return hits


def _latency(results: list[dict]) -> tuple[float, float]:
    """(TTFT p50 ms, decode tok/s per request p50) of the chats."""
    stats = [r["stats"] for r in results]
    ttft = sorted(s["ttft_s"] for s in stats)
    tps = sorted(s["tok_per_s"] for s in stats)
    return ttft[len(ttft) // 2] * 1e3, tps[len(tps) // 2]


def phase_serve(model, card: str) -> tuple[dict, list]:
    """Phase 5: contiguous pool, prefix cache on at its default. Returns
    the flash launches and the 4 chats' results."""
    import torch
    from cake_tpu_torch.ops import flash
    served = Served(model)
    try:
        bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
        flash.reset_launches()
        torch.cuda.synchronize()
        results = served.concurrent(bodies)
        torch.cuda.synchronize()
        counts = flash.launch_counts()
        _check_chats(results, "phase 5")
        print(f"serve flash launches (4 concurrent + 1 SSE, 28 layers): "
              f"{counts}", flush=True)
        launches = counts["bf16"]
        check(launches["fresh"] >= 28 * 4, f"fresh launches {counts}")
        check(launches["append"] > 0, f"append launches {counts}")
        check(sum(counts["f32"].values()) == 0,
              f"the f32 route ran while serving bf16: {counts}")
        hits = _alone_equals_concurrent(served, bodies, results, "phase 5")
        ttft, tps = _latency(results[:4])
        n_prompt = results[0]["resp"]["usage"]["prompt_tokens"]
        print(f"serve: 4 concurrent chats, {n_prompt}-token prompts, 32 "
              f"tokens each: TTFT p50 {ttft:.1f} ms (of "
              f"{sorted(round(r['stats']['ttft_s'] * 1e3, 1) for r in results[:4])}"
              f"), decode tok/s per request p50 {tps:.1f}; alone reruns' "
              f"prefix_hit_tokens {hits} (prefix cache 256 MB); on {card}",
              flush=True)
        return launches, results[:4]
    finally:
        served.close()


def phase_paged_serve(model, card: str, contiguous: list) -> int:
    """Phase 6 (a)-(c). Returns the paged decode kernel's bf16 launches in
    (a)."""
    import torch
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    layers = model.cfg.num_hidden_layers
    # (a) paged pool with the capacity of the contiguous one
    paged = Served(model, kv_blocks=1024, kv_block_tokens=16)
    try:
        steps = [0]
        decode = model.decode_slots_paged

        def counting(*a, **kw):
            steps[0] += 1
            return decode(*a, **kw)
        model.decode_slots_paged = counting
        bodies = [chat_body(i) for i in range(4)] + [chat_body(4, True)]
        torch.cuda.synchronize()
        pa.reset_launches()
        flash.reset_launches()
        try:
            results = paged.concurrent(bodies)
            torch.cuda.synchronize()
            launches = pa.launch_counts()
            flash_counts = flash.launch_counts()
        finally:
            del model.decode_slots_paged
        _check_chats(results, "phase 6a")
        print(f"paged serve (a): decode launches {launches} over "
              f"{steps[0]} paged decode steps x {layers} layers; flash "
              f"launches {flash_counts}", flush=True)
        check(launches == {"bf16": layers * steps[0], "f32": 0} and steps[0],
              f"paged decode launches {launches} != {layers} x {steps[0]}")
        check(flash_counts["bf16"]["fresh"] >= layers * 4
              and flash_counts["bf16"]["append"] > 0
              and sum(flash_counts["f32"].values()) == 0,
              f"paged prefill flash launches {flash_counts}")
        hits = _alone_equals_concurrent(paged, bodies, results, "phase 6a")
        ttft, tps = _latency(results[:4])
        ttft5, tps5 = _latency(contiguous)
        same = sum(a == b for r, c in zip(results[:4], contiguous)
                   for a, b in zip(r["tokens"], c["tokens"]))
        total = sum(len(c["tokens"]) for c in contiguous)
        print(f"paged serve (a): TTFT p50 {ttft:.1f} ms, decode tok/s per "
              f"request p50 {tps:.1f} (contiguous, phase 5: {ttft5:.1f} ms, "
              f"{tps5:.1f}); alone reruns' prefix_hit_tokens {hits}; greedy "
              f"tokens equal to phase 5's contiguous ones: {same} of {total} "
              f"(reported, not gated: the kernel's bf16 sums differ from the "
              f"torch path's); on {card}", flush=True)
        want = [r["tokens"] for r in results[:4]]
        # (b) shared system prompt, both modes, cache on vs off
        shared_bodies = [chat_body(i, shared=True) for i in range(4)]
        shared_max = [0]

        def watch():
            shared_max[0] = max(shared_max[0],
                                paged.engine.health()["kv_pool"]["shared"])

        def shared_run(served, during=None):
            first = served.chat(shared_bodies[0])
            check(first["status"] == 200, "phase 6b first chat failed")
            rest = served.concurrent(shared_bodies[1:], during)
            return [first] + rest
        on = {"paged": shared_run(paged, watch)}
    finally:
        paged.close()
    for mode, kw in (("contiguous", {}),
                     ("contiguous, cache off", {"prefix_cache_mb": 0}),
                     ("paged, cache off", {"prefix_cache_mb": 0,
                                           "kv_blocks": 1024,
                                           "kv_block_tokens": 16})):
        served = Served(model, **kw)
        try:
            on[mode] = shared_run(served)
        finally:
            served.close()
    for mode in ("contiguous", "paged"):
        got = on[mode]
        hits = [r["stats"]["prefix_hit_tokens"] for r in got]
        same = [r["tokens"] for r in got] == \
            [r["tokens"] for r in on[f"{mode}, cache off"]]
        print(f"prefix (b) {mode}: {got[0]['resp']['usage']['prompt_tokens']}"
              f"-token prompts sharing a {len(SYSTEM)}-character system "
              f"message: prefix_hit_tokens {hits}; tokens equal to the "
              f"cache-off run {same}"
              + (f"; most shared blocks while they ran {shared_max[0]}"
                 if mode == "paged" else ""), flush=True)
        check(all(h >= 512 for h in hits[1:]),
              f"{mode}: prefix hits {hits} below 512 after the first")
        check(same, f"{mode}: tokens differ between prefix cache on and off")
    check(shared_max[0] > 0, "paged: no block was shared during the hits")
    # (c) swap under pressure: 96 blocks, two chats decoding when the
    # other two arrive
    tight = Served(model, kv_blocks=96, kv_block_tokens=16)
    try:
        first = {}

        def send(i):
            first[i] = tight.chat(chat_body(i))
        threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        deadline = time.perf_counter() + 600
        while time.perf_counter() < deadline:
            live = list(tight.reqs.values())
            if len(live) == 2 and all(r.tokens for r in live):
                break
            time.sleep(0.002)
        late = tight.concurrent([chat_body(2), chat_body(3)])
        for th in threads:
            th.join(timeout=900)
        check(len(first) == 2, "phase 6c: a first chat failed")
        got = [first[0]["tokens"], first[1]["tokens"]] + \
            [r["tokens"] for r in late]
        pool = tight.engine.health()["kv_pool"]
        print(f"paged swap (c): 96 blocks of 16 tokens, kv_pool {pool}; "
              f"tokens equal to (a)'s {got == want}", flush=True)
        check(all(r["status"] == 200 for r in list(first.values()) + late),
              "phase 6c: a request failed")
        check(pool["swaps"] >= 1, "phase 6c: no swap preemption")
        check(got == want, f"phase 6c: swapped tokens {got} != (a)'s {want}")
    finally:
        tight.close()
    return launches["bf16"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops import paged_attention as pa
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    phase_build()
    timings = phase_kernels()
    paged_timings = phase_paged_kernels()
    parity_launches, parity_paged = phase_parity()
    t0 = time.perf_counter()
    model = build_flagship(layers=None, dtype="bf16", seed=0, device="cuda")
    print(f"serve: flagship 28 layers bf16 built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    serve_launches, contiguous = phase_serve(model, card)
    paged_launches = phase_paged_serve(model, card, contiguous)
    kernels = []
    for entry, route, launches in (
            ("fresh", "bf16", serve_launches["fresh"]),
            ("append", "bf16", serve_launches["append"]),
            ("f32", "f32", sum(parity_launches.values()))):
        t = timings[entry]
        kernels.append({
            "name": f"flash_attention.{entry}", "route": "cuda",
            "source": flash.SOURCES[route], "replaces": flash.REPLACES,
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "issue_ms": t["issue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for route, launches in (("bf16", paged_launches), ("f32", parity_paged)):
        t = paged_timings[route]
        kernels.append({
            "name": f"paged_decode_attention.{route}", "route": "cuda",
            "source": pa.SOURCE, "replaces": pa.REPLACES,
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "issue_ms": t["issue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
