#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py    # every phase (needs one card)

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print `nvidia-smi` name and power limit;
  2. build: compile every CUDA kernel of the port from this checkout
     (one nvcc per source, all started together), print each source's
     ptxas report (registers, shared memory, spills) and the count of
     HGMMA (wgmma) instructions in the bf16 kernel's SASS, which must not
     be 0;
  3. kernels: hold each kernel against its plain PyTorch version on the
     card (bf16 on the tensor-core kernel, f32 on the FMA kernel), then
     time kernel, plain version and the PyTorch library call as device
     time (CUDA events around calls queued behind a spin kernel, so the
     card runs them back to back), beside the issue rate of back-to-back
     calls, the card's bound and the library call's backend;
  4. model parity: the flagship at full width and 2 layers in f32 prefills
     a 600-token prompt in chunks (fresh flash, append flash, masked tail)
     on the card and on the CPU; logits agree within 2e-3 and 16 greedy
     tokens are identical;
  5. serving: the full flagship (28 layers, bf16, seed 0) behind the
     port's HTTP server with 4 slots and ctx 4096 answers 4 concurrent
     chats and one SSE chat; each concurrent result equals the same
     request sent alone, and the bf16 flash kernel's launch counts show
     both modes ran;
  6. prints the kernels line, the card line, and the result line last.

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
            if any(w in ln for w in ("registers", "spill", "smem", "wgmma",
                                     "arning")):
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


# -- phase 4: model parity ---------------------------------------------------


def chunked_prefill_and_greedy(model, ids, n_greedy=16):
    """Prefill `ids` in 256-token chunks into a 4096-row cache, then
    greedy-decode n_greedy tokens. Returns (last logits, tokens, flash
    launches by mode during the prefill)."""
    import torch
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops.sampling import SamplingConfig
    cache = model.new_cache(1, kv_len=4096)
    flash.reset_launches()
    logits = None
    for p0 in range(0, len(ids), 256):
        logits, cache = model.prefill(cache, ids[p0:p0 + 256], p0)
    launches = flash.launch_counts()
    dev = model.device
    recent = torch.full((1, 64), -1, dtype=torch.int32, device=dev)
    tok = model.sample_one(logits, None, SamplingConfig(), recent)
    toks = [int(tok[0])]
    pos = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
    greedy = [torch.tensor([v], dtype=dt, device=dev) for v, dt in (
        (0.0, torch.float32), (model.cfg.vocab_size, torch.int32),
        (1.0, torch.float32), (1.0, torch.float32))]
    active = torch.ones(1, dtype=torch.bool, device=dev)
    while len(toks) < n_greedy:
        _, tok, pos, recent = model.decode_slots(
            cache["layers"], tok, pos, recent, *greedy, active)
        toks.append(int(tok[0]))
    return logits.float().cpu(), toks, launches


def phase_parity() -> dict:
    """600 tokens in chunks of 256: fresh flash, append flash, then a
    88-token tail (bucket 128 < FLASH_MIN_SEQ) on the masked path. Returns
    the f32 route's launches by mode."""
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
    lc, tc, _ = chunked_prefill_and_greedy(cpu, ids)
    err = (lg - lc).abs().max().item()
    print(f"parity flagship width, 2 layers, f32, 600-token chunked "
          f"prefill: flash launches {launches}; logits max_abs_err "
          f"{err:.3e} (tol {LOGIT_TOL:g}); 16 greedy tokens identical "
          f"{tg == tc}", flush=True)
    check(launches == {"bf16": {"fresh": 0, "append": 0},
                       "f32": {"fresh": 2, "append": 2}},
          f"unexpected flash launches {launches}")
    check(err <= LOGIT_TOL, f"logits differ by {err}")
    check(tg == tc, f"greedy tokens differ: {tg} vs {tc}")
    return launches["f32"]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# -- phase 5: serving --------------------------------------------------------


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


def phase_serve(card: str) -> dict:
    import torch
    from cake_tpu_torch.api import create_app
    from cake_tpu_torch.cli import build_flagship
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.serve import ServeEngine
    t0 = time.perf_counter()
    model = build_flagship(layers=None, dtype="bf16", seed=0, device="cuda")
    engine = ServeEngine(model, slots=4, ctx_len=4096)
    app = create_app(model, engine, model.tokenizer, port=0).start()
    print(f"serve: flagship 28 layers bf16 up in "
          f"{time.perf_counter() - t0:.1f}s at {app.url}", flush=True)
    reqs = {}
    submit = engine.submit

    def recording_submit(*a, **kw):       # keep each request's token ids
        r = submit(*a, **kw)
        reqs[r.id] = r
        return r
    engine.submit = recording_submit
    try:
        def body(i, stream=False):
            return {"messages": [{"role": "user", "content": _prompt(i)}],
                    "temperature": 0, "max_tokens": 32, "stream": stream}
        results, errors = {}, []

        def worker(i, stream=False):
            try:
                t = time.perf_counter()
                status, raw = _post(app.url, body(i, stream))
                results[(i, stream)] = (status, raw, time.perf_counter() - t)
            except Exception as e:     # reported below, phase fails
                errors.append(f"request {i}: {e!r}")

        flash.reset_launches()
        torch.cuda.synchronize()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        threads.append(threading.Thread(target=worker, args=(4, True)))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        torch.cuda.synchronize()
        counts = flash.launch_counts()
        check(not errors, f"serving errors: {errors}")
        check(all(not th.is_alive() for th in threads), "requests hung")
        concurrent = {}
        for i in range(4):
            status, raw, _ = results[(i, False)]
            resp = json.loads(raw)
            check(status == 200, f"request {i}: HTTP {status}")
            check(resp["usage"]["completion_tokens"] > 0,
                  f"request {i}: no completion tokens")
            concurrent[i] = (resp, reqs[resp["id"]].result["tokens"])
        status, raw, _ = results[(4, True)]
        events = [ln[6:] for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")]
        check(status == 200 and events and events[-1] == "[DONE]",
              "SSE stream did not end with [DONE]")
        n_content = sum(1 for e in events[:-1]
                        if json.loads(e)["choices"][0]["delta"].get("content"))
        check(n_content > 0, "SSE stream carried no content")
        stats = [reqs[concurrent[i][0]["id"]].result["stats"]
                 for i in range(4)]
        print(f"serve flash launches (4 concurrent + 1 SSE, 28 layers): "
              f"{counts}", flush=True)
        launches = counts["bf16"]
        check(launches["fresh"] >= 28 * 4, f"fresh launches {counts}")
        check(launches["append"] > 0, f"append launches {counts}")
        check(sum(counts["f32"].values()) == 0,
              f"the f32 route ran while serving bf16: {counts}")
        for i in range(4):
            status, raw = _post(app.url, body(i))
            alone = json.loads(raw)
            toks = reqs[alone["id"]].result["tokens"]
            check(status == 200, f"alone request {i}: HTTP {status}")
            check(toks == concurrent[i][1],
                  f"request {i}: concurrent tokens {concurrent[i][1]} != "
                  f"alone {toks}")
            check(alone["choices"][0]["message"]["content"]
                  == concurrent[i][0]["choices"][0]["message"]["content"],
                  f"request {i}: content differs alone vs concurrent")
        ttft = sorted(s["ttft_s"] for s in stats)
        tps = sorted(s["tok_per_s"] for s in stats)
        n_prompt = concurrent[0][0]["usage"]["prompt_tokens"]
        print(f"serve: 4 concurrent chats, {n_prompt}-token prompts, 32 "
              f"tokens each: TTFT p50 {ttft[1] * 1e3:.1f} ms (of "
              f"{[round(x * 1e3, 1) for x in ttft]}), decode tok/s per "
              f"request p50 {tps[1]:.1f}, on {card}", flush=True)
        return launches
    finally:
        engine.submit = submit
        app.stop()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from cake_tpu_torch.ops import flash
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    phase_build()
    timings = phase_kernels()
    parity_launches = phase_parity()
    serve_launches = phase_serve(card)
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
