"""The port's crash-only serve engine (serve/supervisor.py, faults.py,
flight.py; the reference's cases of tests/test_serve_faults.py) on a tiny
llama carried from the JAX package (ctx 256), in the contiguous and the
paged engine:

  * the fault plan's parsing and step semantics, `classify` (torch's OOM
    and CUDA errors, the kernel wrappers' launch-failure text) and
    `fingerprint`, each against the reference's where it has one;
  * an injected device failure at step 6 with 3 concurrent greedy
    requests costs exactly one rebuild, every request equals the JAX
    model's greedy tokens, and the rebuild keeps every address the
    captured programs read, the graph objects and the program count;
  * a poisoned request fails alone (PoisonedRequest, quarantined, a
    resubmit refused) while the others equal the JAX engine's outputs
    under the same plan, in at most 2 rebuilds;
  * an exhausted rebuild budget goes DOWN (EngineDown with Retry-After)
    and the restore loop revives the engine;
  * the watchdog flags a stalled step and clears;
  * over HTTP: 503 + Retry-After on the JSON and SSE paths of a down
    engine, 500 for a poisoned request, and /health 503 while wedged or
    down.
Every engine wait has a timeout, so that a hang fails the test."""
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.ops.sampling import SamplingConfig as JaxSampling
from cake_tpu.serve import ServeEngine as JaxServeEngine
from cake_tpu.serve import faults as jax_faults
from cake_tpu.serve import supervisor as jax_supervisor
from cake_tpu_torch.api import create_app
from cake_tpu_torch.bench.graph_cases import engine_addresses
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import (EngineDown, PoisonedRequest, ServeEngine,
                                  faults)
from cake_tpu_torch.serve.flight import FlightRecorder
from cake_tpu_torch.serve.supervisor import classify, fingerprint
from cake_tpu_torch.tokenizer import ByteTokenizer
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)
GREEDY = SamplingConfig(temperature=0.0)
CTX = 256
WAIT = 120                  # seconds any one request may take
VOCAB = 258                 # bytes + the two ChatML markers (HTTP cases)

P_A = [3, 17, 42, 99, 7]    # the reference test's prompts
P_B = [8, 8, 1, 30]
P_C = [100, 2, 5, 9, 11, 40]
POISON_TOK = 77
P_POISON = [8, POISON_TOK, 1, 30]

MODES = {"contiguous": {},
         "paged": dict(kv_blocks=64, kv_block_tokens=8, prefill_chunk=16)}


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    """Fault plans are process-global, one in each package: never leak one
    into the next test."""
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def pair():
    over = dict(vocab_size=VOCAB, max_position_embeddings=CTX)
    jm = JaxTextModel(jax_tiny_config("llama", **over), dtype=jnp.float32,
                      max_cache_len=CTX)
    cfg = tiny_config("llama", **over)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   tokenizer=ByteTokenizer(im_start_id=256, im_end_id=257),
                   dtype=torch.float32, device="cpu", max_cache_len=CTX)
    return jm, tm


def _jax_ref(jm, prompt, n):
    toks, _ = jm.generate(list(prompt), max_new_tokens=n,
                          sampling=JaxSampling(temperature=0.0), spec=False)
    return toks


def _finish(reqs):
    for r in reqs:
        assert r.wait(WAIT), f"request {r.id} hung"


# -- units --------------------------------------------------------------------


def test_fault_plan_parsing():
    inj = faults.parse_plan("raise_on_step=6;times=2;kind=oom")
    assert (inj.raise_on_step, inj.times, inj.kind) == (6, 2, "oom")
    inj = faults.parse_plan("poison_token=77;poison_after_ops=4")
    assert (inj.poison_token, inj.poison_after_ops) == (77, 4)
    inj = faults.parse_plan("stall_on_step=3;stall_step_ms=250")
    assert (inj.stall_on_step, inj.stall_step_ms) == (3, 250.0)
    for bad in ("raise_on_step", "unknown_key=1", "kind=sharks",
                "raise_on_step=1,raise_on_step=2"):
        with pytest.raises(ValueError):
            faults.parse_plan(bad)
    # the port's plan is a global of its own, apart from the JAX package's
    faults.install("delay_ms=1")
    assert faults.active() is not None and jax_faults.active() is None
    faults.clear()
    jax_faults.install("delay_ms=1")
    assert faults.active() is None


def test_fault_plan_step_semantics():
    """raise_on_step counts decode dispatches (1-based) and times=K kills
    K consecutive ones; the port's injector raises where the reference's
    does, op for op."""

    class _R:
        prompt_ids = [1, 2]
        id = "r"

    plan = "raise_on_step=2;times=2"
    for inj in (faults.parse_plan(plan), jax_faults.parse_plan(plan)):
        inj.on_decode([_R()])                       # op 1: clean
        for _ in range(2):                          # ops 2, 3: crash
            with pytest.raises(RuntimeError) as ei:
                inj.on_decode([_R()])
            assert ei.value.fault_kind == "internal"
        inj.on_decode([_R()])                       # op 4: clean again
        assert inj.ops == 4


def test_classify_kinds():
    acc = getattr(torch, "AcceleratorError", None)
    cases = [
        (faults.InjectedFault("x", fault_kind="oom"), "oom"),
        (faults.InjectedFault("x", fault_kind="device"), "device"),
        (MemoryError("small"), "oom"),
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 2.00 GiB"), "oom"),
        (RuntimeError("RESOURCE_EXHAUSTED: hbm"), "oom"),
        (RuntimeError("flash kernel launch failed: CUDA error 700"),
         "device"),
        (RuntimeError("paged decode kernel launch failed: CUDA error 719"),
         "device"),
        (RuntimeError("CUDA error: an illegal memory access was "
                      "encountered"), "device"),
        (ValueError("bad shape"), "internal"),
        (RuntimeError("index out of range"), "internal"),
    ] + ([(acc("device-side assert triggered"), "device")] if acc else [])
    for exc, kind in cases:
        assert classify(exc) == kind, exc
    # the reference's own spellings classify alike in both packages
    for exc in (faults.InjectedFault("x", fault_kind="device"),
                MemoryError("m"), RuntimeError("RESOURCE_EXHAUSTED: x"),
                ValueError("bad shape")):
        assert classify(exc) == jax_supervisor.classify(exc)


def test_typed_errors_and_fingerprint():
    e = EngineDown("down", retry_after_s=7)
    assert isinstance(e, RuntimeError) and e.retry_after_s == 7
    assert isinstance(PoisonedRequest("p"), RuntimeError)
    assert fingerprint([1, 2, 3]) == fingerprint([1, 2, 3])
    assert fingerprint([1, 2, 3]) != fingerprint([1, 2, 4])
    for ids in ([1, 2, 3], P_POISON, list(range(300))):
        assert fingerprint(ids) == jax_supervisor.fingerprint(ids)


def test_flight_recorder_ring_and_dump(tmp_path, monkeypatch):
    fr = FlightRecorder(capacity=3)
    for i in range(5):
        fr.record(occupancy=i)
    snap = fr.snapshot()
    assert [r["occupancy"] for r in snap] == [2, 3, 4]
    assert [r["seq"] for r in snap] == [3, 4, 5]
    monkeypatch.delenv("CAKE_TRACE_DIR", raising=False)
    assert fr.dump("wedge") is None
    monkeypatch.setenv("CAKE_TRACE_DIR", str(tmp_path))
    path = fr.dump("down", extra={"last_failure": {"kind": "device"}})
    body = json.loads(open(path).read())
    assert body["reason"] == "down" and len(body["iterations"]) == 3
    assert body["last_failure"]["kind"] == "device"
    # never raises: a trace dir that cannot be made is logged, not thrown
    (tmp_path / "file").write_text("")
    monkeypatch.setenv("CAKE_TRACE_DIR", str(tmp_path / "file"))
    assert fr.dump("wedge") is None


# -- engine recovery ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["device", "oom"])
@pytest.mark.parametrize("mode", list(MODES))
def test_step_crash_one_rebuild_in_place(pair, mode, kind):
    """An injected device (or oom) failure at decode step 6 with 3
    concurrent greedy requests costs exactly one rebuild, and every
    request equals the JAX model's greedy tokens. The rebuild resets the
    pool in place: every address the programs read, the graph objects
    and the program count are unchanged (an oom rebuild allocates no
    second pool), and the replay ran through the prefill programs."""
    jm, tm = pair
    plans = ((P_A, 12), (P_B, 10), (P_C, 9))
    refs = [_jax_ref(jm, p, n) for p, n in plans]
    faults.install(f"raise_on_step=6;kind={kind}")
    eng = ServeEngine(tm, slots=4, max_queue=8, ctx_len=CTX, **MODES[mode])
    try:
        ptrs, graph = engine_addresses(eng), eng.graph
        programs = dict(eng.prefill.graphs)
        n_programs = eng.health()["prefill_graphs"]["programs"]
        rs = [eng.submit(p, max_new_tokens=n, sampling=GREEDY)
              for p, n in plans]
        _finish(rs)
        for r, ref in zip(rs, refs):
            assert "error" not in r.result, r.result.get("error")
            assert r.result["tokens"] == ref
        h = eng.health()
        assert eng.supervisor.rebuild_count == 1 and h["rebuilds"] == 1
        assert h["last_failure"]["kind"] == kind
        assert h["step_failures"][kind] == 1
        assert sum(h["step_failures"].values()) == 1
        assert h["last_rebuild"]["replay_chunks"] >= 3
        assert len(h["last_rebuild"]["replayed_tokens"]) == 3
        assert engine_addresses(eng) == ptrs
        assert eng.graph is graph
        assert all(eng.prefill.graphs[k] is g for k, g in programs.items())
        assert h["prefill_graphs"]["programs"] == n_programs
        # one flight record per scheduler iteration, with the pool's
        # blocks when paged
        recs = eng.flight.snapshot()
        assert recs and {"occupancy", "dispatch_ms", "queued",
                         "prefilling"} <= set(recs[-1])
        assert max(r["occupancy"] for r in recs) == 3
        if eng.paged is not None:
            assert {"kv_free", "kv_used"} <= set(recs[-1])
            eng.paged.alloc.check()
        # the pool is fully live afterwards
        r = eng.submit(P_A, max_new_tokens=6, sampling=GREEDY)
        assert r.wait(WAIT) and r.result["tokens"] == refs[0][:6]
    finally:
        eng.close()


def test_contiguous_recompute_rebuild_touches_no_paged_pool(pair):
    """A contiguous engine under preempt_mode="recompute": its rebuild
    replays through `_replay_slot`, which reserves blocks only when the
    pool is paged."""
    jm, tm = pair
    ref = _jax_ref(jm, P_C, 10)
    faults.install("raise_on_step=3;kind=device")
    eng = ServeEngine(tm, slots=2, max_queue=4, ctx_len=CTX,
                      preempt_mode="recompute")
    try:
        assert eng.paged is None
        r = eng.submit(P_C, max_new_tokens=10, sampling=GREEDY)
        assert r.wait(WAIT)
        assert "error" not in r.result, r.result.get("error")
        assert r.result["tokens"] == ref
        assert eng.supervisor.rebuild_count == 1
        assert eng.dead is None
    finally:
        eng.close()


@pytest.fixture(scope="module")
def jax_poison_outputs(pair):
    """The JAX engine's outputs under the poison plan (its own fault
    hook)."""
    jm, _ = pair
    jax_faults.install(f"poison_token={POISON_TOK};poison_after_ops=4")
    eng = JaxServeEngine(jm, slots=4, max_queue=8, ctx_len=CTX)
    try:
        g = JaxSampling(temperature=0.0)
        rs = [eng.submit(P_A, 12, g), eng.submit(P_POISON, 12, g),
              eng.submit(P_C, 9, g)]
        _finish(rs)
        assert isinstance(rs[1].result.get("error"),
                          jax_supervisor.PoisonedRequest)
        return [rs[0].result["tokens"], rs[2].result["tokens"]]
    finally:
        jax_faults.clear()
        eng.close()


@pytest.mark.parametrize("mode", list(MODES))
def test_poison_request_fails_alone(pair, jax_poison_outputs, mode):
    """The poisoned request re-crashes on its own solo replay, fails with
    PoisonedRequest and is quarantined; the others equal the JAX engine's
    outputs under the same plan, in at most 2 rebuilds; a resubmit of the
    poisoned prompt is refused and other traffic still flows."""
    jm, tm = pair
    faults.install(f"poison_token={POISON_TOK};poison_after_ops=4")
    eng = ServeEngine(tm, slots=4, max_queue=8, ctx_len=CTX, **MODES[mode])
    try:
        r_a = eng.submit(P_A, max_new_tokens=12, sampling=GREEDY)
        r_p = eng.submit(P_POISON, max_new_tokens=12, sampling=GREEDY)
        r_c = eng.submit(P_C, max_new_tokens=9, sampling=GREEDY)
        _finish((r_a, r_p, r_c))
        assert isinstance(r_p.result.get("error"), PoisonedRequest)
        assert [r_a.result["tokens"], r_c.result["tokens"]] == \
            jax_poison_outputs
        assert eng.supervisor.rebuild_count <= 2
        h = eng.health()
        assert h["quarantined"] == 1 and h["step_failures"]["poison"] == 1
        with pytest.raises(PoisonedRequest):
            eng.submit(P_POISON, max_new_tokens=4, sampling=GREEDY)
        r = eng.submit(P_C, max_new_tokens=5, sampling=GREEDY)
        assert r.wait(WAIT)
        assert r.result["tokens"] == jax_poison_outputs[1][:5]
    finally:
        eng.close()


@pytest.mark.parametrize("mode", list(MODES))
def test_budget_exhaustion_down_then_restore(pair, mode):
    """Past the rebuild budget the engine goes DOWN: the live request is
    released with EngineDown, submits are refused with a Retry-After, and
    the restore loop's trial chunk revives the engine once the plan is
    spent; the next request equals the reference."""
    jm, tm = pair
    ref = _jax_ref(jm, P_A, 12)
    faults.install("raise_on_step=3;times=2;kind=device")
    eng = ServeEngine(tm, slots=2, max_queue=4, ctx_len=CTX,
                      rebuild_budget=1, restore_interval_s=0.05,
                      **MODES[mode])
    try:
        ptrs = engine_addresses(eng)
        r = eng.submit(P_A, max_new_tokens=24, sampling=GREEDY)
        assert r.wait(WAIT)
        assert isinstance(r.result.get("error"), EngineDown)
        deadline = time.monotonic() + WAIT
        while not eng.supervisor.rebuild_count \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.supervisor.rebuild_count == 1
        if eng.supervisor.is_down():
            info = eng.supervisor.down_info()
            assert "down_for_s" in info and "last_failure" in info
            with pytest.raises(EngineDown) as ei:
                eng.submit(P_A, max_new_tokens=4, sampling=GREEDY)
            assert ei.value.retry_after_s >= 1
        while eng.supervisor.is_down() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not eng.supervisor.is_down(), "restore loop never revived"
        assert eng.dead is None
        r2 = eng.submit(P_A, max_new_tokens=12, sampling=GREEDY)
        assert r2.wait(WAIT)
        assert r2.result["tokens"] == ref
        assert engine_addresses(eng) == ptrs
    finally:
        eng.close()


def test_down_refuses_with_retry_after(pair):
    """While DOWN (a long restore interval keeps it there), a submit is
    refused with EngineDown and a Retry-After past the next probe."""
    _, tm = pair
    faults.install("raise_on_step=2;times=2;kind=device")
    eng = ServeEngine(tm, slots=2, max_queue=4, ctx_len=CTX,
                      rebuild_budget=1, restore_interval_s=600)
    try:
        r = eng.submit(P_B, max_new_tokens=24, sampling=GREEDY)
        assert r.wait(WAIT) and isinstance(r.result["error"], EngineDown)
        assert eng.supervisor.is_down()
        with pytest.raises(EngineDown) as ei:
            eng.submit(P_A, max_new_tokens=4, sampling=GREEDY)
        assert ei.value.retry_after_s >= 601
        assert eng.health()["down"]["last_failure"].startswith("device")
    finally:
        eng.close()


@pytest.mark.parametrize("mode", list(MODES))
def test_watchdog_flags_stalled_step(pair, mode):
    """A dispatch stalled 1.5 s past step_watchdog_s = 0.25 flags the
    engine wedged without killing it; when the stall returns, the request
    completes with the reference's tokens and the flag clears."""
    jm, tm = pair
    ref = _jax_ref(jm, P_A, 15)
    eng = ServeEngine(tm, slots=2, max_queue=4, ctx_len=CTX,
                      step_watchdog_s=0.25, **MODES[mode])
    try:
        warm = eng.submit(P_A, max_new_tokens=15, sampling=GREEDY)
        assert warm.wait(WAIT) and warm.result["tokens"] == ref
        w0 = eng.supervisor.wedge_count
        faults.install("stall_on_step=3;stall_step_ms=1500")
        r = eng.submit(P_A, max_new_tokens=15, sampling=GREEDY)
        saw_wedge = False
        deadline = time.monotonic() + WAIT
        while not r.done.is_set() and time.monotonic() < deadline:
            saw_wedge = saw_wedge or eng.health()["wedged"]
            time.sleep(0.01)
        assert saw_wedge, "watchdog never flagged the stalled dispatch"
        assert eng.supervisor.wedge_count > w0
        assert r.wait(WAIT) and r.result["tokens"] == ref
        assert not eng.health()["wedged"]
        assert eng.supervisor.rebuild_count == 0
    finally:
        eng.close()


def test_cli_reads_supervisor_knobs_from_environment():
    """`cli serve` takes the reference's CAKE_* variables; unset ones keep
    the engine's defaults."""
    from cake_tpu_torch import cli
    env = {"CAKE_STEP_WATCHDOG_S": "2.5", "CAKE_ENGINE_REBUILDS": "7",
           "CAKE_ENGINE_REBUILD_WINDOW_S": "60",
           "CAKE_ENGINE_RESTORE_S": "0.5", "CAKE_PREEMPT_MODE": "swap"}
    assert cli.supervisor_knobs(env) == {
        "step_watchdog_s": 2.5, "rebuild_budget": 7,
        "rebuild_window_s": 60.0, "restore_interval_s": 0.5}
    assert cli.supervisor_knobs({"CAKE_ENGINE_REBUILDS": "1"}) == \
        {"rebuild_budget": 1}
    assert cli.supervisor_knobs({}) == {}


def test_dead_engine_submit_is_typed(pair):
    _, tm = pair
    eng = ServeEngine(tm, slots=1, max_queue=2, ctx_len=CTX)
    eng.close()
    with pytest.raises(EngineDown) as ei:
        eng.submit(P_A, max_new_tokens=4, sampling=GREEDY)
    assert ei.value.retry_after_s >= 1


def test_supervisor_failure_is_the_only_way_to_dead(pair, monkeypatch):
    """A failure inside the supervisor's own recovery path is the last
    resort: the engine dies, every waiter is released with the error."""
    _, tm = pair
    faults.install("raise_on_step=2;kind=device")
    eng = ServeEngine(tm, slots=2, max_queue=4, ctx_len=CTX)
    boom = RuntimeError("supervisor bug")

    def broken(*_):
        raise boom
    monkeypatch.setattr(eng.supervisor, "on_failure", broken)
    try:
        r = eng.submit(P_A, max_new_tokens=12, sampling=GREEDY)
        assert r.wait(WAIT) and r.result["error"] is boom
        assert eng.dead is boom
        with pytest.raises(EngineDown):
            eng.submit(P_A, max_new_tokens=4, sampling=GREEDY)
    finally:
        eng.close()


# -- over HTTP ----------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(
        url + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _health(url):
    try:
        with urllib.request.urlopen(url + "/health", timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _chat(text, stream=False, max_tokens=24):
    return {"messages": [{"role": "user", "content": text}],
            "temperature": 0, "max_tokens": max_tokens, "stream": stream}


def test_http_down_engine_503_json_sse_and_health(pair):
    """A request live when the budget runs out answers 503 + Retry-After;
    while DOWN, the JSON and the SSE path answer 503 + Retry-After (no
    SSE is committed) and /health answers 503 "degraded" with
    engine.down."""
    _, tm = pair
    faults.install("raise_on_step=2;times=2;kind=device")
    eng = ServeEngine(tm, slots=2, max_queue=4, ctx_len=CTX,
                      rebuild_budget=1, restore_interval_s=600)
    app = create_app(tm, eng, tm.tokenizer, port=0).start()
    try:
        status, _ = _health(app.url)
        assert status == 200
        status, headers, raw = _post(app.url, _chat("hello"))
        assert status == 503 and int(headers["Retry-After"]) >= 1, raw
        assert eng.supervisor.is_down()
        for stream in (False, True):
            status, headers, raw = _post(app.url, _chat("again", stream))
            assert status == 503, raw
            assert int(headers["Retry-After"]) >= 1
            assert headers["Content-Type"] == "application/json"
        status, body = _health(app.url)
        assert status == 503 and body["status"] == "degraded"
        assert "down" in body["engine"] and body["engine"]["rebuilds"] == 1
    finally:
        app.stop(drain_s=1)


def test_http_wedged_health_503_then_200(pair):
    _, tm = pair
    eng = ServeEngine(tm, slots=2, max_queue=4, ctx_len=CTX,
                      step_watchdog_s=0.25)
    app = create_app(tm, eng, tm.tokenizer, port=0).start()
    try:
        faults.install("stall_on_step=2;stall_step_ms=1500")
        out = {}
        th = threading.Thread(
            target=lambda: out.update(r=_post(app.url, _chat("stall"))))
        th.start()
        seen = set()
        deadline = time.monotonic() + WAIT
        while th.is_alive() and time.monotonic() < deadline:
            status, body = _health(app.url)
            seen.add((status, body["engine"]["wedged"]))
            time.sleep(0.02)
        th.join(WAIT)
        assert (503, True) in seen, seen
        assert out["r"][0] == 200
        assert _health(app.url)[0] == 200
    finally:
        app.stop(drain_s=1)


def test_http_poisoned_request_answers_500(pair):
    """A chat whose prompt holds the poison token, decoding beside two
    others when the poison arms, answers 500 with PoisonedRequest's
    message; the others answer 200 with their tokens alone; a resubmit
    of the poisoned chat answers 500 at once."""
    _, tm = pair
    tok = tm.tokenizer
    poison = ord("~")
    bodies = [_chat("alpha one", max_tokens=64),
              _chat("beta two", max_tokens=64)]
    eng = ServeEngine(tm, slots=4, max_queue=8, ctx_len=CTX)
    alone = {}
    for b in bodies:
        ids = tok.chat_prompt_ids(b["messages"])
        assert poison not in ids
        r = eng.submit(ids, max_new_tokens=64, sampling=GREEDY)
        assert r.wait(WAIT)
        alone[tuple(ids)] = r.result["tokens"]
        assert len(r.result["tokens"]) == 64    # no early EOS
    submitted = []
    submit = eng.submit
    eng.submit = lambda *a, **k: submitted.append(submit(*a, **k)) or \
        submitted[-1]
    app = create_app(tm, eng, tok, port=0).start()
    try:
        out = {}
        threads = [threading.Thread(target=lambda i=i: out.update(
            {i: _post(app.url, bodies[i])})) for i in range(2)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + WAIT
        while not (len(submitted) == 2 and all(r.tokens for r in submitted)):
            assert time.monotonic() < deadline, "chats never decoded"
            time.sleep(0.002)
        # armed from here: a few decode steps paced at 20 ms let the
        # poisoned chat join the decode set before the poison fires
        faults.install(f"poison_token={poison};poison_after_ops=6;"
                       "delay_ms=20")
        status, _, raw = _post(app.url, _chat("gamma ~ three"))
        for th in threads:
            th.join(WAIT)
        assert status == 500 and "implicated" in json.loads(raw)["error"]
        assert [out[i][0] for i in range(2)] == [200, 200]
        for r in submitted[:2]:
            assert r.result["tokens"] == alone[tuple(r.prompt_ids)]
        assert eng.health()["quarantined"] == 1
        status, _, raw = _post(app.url, _chat("gamma ~ three"))
        assert status == 500 and "quarantined" in json.loads(raw)["error"]
    finally:
        app.stop(drain_s=1)
