"""QoS lanes, victim classes, the "self" park path, deadlines and a
mixed-class rebuild in the port's serve engine, on a tiny llama carried
from the JAX package (ctx 128, greedy), each against the JAX package:

  * two interactive and three batch chats queued behind a busy slot are
    admitted in the same order as the JAX engine admits them (the
    weighted-fair queue: both interactive first), read from the two
    packages' timelines, with the same greedy tokens;
  * a paged batch decoder preempted by an interactive admission's prefill
    resumes bit-identical to the JAX model's sequential tokens, under
    swap and under recompute, and the interactive chat is never
    preempted (the reference's
    test_qos_preempt_batch_slot_resumes_bit_identical);
  * a batch admission that could only grow by evicting an interactive
    decoder parks itself ("self") and completes after it, both chats
    equal to the JAX model's tokens;
  * the queue deadline expires a waiter (503 type) and the request
    deadline cancels a decoding slot and a mid-prefill paged admission
    (504 type), each counted exactly once, the slot reused at once and
    every address the captured programs read unchanged (the references'
    test_engine_queue_deadline_expires_waiters and
    test_request_deadline_cancels_admitted_slot);
  * a rebuild with interactive, standard and batch requests in flight
    and one queued gives every request the JAX model's tokens in one
    rebuild; a DOWN engine drains every class's lane with EngineDown.
Deadlines are driven by backdating a request's enqueue stamp, never by
sleeping them out; every wait has its own timeout, and every engine is
closed. Counters are read as deltas of the process-wide registry."""
import gc
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu import obs as jobs
from cake_tpu.models import TextModel as JaxTextModel
from cake_tpu.models import tiny_config as jax_tiny_config
from cake_tpu.ops.sampling import SamplingConfig as JaxSampling
from cake_tpu.serve import ServeEngine as JaxServeEngine
from cake_tpu.serve import faults as jax_faults
from cake_tpu_torch import obs
from cake_tpu_torch.bench.graph_cases import engine_addresses
from cake_tpu_torch.models import TextModel, tiny_config
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve import (EngineDown, QueueDeadlineExceeded,
                                  RequestDeadlineExceeded, ServeEngine,
                                  faults)
from cake_tpu_torch.utils import params_from_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _collect_reference_engines():
    """Collect, after each test, the JAX serve engines it dropped: their
    admission queues sit in reference cycles, and a JAX queue finalized by
    a later automatic collection, while its thread holds the reference's
    board lock, deadlocks the process (ROADMAP §3, "Not a port fault")."""
    yield
    gc.collect()


GREEDY = SamplingConfig(temperature=0.0)
CTX = 128
WAIT = 120                  # seconds any one request may take
PAGED = dict(slots=2, max_queue=8, ctx_len=CTX, prefill_chunk=16,
             kv_blocks=12, kv_block_tokens=8, prefix_cache_mb=0)

P_BATCH = [3, 17, 42, 99, 7]
# 78 tokens: 10 of the 12 blocks for the prefill alone, so admitting it
# while the batch slot holds blocks exhausts the pool mid-prefill
P_INTER = [5 + (i * 11) % 180 for i in range(78)]


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def pair():
    over = dict(vocab_size=256, max_position_embeddings=CTX)
    jm = JaxTextModel(jax_tiny_config("llama", **over), dtype=jnp.float32,
                      max_cache_len=CTX)
    cfg = tiny_config("llama", **over)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TextModel(cfg, params_from_numpy(cfg, tree, "cpu", torch.float32),
                   dtype=torch.float32, device="cpu", max_cache_len=CTX)
    return jm, tm


def _ref(jm, prompt, n):
    toks, _ = jm.generate(list(prompt), max_new_tokens=n,
                          sampling=JaxSampling(temperature=0.0), spec=False)
    return toks


def _wait(reqs):
    for r in reqs:
        assert r.wait(WAIT), f"request {r.id} hung"


def _until(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _kinds(timelines, rid):
    return [e["kind"] for e in timelines.get(rid)["events"]]


def _admit_ts(timelines, rid):
    return next(e["ts"] for e in timelines.to_chrome(rid)["traceEvents"]
                if e["name"] == "admit")


def _lanes(engine_cls, model, sampling, tag):
    """One slot held by a decoding batch chat; then three batch and two
    interactive chats queue behind it. Returns (ids in admit order,
    {id: tokens})."""
    eng = engine_cls(model, slots=1, max_queue=8, ctx_len=CTX,
                     prefix_cache_mb=0)
    try:
        hold = eng.submit(P_BATCH, max_new_tokens=24, sampling=sampling,
                          request_id=f"{tag}-hold", qos="batch")
        _until(lambda: hold.tokens, "the holding chat never decoded")
        rng = np.random.default_rng(11)
        queued = []
        for i, qos in enumerate(["batch", "batch", "interactive", "batch",
                                 "interactive"]):
            prompt = [int(t) for t in rng.integers(1, 250, 6 + i)]
            queued.append(eng.submit(prompt, max_new_tokens=4,
                                     sampling=sampling,
                                     request_id=f"{tag}-{i}-{qos}", qos=qos))
        assert len(hold.tokens) < 24, "the slot freed before all queued"
        _wait([hold] + queued)
        for r in [hold] + queued:
            assert "error" not in r.result, r.result.get("error")
        timelines = jobs.TIMELINES if engine_cls is JaxServeEngine \
            else obs.TIMELINES
        order = sorted((r.id for r in queued),
                       key=lambda rid: _admit_ts(timelines, rid))
        return ([rid.split("-", 1)[1] for rid in order],
                {r.id.split("-", 1)[1]: r.result["tokens"]
                 for r in [hold] + queued})
    finally:
        eng.close()


def test_lanes_admit_in_the_reference_order(pair):
    jm, tm = pair
    tag = uuid.uuid4().hex[:8]
    want_order, want_tokens = _lanes(JaxServeEngine, jm,
                                     JaxSampling(temperature=0.0),
                                     f"j{tag}")
    got_order, got_tokens = _lanes(ServeEngine, tm, GREEDY, f"t{tag}")
    assert got_order == want_order
    assert [k.split("-")[-1] for k in got_order[:2]] == \
        ["interactive", "interactive"]
    assert got_tokens == want_tokens


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_batch_victim_resumes_bit_identical(pair, mode):
    jm, tm = pair
    before = obs.SERVE_PREEMPTIONS.value(mode=mode)
    eng = ServeEngine(tm, preempt_mode=mode, **PAGED)
    try:
        rb = eng.submit(P_BATCH, max_new_tokens=28, sampling=GREEDY,
                        qos="batch", tenant="acme")
        _until(lambda: len(rb.tokens) >= 3, "batch request never decoded")
        ri = eng.submit(P_INTER, max_new_tokens=6, sampling=GREEDY,
                        qos="interactive")
        _wait([ri, rb])
        for r in (ri, rb):
            assert "error" not in r.result, r.result.get("error")
        assert ri.result["tokens"] == _ref(jm, P_INTER, 6)
        assert rb.result["tokens"] == _ref(jm, P_BATCH, 28)
        assert obs.SERVE_PREEMPTIONS.value(mode=mode) > before, \
            "pool never exhausted: QoS preemption untested"
        assert "preempt" in _kinds(obs.TIMELINES, rb.id)
        assert "resume" in _kinds(obs.TIMELINES, rb.id)
        assert "preempt" not in _kinds(obs.TIMELINES, ri.id)
        ev = obs.TIMELINES.get(rb.id)["events"]
        assert any(e.get("qos") == "batch" and e.get("tenant") == "acme"
                   for e in ev if e["kind"] == "enqueue")
        eng.paged.alloc.check()
    finally:
        eng.close()


def test_batch_admission_parks_itself(pair):
    """An interactive decoder holds 10 of the 12 blocks (72-token prompt,
    8 tokens: it never needs an 11th); a batch admission takes the last
    2 for its first chunk and, for its second, could only evict the
    interactive decoder: it requeues itself instead ("self"), and
    restarts once the decoder is done."""
    jm, tm = pair
    p_int = [7 + (i * 13) % 200 for i in range(72)]
    p_bat = [9 + (i * 5) % 190 for i in range(30)]
    eng = ServeEngine(tm, **PAGED)
    # paced decode steps: the batch admission's two chunks land while the
    # interactive decoder still has tokens to go
    faults.install("delay_ms=30")
    seen = []
    orig = eng._preempt_one

    def spy(*a, **kw):
        got = orig(*a, **kw)
        seen.append(got)
        return got
    eng._preempt_one = spy
    try:
        ri = eng.submit(p_int, max_new_tokens=8, sampling=GREEDY)
        _until(lambda: len(ri.tokens) >= 2, "interactive never decoded")
        rb = eng.submit(p_bat, max_new_tokens=5, sampling=GREEDY,
                        qos="batch")
        _wait([ri, rb])
        for r in (ri, rb):
            assert "error" not in r.result, r.result.get("error")
        assert "self" in seen, seen
        kinds_b = _kinds(obs.TIMELINES, rb.id)
        assert any(e["kind"] == "preempt" and e["mode"] == "requeue"
                   for e in obs.TIMELINES.get(rb.id)["events"])
        assert kinds_b.count("admit") == 1 and "resume" in kinds_b
        assert "preempt" not in _kinds(obs.TIMELINES, ri.id)
        assert ri.result["tokens"] == _ref(jm, p_int, 8)
        assert rb.result["tokens"] == _ref(jm, p_bat, 5)
        eng.paged.alloc.check()
        assert eng.paged.alloc.free_count == eng.paged.num_blocks
    finally:
        eng.close()


def test_queue_deadline_expires_waiters(pair):
    _, tm = pair
    eng = ServeEngine(tm, slots=1, max_queue=4, ctx_len=CTX,
                      queue_deadline_s=5.0)
    try:
        before = obs.SERVE_QUEUE_TIMEOUTS.value()
        busy = eng.submit(P_BATCH, max_new_tokens=100, sampling=GREEDY)
        _until(lambda: busy.tokens, "the busy request never decoded")
        queued = eng.submit([5, 6, 7], max_new_tokens=4, sampling=GREEDY,
                            qos="batch")
        # backdated, not slept out: the next sweep must expire it
        queued.t_enqueue -= 60.0
        assert queued.wait(30), "expired request never finished"
        err = queued.result.get("error")
        assert isinstance(err, QueueDeadlineExceeded), err
        assert err.waited_s >= 5.0 and err.retry_after_s >= 1
        assert not queued.admitted.is_set()
        assert obs.SERVE_QUEUE_TIMEOUTS.value() == before + 1
        assert _kinds(obs.TIMELINES, queued.id)[-1] == "error"
        assert not busy.done.is_set()        # the slot owner decodes on
        busy.cancel()
        _wait([busy])
        assert obs.SERVE_QUEUE_TIMEOUTS.value() == before + 1
    finally:
        eng.close()


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["contiguous", "paged"])
def test_request_deadline_cancels_admitted_slot(pair, kw):
    jm, tm = pair
    kw = {"slots": 2, "ctx_len": CTX, "prefill_chunk": 16, **kw}
    eng = ServeEngine(tm, request_deadline_s=30.0, **kw)
    ptrs, graph = engine_addresses(eng), eng.graph
    programs = dict(eng.prefill.graphs)
    try:
        before = obs.SERVE_REQUEST_TIMEOUTS.value()
        # a decoding slot past its deadline
        r = eng.submit(P_BATCH, max_new_tokens=100, sampling=GREEDY)
        _until(lambda: r.tokens, "request never decoded")
        r.t_enqueue -= 60.0
        _wait([r])
        err = r.result.get("error")
        assert isinstance(err, RequestDeadlineExceeded), err
        assert len(r.tokens) < 100
        assert obs.SERVE_REQUEST_TIMEOUTS.value() == before + 1
        # a mid-prefill admission past its deadline, beside a decoder
        # whose paced steps (delay_ms) outlast the backdate
        faults.install("delay_ms=30")
        c = eng.submit([4, 5, 6], max_new_tokens=20, sampling=GREEDY)
        _until(lambda: c.tokens, "companion never decoded")
        n = 60 if kw.get("kv_blocks") else 120
        m = eng.submit([11 + (i * 7) % 200 for i in range(n)],
                       max_new_tokens=4, sampling=GREEDY)
        _until(lambda: m.admitted.is_set() or m.done.is_set(),
               "never admitted")
        m.t_enqueue -= 60.0
        _wait([m])
        assert isinstance(m.result.get("error"), RequestDeadlineExceeded)
        assert m.tokens == []
        kinds = _kinds(obs.TIMELINES, m.id)
        assert "prefill_done" not in kinds and kinds[-1] == "error"
        assert obs.SERVE_REQUEST_TIMEOUTS.value() == before + 2
        assert not c.done.is_set()
        c.cancel()
        _wait([c])
        faults.clear()
        # the slots are free at once, and reused
        assert eng.health()["slots_busy"] == 0
        r2 = eng.submit(P_INTER[:20], max_new_tokens=3, sampling=GREEDY)
        _wait([r2])
        assert "error" not in r2.result, r2.result.get("error")
        assert r2.result["tokens"] == _ref(jm, P_INTER[:20], 3)
        if eng.paged is not None:
            eng.paged.alloc.check()
            assert eng.paged.alloc.free_count == eng.paged.num_blocks
        # nothing rebound: the captured programs read the same addresses
        assert engine_addresses(eng) == ptrs and eng.graph is graph
        assert all(eng.prefill.graphs[k] is g for k, g in programs.items())
        assert obs.SERVE_REQUEST_TIMEOUTS.value() == before + 2
    finally:
        eng.close()


def test_rebuild_with_every_class_in_flight(pair):
    jm, tm = pair
    rebuilds = obs.SERVE_ENGINE_REBUILDS.value()
    device = obs.SERVE_STEP_FAILURES.value(kind="device")
    prompts = {"interactive": [3, 17, 42, 99, 7], "standard": [8, 8, 1, 30],
               "batch": [100, 2, 5, 9, 11, 40], "queued": [4, 44, 4, 44]}
    eng = ServeEngine(tm, slots=3, max_queue=4, ctx_len=CTX)
    try:
        faults.install("raise_on_step=6;kind=device")
        reqs = {q: eng.submit(p, max_new_tokens=12, sampling=GREEDY,
                              qos="batch" if q == "queued" else q)
                for q, p in prompts.items()}
        _wait(reqs.values())
        for q, r in reqs.items():
            assert "error" not in r.result, (q, r.result.get("error"))
            assert r.result["tokens"] == _ref(jm, prompts[q], 12), q
        h = eng.health()
        assert h["rebuilds"] == 1
        assert obs.SERVE_ENGINE_REBUILDS.value() == rebuilds + 1
        assert obs.SERVE_STEP_FAILURES.value(kind="device") == device + 1
        failed = [q for q, r in reqs.items()
                  if "step_failure" in _kinds(obs.TIMELINES, r.id)]
        assert sorted(failed) == ["batch", "interactive", "standard"]
        assert h["queue_by_class"] == {"interactive": 0, "standard": 0,
                                       "batch": 0}
    finally:
        eng.close()


def test_down_drains_every_lane(pair):
    _, tm = pair
    eng = ServeEngine(tm, slots=1, max_queue=4, ctx_len=CTX,
                      rebuild_budget=1, restore_interval_s=0.2)
    try:
        # a long first request holds the one slot while the others queue
        reqs = [eng.submit(P_BATCH, max_new_tokens=100, sampling=GREEDY)]
        reqs += [eng.submit([5 + i, 6, 7], max_new_tokens=4,
                            sampling=GREEDY, qos=q)
                 for i, q in enumerate(("batch", "standard", "interactive",
                                        "batch"))]
        # the plan counts dispatches from here: all five are queued (one
        # decoding, four in their lanes) before the first failing
        # dispatch, however slowly this thread ran the submits
        faults.install("raise_on_step=3;times=2;kind=device")
        _wait(reqs)
        errs = [r.result.get("error") for r in reqs]
        assert all(isinstance(e, EngineDown) for e in errs), errs
        assert eng.queue.depth() == 0
        faults.clear()
        _until(lambda: not eng.supervisor.is_down(), "never revived", 60)
        assert obs.SERVE_ENGINE_DOWN.value() == 0
        r = eng.submit(P_BATCH, max_new_tokens=3, sampling=GREEDY,
                       qos="standard")
        _wait([r])
        assert "error" not in r.result, r.result.get("error")
    finally:
        eng.close()
