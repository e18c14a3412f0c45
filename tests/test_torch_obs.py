"""The port's metrics plane (cake_tpu_torch/obs/) against the JAX
package's (cake_tpu/obs/), on the CPU, in one process:

  * the same seeded sequence of counter / gauge / histogram operations
    (labels, exemplars, removals) on a fresh registry of each package
    renders the same Prometheus text, the same exemplars, labelsets,
    counts and sums; registration is idempotent and conflicts raise in
    both; reset() keeps the registrations;
  * span exports (complete and instant events, nested spans, request-id
    tagging, the ring bound, disabled recording, a loadable file) have
    the same names, phases, categories and args in both, timestamps
    aside; PhaseTimer reports and records alike;
  * timelines (ring capacity, per-timeline cap with terminal bypass,
    aliases, unknown kinds, the Chrome export) agree, timestamps aside;
    the port's event kinds, trace header and serve spans are the
    reference's;
  * a request id bound in one thread reaches a worker thread that runs in
    a copy of its context, in both packages.
Every test builds fresh instances: nothing reads the process-wide
registry's absolute counts."""
import contextvars
import json
import threading

import numpy as np
import pytest

import cake_tpu.obs as jobs
import cake_tpu_torch.obs as tobs
from cake_tpu.obs import metrics as jmetrics
from cake_tpu.obs import spans as jspans
from cake_tpu.obs import timeline as jtimeline
from cake_tpu_torch.obs import metrics as tmetrics
from cake_tpu_torch.obs import spans as tspans
from cake_tpu_torch.obs import timeline as ttimeline

BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0)


def _drive(registry, seed: int) -> None:
    """A seeded run of metric operations, the same on either registry."""
    rng = np.random.default_rng(seed)
    c = registry.counter("cake_t_requests_total", "requests",
                         labelnames=("endpoint", "status"))
    g = registry.gauge("cake_t_depth", "queue \"depth\"\nper class",
                       labelnames=("qos",))
    h = registry.histogram("cake_t_latency_seconds", "latency",
                           labelnames=("outcome",), buckets=BUCKETS)
    u = registry.counter("cake_t_plain_total")
    hd = registry.histogram("cake_t_default_seconds", "default buckets")
    for i in range(200):
        op = int(rng.integers(0, 6))
        lab = ["/a", "/b", "/c\\d"][int(rng.integers(0, 3))]
        if op == 0:
            c.inc(float(rng.integers(1, 4)), endpoint=lab,
                  status=str(int(rng.choice([200, 429, 503]))))
        elif op == 1:
            g.set(float(rng.integers(0, 50)),
                  qos=["interactive", "batch"][int(rng.integers(0, 2))])
        elif op == 2:
            g.inc(0.5, qos="standard")
            g.dec(0.25, qos="standard")
        elif op == 3:
            v = float(rng.lognormal(-3, 2))
            h.observe(v, exemplar=f"req-{i}" if i % 3 else None,
                      outcome=["ok", "error"][int(rng.integers(0, 2))])
        elif op == 4:
            u.inc()
            hd.observe(float(rng.uniform(0, 200)), exemplar=f"r{i}")
        elif i % 50 == 0:
            c.remove(endpoint="/a", status="200")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_matches_reference(seed):
    jr, tr = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _drive(jr, seed)
    _drive(tr, seed)
    assert tr.render() == jr.render()
    jh = jr.histogram("cake_t_latency_seconds", "latency",
                      labelnames=("outcome",), buckets=BUCKETS)
    th = tr.histogram("cake_t_latency_seconds", "latency",
                      labelnames=("outcome",), buckets=BUCKETS)
    assert th.labelsets() == jh.labelsets()
    for labels in jh.labelsets():
        assert th.exemplars(**labels) == jh.exemplars(**labels)
        assert th.count(**labels) == jh.count(**labels)
        assert th.sum(**labels) == jh.sum(**labels)
    assert tmetrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS


def test_registry_idempotent_conflicts_and_reset():
    for mod in (jmetrics, tmetrics):
        r = mod.MetricsRegistry()
        a = r.counter("x_total", "x", labelnames=("k",))
        assert r.counter("x_total", "x", labelnames=("k",)) is a
        with pytest.raises(ValueError):
            r.gauge("x_total")
        with pytest.raises(ValueError):
            r.counter("x_total", labelnames=("other",))
        with pytest.raises(ValueError):
            a.inc(-1, k="v")
        with pytest.raises(ValueError):
            a.inc(1)                         # labels missing
        a.inc(2, k="v")
        r.reset()
        assert a.value(k="v") == 0.0
        a.inc(1, k="v")                      # the handle stays valid
        assert "x_total{k=\"v\"} 1" in r.render()


def test_serving_instruments_are_the_reference_ones():
    """Every instrument the port declares exists in the reference's
    registry under the same name, type, labels and buckets."""
    port = dict(tobs.REGISTRY._metrics)
    ref = dict(jobs.REGISTRY._metrics)
    assert len(port) >= 30
    for name, m in port.items():
        assert name in ref, name
        r = ref[name]
        assert (m.typ, m.labelnames, m.help) == (r.typ, r.labelnames, r.help)
        if m.typ == "histogram":
            assert m.buckets == r.buckets, name


def _span_sequence(rec, request_scope):
    with request_scope("rid-1"):
        with rec.span("serve.step", cat="serve", slots=2, queued=1):
            with rec.span("serve.prefill_chunk", cat="serve", tokens=16):
                pass
        rec.instant("mark", note="x")
    rec.add("serve.replay", 10, 5, cat="serve", slot=1)
    rec.add("neg", 10, -3)


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "dur", "pid",
                                                     "tid")}


def test_span_export_matches_reference(tmp_path):
    jrec = jspans.SpanRecorder(max_events=16, enabled=True)
    trec = tspans.SpanRecorder(max_events=16, enabled=True)
    _span_sequence(jrec, jspans.request_scope)
    _span_sequence(trec, tspans.request_scope)
    jev, tev = jrec.events(), trec.events()
    assert [_strip(e) for e in tev] == [_strip(e) for e in jev]
    assert [set(e) for e in tev] == [set(e) for e in jev]
    # the child completes (and lands) before its parent, inside it
    chunk, step = tev[0], tev[1]
    assert step["ts"] <= chunk["ts"] and \
        step["ts"] + step["dur"] >= chunk["ts"] + chunk["dur"]
    assert tev[-1]["dur"] == 0 == jev[-1]["dur"]     # clamped at 0
    path = trec.export(str(tmp_path / "trace.json"))
    with open(path) as f:
        data = json.load(f)
    assert set(data) == set(jrec.to_chrome_trace())
    assert [e["name"] for e in data["traceEvents"]] == \
        [e["name"] for e in jev]


def test_span_ring_bound_and_disabled():
    for mod in (jspans, tspans):
        rec = mod.SpanRecorder(max_events=8, enabled=True)
        for i in range(20):
            with rec.span(f"s{i}"):
                pass
        evs = rec.events()
        assert [e["name"] for e in evs] == [f"s{i}" for i in range(12, 20)]
        ts = [e["ts"] for e in evs]
        assert ts == sorted(ts)
        off = mod.SpanRecorder(enabled=False)
        with off.span("x"):
            pass
        off.add("y", 0, 1)
        off.instant("z")
        assert len(off) == 0
    rec = tspans.SpanRecorder(max_events=8, enabled=True)
    for i in range(8):
        rec.add(f"s{i}", i, 1)
    rec.resize(3)                            # the port's knob hook
    assert [e["name"] for e in rec.events()] == ["s5", "s6", "s7"]


def test_phase_timer_matches_reference():
    out = []
    for obs_mod, span_mod in ((jobs, jspans), (tobs, tspans)):
        rec = span_mod.SpanRecorder(enabled=True)
        t = obs_mod.PhaseTimer(recorder=rec)
        for _ in range(3):
            with t("fwd", slot=1):
                pass
        t.add("read", 0.5)
        rep = t.report()
        out.append(({k: v["count"] for k, v in rep.items()},
                    rep["read"]["total_ms"],
                    [_strip(e) for e in rec.events()]))
    assert out[0] == out[1]


def _timeline_sequence(store):
    for i in range(5):
        store.begin(f"r{i}")
    store.begin("r4")                        # idempotent
    store.alias("chatcmpl-4", "r4")
    store.alias("ghost", "r0")               # r0 evicted: no-op
    for j in range(6):
        store.event("r4", "decode", bucket=4)
    store.event("chatcmpl-4", "finish", outcome="ok", tokens=6)
    store.event("r3", "enqueue", depth=0, qos="batch", tenant="t1")
    store.event("nobody", "admit", slot=0)   # unknown id: dropped
    with pytest.raises(ValueError):
        store.event("r3", "no_such_kind")


def _tl_strip(tl):
    tl = dict(tl)
    tl.pop("start_unix")
    tl["events"] = [{k: v for k, v in e.items() if k != "t_ms"}
                    for e in tl["events"]]
    return tl


def test_timeline_matches_reference():
    js = jtimeline.TimelineStore(capacity=3, max_events=4)
    ts = ttimeline.TimelineStore(capacity=3, max_events=4)
    _timeline_sequence(js)
    _timeline_sequence(ts)
    assert ts.ids() == js.ids() == ["r2", "r3", "r4"]
    for rid in ("r2", "r3", "r4", "chatcmpl-4"):
        assert _tl_strip(ts.get(rid)) == _tl_strip(js.get(rid))
    got = ts.get("r4")
    assert got["dropped"] == 2 and got["events"][-1]["kind"] == "finish"
    assert ts.get("r0") is None and js.get("r0") is None
    assert ts.get("ghost") is None and js.get("ghost") is None
    jc, tc = js.to_chrome("chatcmpl-4"), ts.to_chrome("chatcmpl-4")
    assert [{k: v for k, v in e.items() if k != "ts"}
            | {"args": {k: v for k, v in e["args"].items() if k != "t_ms"}}
            for e in tc["traceEvents"]] == \
        [{k: v for k, v in e.items() if k != "ts"}
         | {"args": {k: v for k, v in e["args"].items() if k != "t_ms"}}
         for e in jc["traceEvents"]]
    assert ts.to_chrome("nobody") is None
    ts.clear()
    assert ts.ids() == []


def test_vocabularies_are_the_reference_ones():
    assert tobs.TRACE_HEADER == jobs.TRACE_HEADER == "X-Cake-Request-Id"
    for kind, doc in tobs.EVENT_KINDS.items():
        assert kind in jobs.EVENT_KINDS, kind
    ref_spans = dict(jobs.SPAN_CATALOG)
    names = [n for n, _ in tobs.SPAN_CATALOG]
    assert {"serve.step", "serve.prefill_chunk", "serve.replay"} <= \
        set(names) and all(n in ref_spans for n in names
                           if n.startswith("serve."))
    assert ttimeline.MAX_EVENTS == jtimeline.MAX_EVENTS


def test_request_id_propagates_into_threads():
    for mod in (jspans, tspans):
        rec = mod.SpanRecorder(enabled=True)
        seen = {}
        with mod.request_scope() as rid:
            assert mod.current_request_id() == rid
            with rec.span("in_scope"):
                pass
            ctx = contextvars.copy_context()

            def worker():
                seen["copied"] = ctx.run(mod.current_request_id)
                seen["fresh"] = mod.current_request_id()
            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
        assert seen == {"copied": rid, "fresh": None}
        assert mod.current_request_id() is None     # scope restored
        assert rec.events()[0]["args"]["request_id"] == rid
        mod.set_request_id("x")
        assert mod.current_request_id() == "x"
        mod.set_request_id(None)


def test_configure_applies_the_trace_variables():
    rec_was = (tobs.RECORDER.enabled, tobs.RECORDER._events.maxlen)
    cap_was = tobs.TIMELINES.capacity
    try:
        tobs.configure({"CAKE_TRACE_DIR": "/nonexistent-trace-dir",
                        "CAKE_TRACE_EVENTS": "32",
                        "CAKE_TRACE_REQUESTS": "7"})
        assert tobs.RECORDER.enabled
        assert tobs.RECORDER._events.maxlen == 32
        assert tobs.TIMELINES.capacity == 7
        tobs.configure({})
        assert tobs.RECORDER._events.maxlen == \
            tspans.DEFAULT_TRACE_EVENTS == 16384
        assert tobs.TIMELINES.capacity == \
            ttimeline.DEFAULT_TRACE_REQUESTS == 256
    finally:
        tobs.RECORDER.enabled = rec_was[0]
        tobs.RECORDER.resize(rec_was[1])
        tobs.TIMELINES.capacity = cap_was
