"""The fleet telemetry plane and `cli top` against the JAX package's: the
same /metrics texts, ingested on one fake clock by both planes over twin
registries, give the same rollup (burn rates, headroom, percentiles,
outliers, stale and ejected exclusion, series), with only the rollup's own
wall time (`rollup_ms`) left out; the pure helpers (parse_prom_text,
replica_signals, merge_histograms, bucket_quantile, ttft_over_slo,
detect_outliers, the histogram ring) agree under hypothesis; `top`'s
plain render of a rollup equals the reference's line for line; and the
port's scrape goes through its standard-library client."""
import asyncio
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from cake_tpu.fleet import registry as ref_reg
from cake_tpu.fleet import telemetry as ref_tel
from cake_tpu.fleet import top as ref_top
from cake_tpu_torch.fleet import registry, telemetry, top

INF = float("inf")
EDGES = (0.1, 0.25, 0.5, 1.0, INF)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _le_str(e):
    return "+Inf" if e == INF else repr(float(e))


def prom_text(*, ttft=None, itl=None, e2e=None, edges=EDGES, ok=0.0,
              err=0.0, tokens=0.0, queue_depth=0.0, slots_busy=None,
              kv_free=None, kv_used=None, spec=(0.0, 0.0), qos=None) -> str:
    """A replica's /metrics text with the families the rollup reads
    (ttft / itl / e2e: CUMULATIVE bucket vectors over `edges`)."""
    lines = ["# HELP synthetic fixture", "# TYPE whatever counter"]
    for sem, cum in (("ttft", ttft), ("itl", itl), ("e2e", e2e)):
        if cum is None:
            continue
        for e, c in zip(edges, cum):
            lines.append(f'cake_serve_{sem}_seconds_bucket'
                         f'{{outcome="ok",le="{_le_str(e)}"}} {c}')
        lines.append(f'cake_serve_{sem}_seconds_sum{{outcome="ok"}} 1.0')
    lines.append(f'cake_serve_e2e_seconds_count{{outcome="ok"}} {ok}')
    if err:
        lines.append(f'cake_serve_e2e_seconds_count{{outcome="error"}} {err}')
    lines.append(f'cake_generated_tokens_total{{path="serve"}} {tokens}')
    lines.append(f"cake_serve_queue_depth {queue_depth}")
    if slots_busy is not None:
        lines.append(f"cake_serve_slots_busy {slots_busy}")
    if kv_free is not None:
        lines.append(f"cake_serve_kv_blocks_free {kv_free}")
    if kv_used is not None:
        lines.append(f"cake_serve_kv_blocks_used {kv_used}")
    for cls, depth in (qos or {}).items():
        lines.append(f'cake_serve_qos_queue_depth{{qos="{cls}"}} {depth}')
    lines.append(f"cake_serve_spec_proposed_total {spec[0]}")
    lines.append(f"cake_serve_spec_accepted_total {spec[1]}")
    return "\n".join(lines) + "\n"


def _policy(mod):
    return mod.MembershipPolicy(eject_fails=3, err_window=16, err_rate=0.5,
                                degraded_ttft_ms=0.0, eject_s=1.0,
                                replica_inflight=0)


def _empty_window(body) -> bool:
    """A rollup whose TTFT percentiles exist with no observation."""
    ttft = body.get("percentiles", {}).get("ttft")
    return bool(ttft) and ttft.get("p50") is None


def assert_renders_alike(ours: dict, ref: dict) -> None:
    """`top`'s plain render of the port's rollup equals the reference's;
    where the window holds no TTFT observation the reference's raises
    (F3) and the port's prints dashes, every other line equal."""
    got = top.render_screen(ours, "http://r:1")
    if not _empty_window(ref):
        assert got == ref_top.render_screen(ref, "http://r:1")
        return
    with pytest.raises(TypeError):
        ref_top.render_screen(ref, "http://r:1")
    shown = dict(ref, percentiles={})
    want = ref_top.render_screen(shown, "http://r:1")
    assert [ln for ln in got if not ln.startswith("fleet ttft")] \
        == [ln for ln in want if not ln.startswith("fleet ttft")]
    assert any(ln.startswith("fleet ttft p50 -  p95 -  p99 -")
               for ln in got)


class Planes:
    """A telemetry plane of each package over twin registries, on one
    fake clock (rings and membership alike)."""

    def __init__(self, monkeypatch, n, slots=4, **kw):
        self.clock = FakeClock(100.0)
        monkeypatch.setattr(ref_reg, "now", self.clock)
        monkeypatch.setattr(registry, "now", self.clock)
        cfg = dict(fast_window_s=300.0, slow_window_s=3600.0,
                   slo_ttft_ms=2000.0, slo_err_rate=0.01, outlier_k=3.0,
                   outlier_min_n=3, ring=256)
        cfg.update(kw)
        self.regs, self.tels = [], []
        for mod_reg, mod_tel in ((registry, telemetry), (ref_reg, ref_tel)):
            reg = mod_reg.ReplicaRegistry(_policy(mod_reg))
            for i in range(n):
                rep = reg.add(f"t{i}", f"http://h:{i + 1}")
                rep.observe_health(200, {"engine": {
                    "alive": True, "slots": slots, "queue_depth": 1}})
            self.regs.append(reg)
            self.tels.append(mod_tel.FleetTelemetry(reg, clock=self.clock,
                                                    **cfg))

    def both(self, fn):
        """Apply fn(registry) to each registry."""
        for reg in self.regs:
            fn(reg)

    def ingest(self, scrapes, t):
        self.clock.t = t
        bodies = []
        for tel in self.tels:
            body = json.loads(json.dumps(tel.ingest(scrapes, t=t)))
            assert body.pop("rollup_ms")["last"] >= 0.0
            bodies.append(body)
        assert bodies[0] == bodies[1]
        snaps = [json.loads(json.dumps(tel.snapshot())) for tel in self.tels]
        for s in snaps:
            s.pop("rollup_ms")
        assert snaps[0] == snaps[1]
        assert_renders_alike(self.tels[0].snapshot(),
                             self.tels[1].snapshot())
        for r0 in self.regs[0].replicas():
            assert r0.snapshot() == self.regs[1].get(r0.name).snapshot()
        return bodies[0]


def test_burn_rates_and_ttft_over_objective(monkeypatch):
    p = Planes(monkeypatch, 1)
    p.ingest({"t0": prom_text(ok=100.0, ttft=(50, 80, 90, 95, 100))}, 0.0)
    body = p.ingest({"t0": prom_text(ok=195.0, err=5.0,
                                     ttft=(90, 150, 170, 180, 195))}, 60.0)
    assert body["burn_rate"]["fast"] > 1.0
    assert body["percentiles"]["ttft"]["count"] > 0


def test_headroom_accept_rate_and_qos_backlog(monkeypatch):
    p = Planes(monkeypatch, 2)

    def text(tok, busy):
        return prom_text(tokens=tok, slots_busy=busy, kv_free=60,
                         kv_used=40, spec=(tok, tok / 2),
                         qos={"interactive": 1, "batch": 3})
    p.ingest({"t0": text(0.0, 2), "t1": text(0.0, 1)}, 0.0)
    body = p.ingest({"t0": text(1000.0, 2), "t1": text(400.0, 3)}, 100.0)
    assert body["headroom_tokens_per_s"] > 0
    assert body["replicas"]["t0"]["accept_rate"] == 0.5
    assert body["qos_backlog"] == {"batch": 6.0, "interactive": 2.0}


def test_stale_and_ejected_excluded_and_outliers(monkeypatch):
    p = Planes(monkeypatch, 4)
    good = prom_text(ok=50.0, ttft=(40, 45, 48, 50, 50), queue_depth=1)
    p.ingest({f"t{i}": good for i in range(4)}, 0.0)
    slow = prom_text(ok=100.0, ttft=(40, 45, 48, 50, 100), queue_depth=2)
    fine = prom_text(ok=100.0, ttft=(90, 95, 98, 100, 100), queue_depth=1)

    def eject(reg):
        rep = reg.get("t3")
        for _ in range(3):
            rep.record_result(False, transport=True)
    p.both(eject)
    body = p.ingest({"t0": fine, "t1": fine, "t2": slow, "t3": fine}, 30.0)
    assert body["replicas"]["t3"]["eject_evidence"] == "data"
    body = p.ingest({"t0": fine, "t1": fine, "t2": slow, "t3": None}, 60.0)
    assert body["stale"] == ["t3"] and body["outliers"]["t3"] == "stale"


def test_mismatched_edges_and_counter_reset(monkeypatch):
    p = Planes(monkeypatch, 3)
    p.ingest({"t0": prom_text(ok=10, ttft=(5, 6, 8, 10, 10)),
              "t1": prom_text(ok=10, ttft=(1, 2, 3, 4, 10),
                              edges=(0.2, 0.4, 0.8, 1.6, INF)),
              "t2": prom_text(ok=30, ttft=(10, 20, 25, 30, 30))}, 0.0)
    body = p.ingest({"t0": prom_text(ok=20, ttft=(9, 12, 16, 20, 20)),
                     "t1": prom_text(ok=20, ttft=(2, 4, 6, 8, 20),
                                     edges=(0.2, 0.4, 0.8, 1.6, INF)),
                     "t2": prom_text(ok=5, ttft=(1, 2, 3, 5, 5))}, 30.0)
    assert body["mismatched_histograms_skipped"] >= 1


_cum = hst.lists(hst.integers(0, 40), min_size=5, max_size=5).map(
    lambda xs: tuple(float(sum(xs[:i + 1])) for i in range(5)))
_rep_scrape = hst.one_of(hst.none(), hst.builds(
    lambda ttft, ok, err, tok, busy, depth: (ttft, ok, err, tok, busy,
                                             depth),
    _cum, hst.integers(0, 500), hst.integers(0, 20),
    hst.integers(0, 5000), hst.integers(0, 4), hst.integers(0, 9)))


@settings(max_examples=40, deadline=None)
@given(cycles=hst.lists(hst.tuples(hst.floats(1.0, 400.0),
                                   hst.lists(_rep_scrape, min_size=3,
                                             max_size=3)),
                        min_size=1, max_size=8))
def test_random_cycles_agree(cycles):
    mp = pytest.MonkeyPatch()
    try:
        p = Planes(mp, 3)
        t = 0.0
        for dt, reps in cycles:
            t += dt
            scrapes = {}
            for i, r in enumerate(reps):
                if r is None:
                    scrapes[f"t{i}"] = None
                    continue
                ttft, ok, err, tok, busy, depth = r
                scrapes[f"t{i}"] = prom_text(
                    ttft=ttft, ok=float(ok), err=float(err),
                    tokens=float(tok), slots_busy=busy, kv_free=10,
                    kv_used=busy * 3, queue_depth=depth)
            p.ingest(scrapes, t)
    finally:
        mp.undo()


def test_snapshot_before_first_cycle(monkeypatch):
    p = Planes(monkeypatch, 2)
    assert p.tels[0].snapshot() == p.tels[1].snapshot()
    assert top.render_screen(p.tels[0].snapshot()) \
        == ref_top.render_screen(p.tels[1].snapshot())


@settings(max_examples=80, deadline=None)
@given(text=hst.text(max_size=400))
def test_prom_parser_agrees_on_garbage(text):
    assert telemetry.parse_prom_text(text) == ref_tel.parse_prom_text(text)
    assert telemetry.replica_signals(text) == ref_tel.replica_signals(text)


def test_prom_parser_agrees_on_labels():
    text = ('cake_a{x="1,2",y="q\\"uote"} 3\n'
            'cake_b 4.5\nnot_cake 1\ncake_c{le="+Inf"} 7\n'
            'cake_bad{ 1\n' + prom_text(ok=3, ttft=(1, 2, 3, 3, 3)))
    assert telemetry.parse_prom_text(text) == ref_tel.parse_prom_text(text)
    assert telemetry.replica_signals(text) == ref_tel.replica_signals(text)


@settings(max_examples=80, deadline=None)
@given(hists=hst.lists(_cum, min_size=0, max_size=4),
       q=hst.floats(0.0, 1.0), slo=hst.floats(0.0, 2.0))
def test_histogram_math_agrees(hists, q, slo):
    pairs = [(EDGES, h) for h in hists]
    assert telemetry.merge_histograms(pairs) \
        == ref_tel.merge_histograms(pairs)
    for h in hists:
        assert telemetry.bucket_quantile(EDGES, h, q) \
            == ref_tel.bucket_quantile(EDGES, h, q)
        assert telemetry.ttft_over_slo(EDGES, h, slo) \
            == ref_tel.ttft_over_slo(EDGES, h, slo)


@settings(max_examples=80, deadline=None)
@given(stats=hst.dictionaries(
    hst.sampled_from(["a", "b", "c", "d", "e"]),
    hst.fixed_dictionaries({
        "ttft_p95_s": hst.one_of(hst.none(), hst.floats(0.0, 3.0)),
        "err_rate": hst.one_of(hst.none(), hst.floats(0.0, 1.0))})),
       k=hst.floats(0.5, 5.0), min_n=hst.integers(1, 4))
def test_detect_outliers_agrees(stats, k, min_n):
    assert telemetry.detect_outliers(stats, k, min_n) \
        == ref_tel.detect_outliers(stats, k, min_n)


def test_hist_ring_agrees_across_resets():
    clk = FakeClock()
    ours = telemetry._HistRing(60.0, 16, clk)
    ref = ref_tel._HistRing(60.0, 16, clk)
    for t, cum in [(0, (1, 2, 3, 4, 5)), (10, (2, 4, 6, 8, 10)),
                   (20, (1, 1, 1, 1, 1)), (30, (3, 3, 4, 4, 6)),
                   (100, (5, 6, 7, 8, 9))]:
        for ring in (ours, ref):
            ring.record(EDGES, tuple(map(float, cum)), t=float(t))
        for win in (5.0, 15.0, 60.0):
            assert ours.window_delta(win) == ref.window_delta(win)


def test_top_render_screen_equal():
    body = {
        "cycles": 7, "slo": {"ttft_ms": 2000.0, "err_rate": 0.01},
        "burn_rate": {"fast": 1.25, "slow": 0.4},
        "headroom_tokens_per_s": 123.4, "sheds_per_s": 0.5,
        "fleet_queue_depth": 3,
        "percentiles": {"ttft": {"p50": 0.2, "p95": 0.9, "p99": 1.4,
                                 "count": 42}},
        "replicas": {
            "r0": {"state": "healthy", "stale": False, "queue_depth": 1,
                   "occupancy": 0.25, "inflight": 2, "ttft_p95_ms": 850.0,
                   "err_rate": 0.02, "tokens_per_s": 55.5,
                   "accept_rate": 0.8, "headroom_tokens_per_s": 100.0,
                   "outlier": False, "outlier_reason": None,
                   "partition_s": 3.0},
            "r1": {"state": "ejected", "stale": True, "queue_depth": 0,
                   "occupancy": None, "inflight": 0, "ttft_p95_ms": None,
                   "err_rate": None, "tokens_per_s": None,
                   "accept_rate": None, "headroom_tokens_per_s": 0.0,
                   "outlier": True, "outlier_reason": "stale"}},
        "autoscale": {"min": 1, "max": 4, "managed": 2,
                      "pending_spawns": 0,
                      "last": {"kind": "out", "reason": "burn",
                               "replica": "r2", "age_s": 12.0}}}
    for width in (100, 60):
        assert top.render_screen(body, "http://router:8100", width) \
            == ref_top.render_screen(body, "http://router:8100", width)
    assert top.render_screen({"cycles": 0}) \
        == ref_top.render_screen({"cycles": 0})


class _MetricsHandler(BaseHTTPRequestHandler):
    texts: dict = {}

    def log_message(self, *a):
        pass

    def do_GET(self):
        data = self.texts.get(self.server.server_address[1])
        if data is None:
            self.send_response(500)
            self.end_headers()
            return
        body = data.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_collect_scrapes_through_the_stdlib_client(monkeypatch):
    """collect() reads each replica's /metrics with fleet/http.py's
    client: a 200 gives its text, a 500 or a dead port gives None."""
    servers = [ThreadingHTTPServer(("127.0.0.1", 0), _MetricsHandler)
               for _ in range(2)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    ports = [s.server_address[1] for s in servers]
    _MetricsHandler.texts = {ports[0]: prom_text(ok=3.0)}
    reg = registry.ReplicaRegistry(_policy(registry))
    reg.add("up", f"http://127.0.0.1:{ports[0]}")
    reg.add("err", f"http://127.0.0.1:{ports[1]}")
    reg.add("dead", "http://127.0.0.1:9")
    tel = telemetry.FleetTelemetry(reg, clock=FakeClock())
    try:
        got = asyncio.run(tel.collect(timeout_s=2.0))
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
    assert got == {"up": prom_text(ok=3.0), "err": None, "dead": None}


def test_reference_top_raises_on_a_window_without_ttft(monkeypatch):
    """F3: a fleet idle for its fast window keeps its TTFT histograms with
    no observation in the window, so the rollup's percentiles are None;
    the reference's render_screen multiplies them and raises TypeError,
    where the port's prints dashes."""
    p = Planes(monkeypatch, 1)
    zero = (0.0, 0.0, 0.0, 0.0, 0.0)
    p.ingest({"t0": prom_text(ttft=zero)}, 1.0)
    body = p.tels[1].snapshot()
    assert _empty_window(body)
    with pytest.raises(TypeError):
        ref_top.render_screen(body)
    lines = top.render_screen(p.tels[0].snapshot())
    assert "fleet ttft p50 -  p95 -  p99 -  (n=0, fast window)" in lines
