"""The port's admission plane (cake_tpu_torch/serve/admission/, the victim
policy of serve/paged/preempt.py) against the JAX package's, host logic
only, on the same inputs:

  * seeded put / pop / purge / drain sequences over the three classes,
    with custom weights and bounds, give the same dequeue order, the same
    QueueFull class, depth and Retry-After, and the same depths;
  * class parsing (weights, bounds), clamping, resolve_class and
    retry_after_for agree over a table of specs, errors included;
  * tenant buckets under one injected clock make identical allow / deny /
    Retry-After / reason decisions, inflight caps and wildcards included,
    and policies parse alike;
  * choose_victim picks the same slot over seeded candidate sets;
  * the plane resolves the same (class, tenant) from the same headers and
    body, a bearer key's fingerprint included."""
from types import SimpleNamespace

import numpy as np
import pytest

from cake_tpu.serve.admission import classes as jcls
from cake_tpu.serve.admission import plane as jplane
from cake_tpu.serve.admission import queue as jqueue
from cake_tpu.serve.admission import tenants as jten
from cake_tpu.serve.paged import preempt as jpre
from cake_tpu_torch.serve.admission import classes as tcls
from cake_tpu_torch.serve.admission import plane as tplane
from cake_tpu_torch.serve.admission import queue as tqueue
from cake_tpu_torch.serve.admission import tenants as tten
from cake_tpu_torch.serve.paged import preempt as tpre

CLASSES = ("interactive", "standard", "batch")


def _queue_trace(mod, seed: int, weights, bounds) -> list:
    """Run one seeded admission sequence; returns what it observed."""
    rng = np.random.default_rng(seed)
    q = mod.AdmissionQueue(4, weights=weights, bounds=bounds)
    out = [("bounds", q.bounds), ("weights", q.weights)]
    for i in range(300):
        op = int(rng.integers(0, 10))
        if op < 5:
            item = SimpleNamespace(qos=CLASSES[int(rng.integers(0, 3))],
                                   n=i)
            try:
                q.put(item, allow_extra=int(rng.integers(0, 2)))
                out.append(("put", i))
            except mod.QueueFull as e:
                out.append(("full", e.qos, e.depth, e.retry_after_s,
                            str(e)))
        elif op < 9:
            item = q.pop()
            out.append(("pop", None if item is None else item.n))
        elif i % 3:
            out.append(("purge", [it.n for it in
                                  q.purge(lambda it: it.n % 4 == 0)]))
        else:
            out.append(("drain", [it.n for it in q.drain()]))
        out.append(("depths", q.depths(), q.depth()))
    return out


@pytest.mark.parametrize("seed,weights,bounds", [
    (0, None, None),
    (1, {"interactive": 3, "batch": 2}, {"batch": 2}),
    (2, {"interactive": 8, "standard": 4, "batch": 1},
     {"interactive": 6, "standard": 1, "batch": 9}),
    (3, {"standard": 0.5}, {"interactive": 2}),
])
def test_weighted_fair_sequence_matches_reference(seed, weights, bounds):
    assert _queue_trace(tqueue, seed, weights, bounds) == \
        _queue_trace(jqueue, seed, weights, bounds)


def test_queue_rejects_what_the_reference_rejects():
    for mod in (jqueue, tqueue):
        for kw in ({"weights": {"batch": 0}}, {"weights": {"gold": 1}},
                   {"bounds": {"batch": 0}}, {"bounds": {"vip": 3}}):
            with pytest.raises(ValueError):
                mod.AdmissionQueue(4, **kw)
        with pytest.raises(ValueError):
            mod.AdmissionQueue(0)


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


RESOLVE_CASES = [
    ("interactive", None, None, None), ("batch", "", None, None),
    ("interactive", "Batch ", None, None), ("batch", None, "standard", None),
    ("interactive", "batch", "standard", None),
    ("interactive", None, None, "standard"),
    ("batch", "interactive", None, "standard"),
    ("interactive", "gold", None, None), ("interactive", None, 7, None),
    ("standard", None, None, "nonsense"), ("batch", None, None, "batch"),
]
SPECS = [None, "", "interactive=2", "batch=3,standard=1.5",
         " interactive = 9 , batch=1 ", "gold=2", "batch=0", "standard=x",
         "interactive=4,,batch=2"]


def test_class_parsing_and_resolution_match_reference():
    for default, header, body, ceiling in RESOLVE_CASES:
        assert _outcome(tcls.resolve_class, default, header, body,
                        ceiling) == \
            _outcome(jcls.resolve_class, default, header, body, ceiling)
    for qos in CLASSES + ("???",):
        assert tcls.priority(qos) == jcls.priority(qos)
        assert tcls.class_of(SimpleNamespace(qos=qos)) == \
            jcls.class_of(SimpleNamespace(qos=qos))
        for ceiling in CLASSES + (None, "x"):
            assert tcls.clamp_class(qos, ceiling) == \
                jcls.clamp_class(qos, ceiling)
    assert tcls.class_of(object()) == jcls.class_of(object())
    for spec in SPECS:
        s = "" if spec is None else spec
        assert _outcome(tcls.class_weights, s) == \
            _outcome(jcls.class_weights, s)
        assert _outcome(tcls.class_bounds, 16, s.replace("1.5", "1")) == \
            _outcome(jcls.class_bounds, 16, s.replace("1.5", "1"))
    rng = np.random.default_rng(5)
    for _ in range(100):
        depth = int(rng.integers(0, 500))
        qos = CLASSES[int(rng.integers(0, 3))]
        w = {c: float(rng.uniform(0.1, 10)) for c in CLASSES}
        assert tcls.retry_after_for(depth, qos, w) == \
            jcls.retry_after_for(depth, qos, w)
    assert (tcls.QOS_HEADER, tcls.TENANT_HEADER) == \
        (jcls.QOS_HEADER, jcls.TENANT_HEADER)


POLICY = ("acme:rps=2,burst=3,inflight=4,max_class=standard;"
          "free:inflight=1;slow:rps=0.5;*:rps=5,burst=1")


def _tenant_trace(mod, seed: int) -> list:
    rng = np.random.default_rng(seed)
    clock = [100.0]
    reg = mod.TenantRegistry(POLICY, clock=lambda: clock[0])
    held: list = []
    out = [("max_class", [reg.max_class(t) for t in
                          ("acme", "free", "zed", None)])]
    for i in range(400):
        op = int(rng.integers(0, 6))
        tenant = ["acme", "free", "slow", "zed", None][int(rng.integers(0, 5))]
        if op < 3:
            try:
                held.append(reg.acquire(tenant))
                out.append(("ok", tenant))
            except mod.TenantQuotaExceeded as e:
                out.append(("deny", tenant, e.reason, e.retry_after_s,
                            e.body()))
        elif op == 3 and held:
            rel = held.pop(int(rng.integers(0, len(held))))
            rel()
            rel()                       # idempotent
        else:
            clock[0] += float(rng.choice([0.0, 0.1, 0.3, 1.0, 2.5]))
        out.append(("inflight", [reg.inflight_of(t)
                                 for t in ("acme", "free", "slow", "zed")]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tenant_decisions_match_reference_under_one_clock(seed):
    got, want = _tenant_trace(tten, seed), _tenant_trace(jten, seed)
    assert got == want
    assert any(e[0] == "deny" and e[2] == "rate" for e in want)
    assert any(e[0] == "deny" and e[2] == "inflight" for e in want)


def test_policy_parsing_matches_reference():
    for spec in (POLICY, "", None, "a:rps=1", "a:burst=4;b:inflight=2"):
        j, t = jten.parse_policies(spec), tten.parse_policies(spec)
        assert {k: (p.rps, p.burst, p.inflight, p.max_class)
                for k, p in t.items()} == \
            {k: (p.rps, p.burst, p.inflight, p.max_class)
             for k, p in j.items()}
    for bad in (":rps=1", "a:speed=3", "a:rps=x"):
        for mod in (jten, tten):
            with pytest.raises(ValueError):
                mod.parse_policies(bad)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_choose_victim_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 7))
        cands = []
        for s in range(n):
            req = None if rng.random() < 0.1 else SimpleNamespace(
                qos=str(rng.choice(list(CLASSES) + ["odd"])),
                t_enqueue=float(rng.integers(0, 20)))
            cands.append((s, req))
        exclude = int(rng.integers(-1, n + 1))
        j = jpre.choose_victim(cands, exclude=exclude)
        t = tpre.choose_victim(cands, exclude=exclude)
        assert (None if t is None else t[0]) == \
            (None if j is None else j[0])
        for _, r in cands:
            if r is not None:
                assert tpre.victim_rank(r) == jpre.victim_rank(r)


def test_plane_resolves_like_the_reference():
    spec = "acme:max_class=standard;*:rps=100"
    jp = jplane.AdmissionPlane(jten.TenantRegistry(spec))
    tp = tplane.AdmissionPlane(tten.TenantRegistry(spec))
    cases = [({}, {}), ({"X-Cake-QoS": "batch"}, {}),
             ({"X-Cake-Tenant": "acme"}, {"qos": "interactive"}),
             ({"Authorization": "Bearer sk-secret"}, {}),
             ({"Authorization": "Bearer  "}, {"qos": "batch"}),
             ({"X-Cake-QoS": "nope"}, {})]
    for headers, body in cases:
        assert _outcome(tp.resolve, headers, body, "interactive") == \
            _outcome(jp.resolve, headers, body, "interactive")
    assert tplane.key_fingerprint("sk-1") == jplane.key_fingerprint("sk-1")
    state = SimpleNamespace()
    assert tplane.get_plane(state) is tplane.get_plane(state)
    tp.begin_drain()
    jp.begin_drain()
    assert tp.health() == jp.health()
    assert tp.health()["draining"] is True
    assert tp.health()["tenant_policies"] == ["*", "acme"]
