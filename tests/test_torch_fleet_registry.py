"""The fleet's membership machine against the JAX package's: the same
event scripts drive both registries (fleet/registry.py) under one fake
clock, and after every event the replica snapshots (state, eject counts,
evidence, holds, readmits, partition seconds), the results, the drained
membership events and the fleet counters' deltas are equal. The scripts
are the reference's registry scenarios (tests/test_fleet.py: join/leave,
the three gray detectors, half-open trials and their stale outcomes,
evidence gates, flap damping, partition episodes, health-driven ejects,
draining, load mirrors, churn and its tombstones, the warm-up clock,
cordon), plus random scripts under hypothesis; and fault plans parse and
refuse alike (fleet/faults.py)."""
import itertools

import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from cake_tpu import obs as ref_obs
from cake_tpu.fleet import faults as ref_faults
from cake_tpu.fleet import registry as ref_reg
from cake_tpu_torch import obs
from cake_tpu_torch.fleet import faults, registry

_names = itertools.count()

# the fleet counters a registry moves, by name in both packages
COUNTERS = ("FLEET_EJECTS", "FLEET_READMITS", "FLEET_PARTITION_SECONDS")
GAUGES = ("FLEET_REPLICA_QUEUE_DEPTH", "FLEET_REPLICA_OCCUPANCY",
          "FLEET_REPLICA_INFLIGHT", "FLEET_REPLICA_STALE",
          "FLEET_REPLICA_OUTLIER")


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(ref_reg, "now", c)
    monkeypatch.setattr(registry, "now", c)
    return c


def _policy(mod, **kw):
    base = dict(eject_fails=3, err_window=16, err_rate=0.5,
                degraded_ttft_ms=0.0, eject_s=0.05, replica_inflight=0)
    base.update(kw)
    return mod.MembershipPolicy(**base)


def _metric_view(o, names, replicas):
    """{(metric, labels): value} of the fleet instruments for `replicas`
    (the tests' names are unique, so other tests do not leak in)."""
    out = {}
    for name in names:
        m = getattr(o, name)
        for ls in m.labelsets():
            if ls.get("replica") in replicas:
                out[(name, tuple(sorted(ls.items())))] = m.value(**ls)
    return out


class Twin:
    """One registry of each package, driven by the same events."""

    def __init__(self, clock, **policy):
        self.clock = clock
        self.regs = (registry.ReplicaRegistry(_policy(registry, **policy)),
                     ref_reg.ReplicaRegistry(_policy(ref_reg, **policy)))
        self.prefix = f"t{next(_names)}-"
        self.leases = ({}, {})
        self.names = set()
        self.base = [self._metrics(i) for i in range(2)]

    def name(self, short):
        return self.prefix + short

    def _metrics(self, i):
        o = (obs, ref_obs)[i]
        names = {self.name(n) for n in "abcd"}
        return _metric_view(o, COUNTERS + GAUGES, names)

    def do(self, op, *args):
        """Apply one event to both registries; the two results equal."""
        if op == "tick":                # one clock for both
            self.clock.t += args[0]
            self.check()
            return None
        outs = [self._apply(i, op, *args) for i in range(2)]
        assert outs[0] == outs[1], (op, args, outs)
        self.check()
        return outs[0]

    def _apply(self, i, op, *args):
        reg = self.regs[i]
        if op == "add":
            return reg.add(self.name(args[0]), args[1]).name
        if op == "remove":
            return reg.remove(self.name(args[0]))
        if op == "events":
            return reg.drain_events()
        rep = reg.get(self.name(args[0]))
        if op == "result":
            ok, ttfb, transport, lease = args[1:]
            lease = self.leases[i].get(lease, lease)
            return rep.record_result(ok, ttfb, transport=transport,
                                     lease=lease)
        if op == "acquire":
            token = rep.try_acquire()
            self.leases[i][args[1]] = token
            return token
        if op == "release":
            return rep.release(self.leases[i].pop(args[1]))
        if op == "health":
            return rep.observe_health(args[1], args[2])
        if op == "cordon":
            return rep.cordon()
        if op == "outlier":
            return rep.set_outlier(args[1], args[2])
        if op == "cap":
            return (rep.cap(), rep.weight(), rep.routable(),
                    round(rep.warm_age_s(), 6))
        if op == "kv":
            return rep.kv_inventory()
        raise ValueError(op)

    def check(self):
        ours, ref = (r.snapshot() for r in self.regs)
        assert ours == ref
        assert [r.name for r in self.regs[0].replicas()] \
            == [r.name for r in self.regs[1].replicas()]
        for r0 in self.regs[0].replicas():
            r1 = self.regs[1].get(r0.name)
            assert r0.history() == r1.history()
            assert r0.eject_until == r1.eject_until
        assert self.regs[0].total_capacity() == self.regs[1].total_capacity()
        assert self.regs[0].routable_count() == self.regs[1].routable_count()
        assert self.regs[0].total_queue_depth() \
            == self.regs[1].total_queue_depth()
        deltas = []
        for i in range(2):
            now_, base = self._metrics(i), self.base[i]
            deltas.append({k: round(v - base.get(k, 0.0), 9)
                           if k[0] in COUNTERS else v
                           for k, v in now_.items()})
        assert deltas[0] == deltas[1]

    def state(self, short):
        return self.regs[0].get(self.name(short)).snapshot()["state"]


def _fails(t, who, n):
    for _ in range(n):
        t.do("result", who, False, None, True, "slot")


HEALTHY_BODY = {"engine": {"alive": True}}


def test_join_leave(clock):
    t = Twin(clock)
    t.do("add", "a", "http://h:1/")
    t.do("add", "b", "http://h:2")
    t.do("result", "a", False, None, True, "slot")
    t.do("add", "a", "http://h:9")          # re-join keeps state
    assert t.do("remove", "b") and not t.do("remove", "b")


def test_eject_on_consecutive_transport_fails(clock):
    t = Twin(clock, eject_fails=3)
    t.do("add", "a", "http://h:1")
    _fails(t, "a", 2)
    t.do("result", "a", True, 5.0, False, "slot")     # resets the streak
    _fails(t, "a", 3)
    assert t.state("a") == registry.EJECTED
    t.do("events")


def test_eject_on_error_rate_window(clock):
    t = Twin(clock, err_window=8, err_rate=0.5)
    t.do("add", "a", "http://h:1")
    for i in range(8):
        t.do("result", "a", i % 2 == 0, 5.0, False, "slot")
    assert t.state("a") == registry.EJECTED


def test_eject_on_ttfb_p95_gray(clock):
    t = Twin(clock, degraded_ttft_ms=100.0)
    t.do("add", "a", "http://h:1")
    for i in range(8):
        t.do("result", "a", True, 50.0 if i < 6 else 500.0, False, "slot")
    assert t.state("a") == registry.EJECTED


def test_half_open_trial_readmit_and_backoff(clock):
    t = Twin(clock, eject_s=1.0)
    t.do("add", "a", "http://h:1")
    _fails(t, "a", 3)
    t.do("health", "a", 200, HEALTHY_BODY)          # hold not expired
    t.do("tick", 1.01)
    t.do("health", "a", 200, HEALTHY_BODY)          # -> half_open
    assert t.state("a") == registry.HALF_OPEN
    assert t.do("acquire", "a", "trial") == "trial"
    assert t.do("acquire", "a", "second") is None   # one trial only
    t.do("result", "a", False, None, True, "trial")  # re-eject, 2x hold
    t.do("release", "a", "trial")
    t.do("tick", 1.5)
    t.do("health", "a", 200, HEALTHY_BODY)          # still held (2 s)
    t.do("tick", 0.6)
    t.do("health", "a", 200, HEALTHY_BODY)
    t.do("acquire", "a", "trial2")
    t.do("result", "a", True, 5.0, False, "trial2")  # readmit
    t.do("release", "a", "trial2")
    assert t.state("a") == registry.HEALTHY
    t.do("events")


def test_stale_outcomes_and_release_cannot_move_half_open(clock):
    t = Twin(clock, eject_s=1.0)
    t.do("add", "a", "http://h:1")
    t.do("acquire", "a", "old")
    _fails(t, "a", 3)
    t.do("result", "a", True, 5.0, False, "old")     # ejected: ignored
    t.do("tick", 1.1)
    t.do("health", "a", 200, HEALTHY_BODY)
    t.do("acquire", "a", "trial")
    t.do("release", "a", "old")                      # stale release
    t.do("result", "a", False, None, True, "slot")   # stale failure
    assert t.state("a") == registry.HALF_OPEN
    assert t.do("acquire", "a", "again") is None     # trial still held
    t.do("result", "a", True, 3.0, False, "trial")
    assert t.state("a") == registry.HEALTHY


def test_probe_only_readmit_and_data_evidence_gate(clock):
    t = Twin(clock, eject_s=1.0)
    t.do("add", "a", "http://h:1")
    t.do("add", "b", "http://h:2")
    t.do("health", "a", 503, {"engine": {"wedged": True}})   # probe evid.
    _fails(t, "b", 3)                                        # data evid.
    t.do("tick", 1.1)
    for _ in range(3):
        t.do("health", "a", 200, HEALTHY_BODY)
        t.do("health", "b", 200, HEALTHY_BODY)
    assert t.state("a") == registry.HEALTHY         # two probes readmit
    assert t.state("b") == registry.HALF_OPEN       # only a trial can
    t.do("health", "b", None, None)                 # probe failure
    t.do("events")


def test_flap_damping_doubles_hold_each_heal_cycle(clock):
    t = Twin(clock, eject_s=1.0)
    t.do("add", "a", "http://h:1")
    holds = []
    for quiet in (0.0, 0.0, 0.0, 17.0):
        t.do("tick", quiet)
        _fails(t, "a", 3)
        rep = t.regs[0].get(t.name("a"))
        holds.append(round(rep.eject_until - clock.t, 6))
        clock.t = rep.eject_until + 0.01
        t.do("health", "a", 200, HEALTHY_BODY)
        t.do("acquire", "a", "trial")
        t.do("result", "a", True, 5.0, False, "trial")
        t.do("release", "a", "trial")
        t.do("events")
    assert holds == [1.0, 2.0, 4.0, 1.0]


def test_partition_episode_events_and_seconds(clock):
    t = Twin(clock, eject_s=1.0)
    t.do("add", "a", "http://h:1")
    _fails(t, "a", 3)
    ((kind, attrs),) = t.do("events")
    assert kind == "replica_partition_suspected"
    t.do("tick", 2.0)
    t.do("health", "a", 200, HEALTHY_BODY)          # accrues 2 s
    t.do("tick", 1.0)
    t.do("acquire", "a", "trial")
    t.do("result", "a", True, 5.0, False, "trial")  # heal
    t.do("release", "a", "trial")
    ((kind, attrs),) = t.do("events")
    assert kind == "partition_healed" and attrs["episode_s"] == 3.0


@pytest.mark.parametrize("block", [{"down": {"down_for_s": 3}},
                                   {"wedged": True}, {"alive": False}])
def test_health_down_wedged_dead_eject(clock, block):
    t = Twin(clock)
    t.do("add", "a", "http://h:1")
    t.do("health", "a", 503, {"engine": block})
    assert t.state("a") == registry.EJECTED


def test_health_draining_and_load_mirrors(clock):
    t = Twin(clock)
    t.do("add", "a", "http://h:1")
    t.do("cap", "a")
    t.do("health", "a", 200, {"engine": {
        "alive": True, "slots": 4, "slots_busy": 3, "queue_depth": 5,
        "kv_pool": {"blocks": 100, "used": 40, "occupancy": 0.4}}})
    t.do("cap", "a")                                # 2x slots, weight 4
    t.do("health", "a", 200, {"engine": {
        "alive": True, "slots": 2, "slots_busy": 1,
        "kv_pool": {"blocks": 10, "used": 7}}})     # pre-occupancy pool
    t.do("health", "a", 200, {"engine": {"alive": True, "slots": 4,
                                         "slots_busy": 1}})
    t.do("health", "a", 200, {"draining": True, "engine": {"alive": True}})
    assert t.do("acquire", "a", "x") is None        # draining: no routes
    t.do("health", "a", 200, {"engine": {"alive": True,
                                         "draining": True}})
    t.do("cap", "a")


def test_kv_inventory_mirror_and_retraction(clock):
    """The KV-share inventory (engine.kvshare.chains, non-strings
    dropped) is mirrored from each healthy probe, retracted by a stale or
    sick one, empty while EJECTED, and kept while draining or cordoned
    (tests/test_kvshare.py's registry case, plus the eject and cordon
    gates)."""
    t = Twin(clock)
    t.do("add", "a", "http://h:1")
    assert t.do("kv", "a") == ()
    body = {"engine": {"alive": True, "slots": 2,
                       "kvshare": {"chains": ["aa", "bb", 7]}}}
    t.do("health", "a", 200, body)
    assert t.do("kv", "a") == ("aa", "bb")
    t.do("health", "a", None, None)                 # stale: retracted
    assert t.do("kv", "a") == ()
    t.do("health", "a", 200, body)
    t.do("health", "a", 200, {"engine": {"alive": False}})     # sick
    assert t.do("kv", "a") == ()
    t.do("tick", 1.0)
    t.do("health", "a", 200, body)
    t.do("health", "a", 200, body)
    t.do("kv", "a")
    t.do("health", "a", 200, {"draining": True, "engine": dict(
        body["engine"], draining=True)})
    t.do("kv", "a")
    t.do("add", "b", "http://h:2")
    t.do("health", "b", 200, body)
    t.do("cordon", "b")
    assert t.do("kv", "b") == ("aa", "bb")          # cordoned: advertised
    _fails(t, "b", 3)
    assert t.do("kv", "b") == ()                    # ejected: nothing


def test_unreachable_probes_eject_and_retract(clock):
    t = Twin(clock)
    t.do("add", "a", "http://h:1")
    t.do("health", "a", 200, {"engine": {"alive": True, "slots": 2,
                                         "queue_depth": 1}})
    for _ in range(3):
        t.do("health", "a", None, None)
    assert t.state("a") == registry.EJECTED


def test_churn_history_tombstones_and_warmup(clock):
    t = Twin(clock, eject_s=10.0)
    t.do("add", "a", "http://h:1")
    _fails(t, "a", 3)
    t.do("tick", 2.0)
    t.do("remove", "a")
    t.do("add", "a", "http://h:1")                  # hold resumes
    t.do("cap", "a")
    t.do("tick", 20.0)
    t.do("remove", "a")
    t.do("add", "a", "http://h:1")                  # expired: healthy
    assert t.state("a") == registry.HEALTHY
    t.do("health", "a", 200, {"engine": {"alive": True},
                              "started_at_age_s": 50.0})
    t.do("tick", 5.0)
    t.do("cap", "a")
    t.do("health", "a", 200, {"engine": {"alive": True},
                              "started_at_age_s": 1.0})  # restarted
    t.do("cap", "a")


def test_cordon_and_outlier_flags(clock):
    t = Twin(clock)
    t.do("add", "a", "http://h:1")
    t.do("outlier", "a", True, "ttft_p95")
    t.do("cordon", "a")
    assert t.do("acquire", "a", "x") is None
    t.do("health", "a", 200, HEALTHY_BODY)          # stays cordoned
    t.do("outlier", "a", False, None)


_OPS = hst.one_of(
    hst.tuples(hst.just("result"), hst.sampled_from("ab"), hst.booleans(),
               hst.sampled_from([None, 5.0, 400.0]), hst.booleans(),
               hst.sampled_from(["slot", "L0", "L1"])),
    hst.tuples(hst.just("acquire"), hst.sampled_from("ab"),
               hst.sampled_from(["L0", "L1"])),
    hst.tuples(hst.just("health"), hst.sampled_from("ab"),
               hst.sampled_from([None, 200, 503]),
               hst.sampled_from([HEALTHY_BODY, {"engine": {"wedged": True}},
                                 {"engine": {"alive": True, "slots": 3,
                                             "queue_depth": 2}}, None])),
    hst.tuples(hst.just("tick"), hst.sampled_from([0.0, 0.3, 1.1, 9.0])),
    hst.tuples(hst.just("events")),
    hst.tuples(hst.just("cap"), hst.sampled_from("ab")))


@settings(max_examples=60, deadline=None)
@given(script=hst.lists(_OPS, max_size=40))
def test_random_scripts_agree(script):
    clock = Clock()
    saved = (ref_reg.now, registry.now)
    ref_reg.now = registry.now = clock
    try:
        t = Twin(clock, eject_s=1.0, degraded_ttft_ms=100.0, err_window=8)
        t.do("add", "a", "http://h:1")
        t.do("add", "b", "http://h:2")
        for op in script:
            if op[0] == "acquire":
                if op[2] in t.leases[0]:
                    t.do("release", op[1], op[2])
                t.do(*op)
            elif op[0] == "result" and op[5] != "slot" \
                    and op[5] not in t.leases[0]:
                continue
            elif op[0] == "health" and op[2] is None and op[3] is not None:
                t.do("health", op[1], None, None)
            else:
                t.do(*op)
    finally:
        ref_reg.now, registry.now = saved


@pytest.mark.parametrize("plan", [
    "replica=r1;refuse_after_ops=3", "replica=r1;refuse=1",
    "replica=r1;refuse_after_ops=2;refuse_times=2",
    "replica=r2;stall_ms=150", "replica=r2;break_stream_after=3",
    "replica=r2;break_stream_after=1;break_times=1",
    " replica = r3 ; refuse=1 ;"])
def test_fault_plans_parse_and_count_alike(plan):
    ours, ref = faults.parse_plan(plan), ref_faults.parse_plan(plan)
    assert ours.__dict__ == ref.__dict__
    for replica in ("r1", "r2", "r3", "r1", "r3", "r1", "r2"):
        outs = []
        for inj, err in ((ours, faults.InjectedFleetFault),
                         (ref, ref_faults.InjectedFleetFault)):
            try:
                outs.append(("stall", inj.on_attempt(replica)))
            except err as e:
                assert isinstance(e, ConnectionError)
                outs.append(("refused", str(e)))
            outs.append(("break", [inj.break_stream(replica, n)
                                   for n in range(5)]))
        assert outs[:2] == outs[2:]
    assert ours.__dict__ == ref.__dict__


@pytest.mark.parametrize("plan", [
    "", "refuse=1", "replica=r1;bogus=2", "replica=r1;refuse_after_ops",
    "replica=r1,replica=r2", "replica=r1;refuse_after_ops=x"])
def test_fault_plans_refused_alike(plan):
    errs = []
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError) as e:
            mod.parse_plan(plan)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_fault_install_active_clear():
    inj = faults.install("replica=r9;refuse=1")
    try:
        assert faults.active() is inj and faults.FAULT_HOOK is inj
        with pytest.raises(faults.InjectedFleetFault):
            inj.on_attempt("r9")
    finally:
        faults.clear()
    assert faults.active() is None
