"""The port's closed-loop autoscaler (fleet/autoscale.py) and replica
lifecycle (fleet/lifecycle.py) against the JAX package's.

Every decision-table scenario of tests/test_autoscale.py runs through both
packages' pure `decide` (and `select_victim`, `DecisionLog`) on the same
inputs and one fake clock, and the decisions (action, reason, victim,
detail) and controller states are equal; hypothesis drives random
rollups and fleet views through both. `Autoscaler.step` over a stub
lifecycle, and `ReplicaLifecycle` over stub processes and a fake prober
(spawn -> admit, spawn timeout, retire -> cordon -> reap, sweep on an
unexpected death, no template), give the same decisions ring, registry
membership and counters in both. The router's no-replica 503 carries the
spawn ETA as Retry-After in both. No process is started and no socket
opened, apart from the port's default prober against a closed port."""
import asyncio
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cake_tpu import fleet as ref_fleet
from cake_tpu import obs as ref_obs
from cake_tpu.fleet import autoscale as ref_as
from cake_tpu.fleet import lifecycle as ref_lc
from cake_tpu_torch import fleet, obs
from cake_tpu_torch.fleet import autoscale as port_as
from cake_tpu_torch.fleet import lifecycle as port_lc

PKGS = {"jax": (ref_as, ref_lc, ref_fleet, ref_obs),
        "port": (port_as, port_lc, fleet, obs)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _policy(m, **kw):
    base = dict(burn_fast=2.0, headroom_min=100.0, headroom_high=500.0,
                cooldown_s=10.0, min_replicas=1, max_replicas=4,
                warmup_s=5.0, enabled=True)
    base.update(kw)
    return m.ScalePolicy(**base)


def _rep(name, state="healthy", warm=1000.0, managed=True, outlier=False,
         cordoned=False, headroom=0.0, mass=0.0):
    return {"name": name, "state": state, "warm_age_s": warm,
            "managed": managed, "outlier": outlier, "cordoned": cordoned,
            "headroom_tokens_per_s": headroom, "affinity_mass": mass,
            "inflight": 0, "stale": False}


def _view(*reps, pending=0):
    return {"replicas": list(reps), "pending_spawns": pending}


def _rollup(fast=0.0, slow=0.0, headroom=1000.0, qos=None):
    return {"burn_rate": {"fast": fast, "slow": slow},
            "headroom_tokens_per_s": headroom, "qos_backlog": qos or {}}


def _d(d, st_=None):
    """A decision (and the controller state after it) as plain data."""
    out = [d.action, d.reason, d.victim, json.loads(json.dumps(d.detail))]
    if st_ is not None:
        out.append((st_.last_action_t, st_.high_since))
    return out


# -- decide(): the reference's decision table ----------------------------------

def sc_fast_burn(m):
    st_ = m.ControllerState()
    d = m.decide(_rollup(fast=2.5), _view(_rep("a"), _rep("b")),
                 _policy(m), st_, t=100.0)
    assert d.action == m.SCALE_OUT and d.reason == "burn_fast"
    return [_d(d, st_)]


def sc_low_headroom(m):
    return [_d(m.decide(_rollup(headroom=50.0), _view(_rep("a"), _rep("b")),
                        _policy(m, headroom_min=100.0), m.ControllerState(),
                        t=0.0))]


def sc_headroom_trigger_off(m):
    return [_d(m.decide(_rollup(headroom=0.0), _view(_rep("a"), _rep("b")),
                        _policy(m, headroom_min=0.0), m.ControllerState(),
                        t=0.0))]


def sc_capped_at_max(m):
    reps = [_rep(f"r{i}") for i in range(4)]
    return [_d(m.decide(_rollup(fast=9.0), _view(*reps),
                        _policy(m, max_replicas=4), m.ControllerState(),
                        t=0.0)),
            _d(m.decide(_rollup(fast=9.0), _view(*reps[:3], pending=1),
                        _policy(m, max_replicas=4), m.ControllerState(),
                        t=0.0))]


def sc_one_action_per_cooldown(m):
    st_ = m.ControllerState()
    pol = _policy(m, cooldown_s=10.0, max_replicas=8)
    v = _view(_rep("a"), _rep("b"))
    return [_d(m.decide(_rollup(fast=5.0), v, pol, st_, t=t), st_)
            for t in (0.0, 5.0, 10.0)]


def sc_warming_and_pending_hold(m):
    pol = _policy(m, warmup_s=30.0)
    return [_d(m.decide(_rollup(fast=5.0),
                        _view(_rep("a"), _rep("new", warm=3.0)), pol,
                        m.ControllerState(), t=100.0)),
            _d(m.decide(_rollup(fast=5.0), _view(_rep("a"), pending=1),
                        pol, m.ControllerState(), t=100.0))]


def sc_below_min_bypasses(m):
    st_ = m.ControllerState()
    pol = _policy(m, min_replicas=2, cooldown_s=60.0, warmup_s=30.0)
    st_.last_action_t = 99.0
    return [_d(m.decide(_rollup(), _view(_rep("a", warm=1.0)), pol, st_,
                        t=100.0), st_),
            _d(m.decide(_rollup(), _view(_rep("a", warm=1.0), pending=1),
                        pol, st_, t=101.0), st_)]


def sc_disabled(m):
    return [_d(m.decide(_rollup(fast=9.0), _view(),
                        _policy(m, enabled=False), m.ControllerState(),
                        t=0.0))]


def sc_scale_in_dwell(m):
    st_ = m.ControllerState()
    pol = _policy(m, cooldown_s=10.0, min_replicas=1)
    v = _view(_rep("a", headroom=300.0, mass=50.0),
              _rep("b", headroom=200.0, mass=10.0))
    return [_d(m.decide(_rollup(headroom=800.0), v, pol, st_, t=t), st_)
            for t in (100.0, 105.0, 110.0)]


def sc_dwell_resets(m):
    st_ = m.ControllerState()
    pol = _policy(m, cooldown_s=10.0)
    v = _view(_rep("a", headroom=300.0), _rep("b", headroom=200.0))
    steps = [(800.0, 0.0, 0.0), (400.0, 0.0, 5.0), (800.0, 0.0, 6.0),
             (800.0, 0.0, 15.0), (800.0, 1.5, 16.0)]
    return [_d(m.decide(_rollup(headroom=h, slow=s), v, pol, st_, t=t), st_)
            for h, s, t in steps]


def sc_at_min_and_no_victim(m):
    out = [_d(m.decide(_rollup(headroom=900.0),
                       _view(_rep("a", headroom=400.0),
                             _rep("b", headroom=400.0)),
                       _policy(m, cooldown_s=0.0, min_replicas=2),
                       m.ControllerState(), t=0.0))]
    v = _view(_rep("a", managed=False), _rep("b", managed=False),
              _rep("c", managed=False))
    out.append(_d(m.decide(_rollup(headroom=900.0), v,
                           _policy(m, cooldown_s=0.0), m.ControllerState(),
                           t=0.0)))
    return out


def sc_hysteresis(m):
    pol = _policy(m, cooldown_s=0.0, headroom_min=300.0, headroom_high=500.0)
    v = _view(_rep("a", headroom=100.0, mass=50.0),
              _rep("b", headroom=450.0, mass=1.0))
    return [_d(m.decide(_rollup(headroom=550.0), v, pol,
                        m.ControllerState(), t=0.0))]


def sc_oscillating_trace(m):
    st_ = m.ControllerState()
    pol = _policy(m, cooldown_s=10.0, max_replicas=16, warmup_s=0.0)
    v = _view(*[_rep(f"r{i}", headroom=100.0) for i in range(6)])
    out = []
    for i in range(60):
        d = m.decide(_rollup(fast=3.0 if i % 2 == 0 else 0.2,
                             headroom=900.0 if i % 2 else 120.0),
                     v, pol, st_, float(i))
        out.append(_d(d, st_))
    assert sum(1 for o in out if o[0] != m.HOLD) <= 6
    return out


def sc_outliers_only_pick_the_victim(m):
    pol = _policy(m, cooldown_s=0.0)
    plain = [_rep("a", headroom=300.0, mass=5.0),
             _rep("b", headroom=300.0, mass=50.0)]
    flagged = [dict(r, outlier=(r["name"] == "b")) for r in plain]
    out = []
    for rollup in (_rollup(fast=5.0), _rollup(headroom=900.0),
                   _rollup(headroom=300.0)):
        for reps in (plain, flagged):
            out.append(_d(m.decide(rollup, _view(*reps), pol,
                                   m.ControllerState(), t=100.0)))
    return out


def sc_batch_backlog_not_a_trigger(m):
    return [_d(m.decide(_rollup(headroom=300.0, qos={"batch": 50000.0}),
                        _view(_rep("a"), _rep("b")), _policy(m),
                        m.ControllerState(), t=0.0)),
            _d(m.decide(_rollup(fast=3.0, qos={"batch": 50000.0}),
                        _view(_rep("a"), _rep("b")), _policy(m),
                        m.ControllerState(), t=0.0))]


def sc_select_victim(m):
    reps = [_rep("big", mass=100.0), _rep("small", mass=1.0),
            _rep("bad", mass=999.0, outlier=True),
            _rep("foreign", mass=0.0, managed=False),
            _rep("leaving", mass=0.0, cordoned=True),
            _rep("downed", mass=0.0, state="ejected")]
    return [m.select_victim(reps)["name"],
            m.select_victim([r for r in reps
                             if r["name"] != "bad"])["name"],
            m.select_victim([_rep("x", managed=False)])]


def sc_decision_log(m):
    clk = FakeClock()
    log = m.DecisionLog(cap=8, clock=clk)
    with pytest.raises(ValueError):
        log.record("resize")            # not in the closed catalog
    for i in range(12):
        log.record("hold", t=float(i), reason=f"h{i}")
    evs = log.events(t=20.0)
    log.record("scale_out", t=15.0, reason="burn_fast")
    return [evs, log.last("scale_out"), log.last("scale_in"),
            sorted(m.DECISION_KINDS)]


DECIDE = {f.__name__[3:]: f for f in (
    sc_fast_burn, sc_low_headroom, sc_headroom_trigger_off, sc_capped_at_max,
    sc_one_action_per_cooldown, sc_warming_and_pending_hold,
    sc_below_min_bypasses, sc_disabled, sc_scale_in_dwell, sc_dwell_resets,
    sc_at_min_and_no_victim, sc_hysteresis, sc_oscillating_trace,
    sc_outliers_only_pick_the_victim, sc_batch_backlog_not_a_trigger,
    sc_select_victim, sc_decision_log)}


@pytest.mark.parametrize("name", list(DECIDE))
def test_decision_table_matches_reference(name):
    assert DECIDE[name](port_as) == DECIDE[name](ref_as)


_REP = st.fixed_dictionaries({
    "state": st.sampled_from(["healthy", "half_open", "ejected",
                              "draining"]),
    "warm": st.floats(0.0, 100.0), "managed": st.booleans(),
    "outlier": st.booleans(), "cordoned": st.booleans(),
    "headroom": st.floats(0.0, 1000.0), "mass": st.floats(0.0, 100.0)})


@settings(max_examples=80, deadline=None)
@given(reps=st.lists(_REP, max_size=6), pending=st.integers(0, 3),
       cycles=st.lists(st.tuples(st.floats(0.0, 6.0), st.floats(0.0, 3.0),
                                 st.floats(0.0, 1500.0),
                                 st.floats(0.0, 30.0)),
                       min_size=1, max_size=6),
       pol=st.fixed_dictionaries({
           "headroom_min": st.sampled_from([0.0, 100.0, 300.0]),
           "headroom_high": st.sampled_from([0.0, 500.0]),
           "cooldown_s": st.sampled_from([0.0, 10.0]),
           "min_replicas": st.integers(0, 3),
           "max_replicas": st.integers(1, 6)}))
def test_random_rollups_and_views_agree(reps, pending, cycles, pol):
    def run(m):
        state = m.ControllerState()
        view = _view(*[_rep(f"r{i}", r["state"], r["warm"], r["managed"],
                            r["outlier"], r["cordoned"], r["headroom"],
                            r["mass"]) for i, r in enumerate(reps)],
                     pending=pending)
        out, t = [], 0.0
        for fast, slow, headroom, dt in cycles:
            t += dt
            out.append(_d(m.decide(_rollup(fast, slow, headroom), view,
                                   _policy(m, **pol), state, t), state))
        out.append(m.select_victim(view["replicas"]))
        return out
    assert run(port_as) == run(ref_as)


# -- Autoscaler.step and the lifecycle under one fake clock -----------------

def _mpolicy(f):
    return f.MembershipPolicy(eject_fails=3, err_window=16, err_rate=0.5,
                              degraded_ttft_ms=0.0, eject_s=0.05,
                              replica_inflight=0)


class StubLifecycle:
    def __init__(self):
        self.spawns, self.retires = [], []

    def pending_count(self):
        return 0

    def is_managed(self, name):
        return True

    def managed_names(self):
        return []

    def spawn(self, reason=""):
        self.spawns.append(reason)

    def retire(self, name, reason=""):
        self.retires.append((name, reason))
        return True

    def snapshot(self):
        return {"managed": [], "pending_spawns": 0, "spawn_eta_s": None,
                "spawn_cmd_set": False}


def _scale_counter(o) -> dict:
    m = o.FLEET_SCALE_ACTIONS
    return {tuple(sorted(ls.items())): m.value(**ls) for ls in m.labelsets()}


def test_autoscaler_step_matches_reference():
    """tests/test_autoscale.py's step scenario (identical holds land once,
    a breach spawns, a later hold is recorded again), plus a scale-in
    through the stub lifecycle: the same ring, summary, snapshot and
    executed-action counts in both packages."""
    def run(kind):
        m, _, f, o = PKGS[kind]
        before = _scale_counter(o)
        clk = FakeClock(100.0)
        reg = f.ReplicaRegistry(_mpolicy(f))
        reg.add("a", "http://h:1")
        reg.add("b", "http://h:2")
        lc = StubLifecycle()
        log = m.DecisionLog(cap=64, clock=clk)
        a = m.Autoscaler(reg, lc, policy=_policy(m, warmup_s=0.0,
                                                 cooldown_s=10.0),
                         log=log, clock=clk)
        steady = _rollup(headroom=200.0)
        for _ in range(5):
            a.step(steady)
            clk.t += 1.0
        a.step(_rollup(fast=5.0))
        clk.t += 20.0
        a.step(steady)
        for _ in range(3):              # comfort past a full dwell
            clk.t += 6.0
            a.step(_rollup(headroom=900.0))
        snap = a.snapshot()
        for row in snap["lifecycle"]["managed"]:
            row.pop("pid", None)
        after = _scale_counter(o)
        return {"ring": log.events(), "summary": a.summary(), "snap": snap,
                "spawns": lc.spawns, "retires": lc.retires,
                "counted": {k: v - before.get(k, 0.0)
                            for k, v in after.items()
                            if v - before.get(k, 0.0)}}
    ours, ref = run("port"), run("jax")
    assert ours == ref
    assert ours["spawns"] == ["burn_fast"]


class FakeProc:
    """Popen-like stub (poll/terminate/kill/wait) with a pid that names no
    process: the kill path falls back to .kill()."""

    def __init__(self, pid=4_190_000):
        self.pid = pid
        self.returncode = None
        self.terminated = self.killed = False

    def poll(self):
        return self.returncode

    def terminate(self):
        self.terminated = True
        self.returncode = -15

    def kill(self):
        self.killed = True
        self.returncode = -9

    def wait(self, timeout=None):
        return self.returncode


def _lifecycle_run(kind, script):
    """Run `script(lc, reg, clk, procs)` against package `kind`'s
    ReplicaLifecycle with a decisions ring, stub processes and a prober
    that advances the fake clock 4 s per probe; returns what both
    packages must agree on."""
    m, lcm, f, o = PKGS[kind]

    async def main():
        clk = FakeClock(100.0)
        reg = f.ReplicaRegistry(_mpolicy(f))
        log = m.DecisionLog(cap=64, clock=clk)
        procs = []

        def spawner(cmd):
            procs.append((cmd[:2], FakeProc()))
            return procs[-1][1]

        async def prober(url):
            clk.t += 4.0
            return script.healthy(len(procs))

        lc = lcm.ReplicaLifecycle(
            reg, spawn_cmd="serve --name {name} --port {port}",
            spawn_timeout_s=30.0, drain_timeout_s=1.0, record=log.record,
            clock=clk, spawner=spawner, prober=prober)
        got = await script(lc, reg, clk, procs)
        ring = [{k: v for k, v in e.items() if k not in ("pid", "port")}
                for e in log.events()]
        snap = lc.snapshot()
        for row in snap["managed"]:
            row.pop("pid")
            row.pop("port")
        out = {"ring": ring, "names": reg.names(), "snap": snap, "got": got,
               "procs": [(c, p.terminated, p.killed) for c, p in procs],
               "gauges": (o.FLEET_SCALE_PENDING_SPAWNS.value(),
                          o.FLEET_SCALE_MANAGED_REPLICAS.value())}
        await lc.close()
        return out
    return asyncio.run(main())


async def _spawn_admit_eta(lc, reg, clk, procs):
    name = lc.spawn(reason="burn_fast")
    eta0 = lc.pending_spawn_eta()
    for _ in range(3):
        await asyncio.sleep(0)
    lc.spawn(reason="headroom_low")
    return [name, eta0, lc.pending_count(), lc.pending_spawn_eta()]
_spawn_admit_eta.healthy = lambda n: True


async def _spawn_timeout(lc, reg, clk, procs):
    lc.spawn(reason="burn_fast")
    for _ in range(12):
        await asyncio.sleep(0)
    return lc.managed_names()
_spawn_timeout.healthy = lambda n: False


async def _retire_reap(lc, reg, clk, procs):
    lc.spawn()
    for _ in range(3):
        await asyncio.sleep(0)
    rep = reg.get("scale-1")
    before = (rep.routable(), rep.snapshot()["state"])
    retired = lc.retire("scale-1", reason="headroom_high")
    during = (rep.routable(), rep.try_acquire(), rep.snapshot()["state"],
              lc.retire("scale-1"))
    for _ in range(3):
        await asyncio.sleep(0)
    return [before, retired, during, lc.retire("ghost")]
_retire_reap.healthy = lambda n: True


async def _sweep_death(lc, reg, clk, procs):
    lc.spawn()
    for _ in range(3):
        await asyncio.sleep(0)
    alive = lc.sweep()
    procs[0][1].returncode = -9             # kill -9 from outside
    return [alive, lc.sweep(), lc.managed_names()]
_sweep_death.healthy = lambda n: True


@pytest.mark.parametrize("script", [_spawn_admit_eta, _spawn_timeout,
                                    _retire_reap, _sweep_death],
                         ids=lambda f: f.__name__.strip("_"))
def test_lifecycle_matches_reference(script):
    ours, ref = (_lifecycle_run(k, script) for k in ("port", "jax"))
    assert ours == ref
    assert [e["kind"] for e in ours["ring"]][0] == "spawned"


def test_lifecycle_without_template_and_default_prober():
    for kind in ("port", "jax"):
        _, lcm, f, _ = PKGS[kind]
        events = []
        lc = lcm.ReplicaLifecycle(f.ReplicaRegistry(_mpolicy(f)),
                                  spawn_cmd=None,
                                  record=lambda k, **x: events.append(k))
        assert lc.spawn(reason="burn_fast") is None
        assert events == [] and not lc.managed_names()
        assert lc.snapshot()["spawn_cmd_set"] is False
    # the port's standard-library prober: a closed port is not healthy
    lc = port_lc.ReplicaLifecycle(fleet.ReplicaRegistry(_mpolicy(fleet)),
                                  spawn_cmd=None)
    assert asyncio.run(lc._default_prober("http://127.0.0.1:9")) is False


def test_no_replica_503_carries_spawn_eta():
    out = {}
    for kind in ("port", "jax"):
        _, lcm, f, _ = PKGS[kind]
        router = f.FleetRouter(f.ReplicaRegistry(_mpolicy(f)),
                               autoscale=True)
        assert router.autoscaler.policy.enabled     # the flag wins
        clk = FakeClock(100.0)
        router.lifecycle._clock = clk
        router.lifecycle._managed["scale-1"] = lcm.ManagedReplica(
            "scale-1", 18080, FakeProc(), spawned_at=97.0)
        resp = router._no_replica()
        pending = (resp.status, resp.headers["Retry-After"],
                   json.loads(resp.body))
        router.lifecycle._managed.clear()
        resp = router._no_replica()
        out[kind] = (pending, resp.status, json.loads(resp.body),
                     int(resp.headers["Retry-After"]) >= 1)
    assert out["port"] == out["jax"]
    assert out["port"][0][1] == str(int(port_lc.DEFAULT_SPAWN_ETA_S - 3.0))
    assert out["port"][0][2]["scale_out_pending"] is True
