"""The fleet router's pure parts against the JAX package's: the
conversation head, the affinity chain key and the weighted rendezvous
order (fleet/routing.py) give the same bytes and the same order for
every input (hypothesis), and Series / SeriesBank (obs/series.py) give
the same increase, rate, values and latest on the same samples, counter
resets included."""
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from cake_tpu.fleet import routing as ref_routing
from cake_tpu.obs import series as ref_series
from cake_tpu_torch.fleet import routing
from cake_tpu_torch.obs import Series, SeriesBank

_text = hst.text(max_size=300)
_content = hst.one_of(_text, hst.integers(), hst.none(),
                      hst.lists(hst.integers(), max_size=3))
_message = hst.fixed_dictionaries(
    {"role": hst.sampled_from(["system", "user", "assistant", "tool", ""]),
     "content": _content})
_names = hst.lists(hst.text(min_size=1, max_size=12), min_size=1,
                   max_size=6, unique=True)


@settings(max_examples=200, deadline=None)
@given(msgs=hst.lists(_message, min_size=1, max_size=6))
def test_conversation_head_same_bytes(msgs):
    assert routing.conversation_head(msgs) \
        == ref_routing.conversation_head(msgs)


@settings(max_examples=200, deadline=None)
@given(data=hst.binary(max_size=4096), blocks=hst.integers(-2, 20))
def test_affinity_key_same_digest(data, blocks):
    assert routing.affinity_key(data, blocks) \
        == ref_routing.affinity_key(data, blocks)


@settings(max_examples=200, deadline=None)
@given(key=hst.binary(min_size=1, max_size=32), names=_names,
       weights=hst.one_of(hst.none(), hst.dictionaries(
           hst.text(min_size=1, max_size=12),
           hst.floats(-2.0, 16.0, allow_nan=False), max_size=6)))
def test_rank_replicas_same_order(key, names, weights):
    if weights:
        # weight some of the real names too, not only random ones
        weights = dict(weights, **{n: w for n, w in
                                   zip(names, weights.values())})
    assert routing.rank_replicas(key, names, weights) \
        == ref_routing.rank_replicas(key, names, weights)
    assert routing.rank_replicas(key, names) \
        == ref_routing.rank_replicas(key, names)


def test_affinity_block_and_real_conversations():
    assert routing.AFFINITY_BLOCK == ref_routing.AFFINITY_BLOCK == 256
    names = [f"r{i}" for i in range(4)]
    for i in range(100):
        msgs = [{"role": "system", "content": "shared " * 300},
                {"role": "user", "content": f"conversation {i}"},
                {"role": "assistant", "content": "reply"}]
        key = routing.affinity_key(routing.conversation_head(msgs), 64)
        assert key == ref_routing.affinity_key(
            ref_routing.conversation_head(msgs), 64)
        assert routing.rank_replicas(key, names, {"r1": 3.0}) \
            == ref_routing.rank_replicas(key, names, {"r1": 3.0})


def _both(window, cap=4096):
    return (Series("s", window, cap, clock=lambda: 0.0),
            ref_series.Series("s", window, cap, clock=lambda: 0.0))


@settings(max_examples=150, deadline=None)
@given(steps=hst.lists(hst.tuples(hst.floats(0.0, 5.0),
                                  hst.floats(-50.0, 500.0)),
                       min_size=0, max_size=40),
       window=hst.floats(0.5, 60.0), cap=hst.integers(2, 64),
       sub=hst.one_of(hst.none(), hst.floats(0.1, 90.0)))
def test_series_same_reads(steps, window, cap, sub):
    """Counters with resets (negative deltas), gauges, pruning by age and
    by the sample cap: every read equal on the same samples."""
    ours, ref = _both(window, cap)
    t = 100.0
    for dt, v in steps:
        t += dt
        ours.record(v, t)
        ref.record(v, t)
        assert ours.samples() == ref.samples()
        assert ours.increase(sub) == ref.increase(sub)
        assert ours.rate(sub) == ref.rate(sub)
        assert ours.values(sub) == ref.values(sub)
        assert ours.latest() == ref.latest()
        assert ours.latest_t() == ref.latest_t()
        assert len(ours) == len(ref)


def test_series_counter_reset_pinned():
    ours, ref = _both(60.0)
    for t, v in [(0, 10), (10, 20), (20, 5), (30, 15)]:   # reset at 20
        ours.record(v, t)
        ref.record(v, t)
    assert ours.increase() == ref.increase() == pytest.approx(20.0)
    assert ours.rate() == ref.rate() == pytest.approx(20.0 / 30.0)


def test_series_bank_same_namespacing_and_drop():
    clock = [0.0]
    ours = SeriesBank(10.0, 8, clock=lambda: clock[0])
    ref = ref_series.SeriesBank(10.0, 8, clock=lambda: clock[0])
    for bank in (ours, ref):
        for i in range(5):
            clock[0] = float(i)
            bank.record("req/r0", i * 2.0)
            bank.record("req/r1", 3.0)
            bank.record("tok/r0", i * 1.0)
        bank.drop("req/")
    assert ours.names() == ref.names() == ["tok/r0"]
    assert ours.get("tok/r0").samples() == ref.get("tok/r0").samples()
    assert ours.get("req/r0") is None and ref.get("req/r0") is None
