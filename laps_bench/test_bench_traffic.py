"""The traffic generator: one schedule for every seed, token ids drawn
from the seed, and every shape inside its mix's stated ranges."""
import glob
import json
import os

import numpy as np
import pytest

from laps_bench import workload

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_LEN = 12288 - 2
MIXES = sorted(os.path.basename(p)[:-5]
               for p in glob.glob(os.path.join(HERE, "traffic", "*.json")))


def _mix(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def _load(mix):
    return {"clients": 32} if mix["arrival"]["kind"] == "closed" \
        else {"rate": 4.5}


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_one_schedule(name):
    """The plan depends on the mix and the load alone; the seed draws
    only the token ids."""
    mix = _mix(name)
    a = workload.plan(mix, _load(mix), 51, MAX_LEN)
    assert a == workload.plan(mix, _load(mix), 51, MAX_LEN)
    other = dict(mix, plan_seed=mix["plan_seed"] + 1)
    assert a != workload.plan(other, _load(mix), 51, MAX_LEN)


@pytest.mark.parametrize("name", MIXES)
def test_shapes_keep_the_mix_ranges(name):
    mix = _mix(name)
    p = workload.plan(mix, _load(mix), 51, MAX_LEN)
    hi_t = mix["turns"][1]
    longs = shorts = 0
    for s in p.sessions:
        assert s.system == mix.get("system_prompt", 0)
        assert 1 <= len(s.turns) <= hi_t
        total = s.system + sum(t.new_tokens + t.out_tokens for t in s.turns)
        assert total <= MAX_LEN
        for i, t in enumerate(s.turns):
            assert mix["decode"][0] <= t.out_tokens <= mix["decode"][1]
            short = mix.get("first_short", mix["short"]) if i == 0 \
                else mix["short"]
            if short[0] <= t.new_tokens <= short[1]:
                shorts += 1
            else:
                assert mix["long"][0] <= t.new_tokens <= mix["long"][1]
                longs += 1
            if mix.get("think_s"):
                assert t.think_s >= 0
            else:
                assert t.think_s == 0
    share = longs / (longs + shorts)
    assert abs(share - mix.get("long_share", 0.0)) < 0.08


@pytest.mark.parametrize("rate,seconds", [(0.45, 51), (4.5, 51), (3.0, 2)])
def test_open_loop_arrivals_fill_the_window(rate, seconds):
    mix = _mix("multiturn")
    p = workload.plan(mix, {"rate": rate}, seconds, MAX_LEN)
    assert len(p.arrivals) == round(rate * seconds)
    assert p.arrivals[0] == 0.0
    assert all(0 <= a < seconds for a in p.arrivals)
    assert all(b >= a for a, b in zip(p.arrivals, p.arrivals[1:]))


def test_bursty_gaps_are_burstier():
    rng = np.random.default_rng(0)
    g = workload._gaps(rng, {"kind": "gamma", "cv": 3.0}, 20000)
    e = workload._gaps(rng, {"kind": "poisson"}, 20000)
    assert abs(g.mean() - 1) < 0.1 and abs(e.mean() - 1) < 0.05
    assert abs(g.std() / g.mean() - 3.0) < 0.4
    assert abs(e.std() / e.mean() - 1.0) < 0.05


def test_closed_loop_clients_own_their_sessions():
    mix = _mix("mixed_closed")
    p = workload.plan(mix, {"clients": 32}, 51, MAX_LEN)
    assert len(p.clients) == 32
    flat = [i for c in p.clients for i in c]
    assert sorted(flat) == list(range(len(p.sessions)))
    assert len(p.clients[0]) == 26     # 0.5 sessions a second of window


def test_tokens_are_keyed_not_ordered():
    t = workload.Tokens(2**31 + 99, 151936, 512)
    a = t.turn(3, 1, 40)
    t.turn(0, 0, 10)
    assert np.array_equal(a, t.turn(3, 1, 40))
    assert not np.array_equal(a, t.turn(3, 2, 40))
    assert len(t.system) == 512
    assert a.min() >= 1 and a.max() < 151936
    other = workload.Tokens(2**31 + 100, 151936, 512)
    assert not np.array_equal(a, other.turn(3, 1, 40))
