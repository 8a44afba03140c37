"""The traffic generator: determinism by seed, wall-clock arrivals, the same
lengths for every seed, the closed loop's callers, the prompt buckets."""

import json
from collections import Counter

import numpy as np

from perfbench.tests.tiny import ROOT
from perfbench.traffic import Callers, buckets, open_loop, pow2_bucket

BIG = 2**31 + 12345


def _mix(name):
    return json.loads((ROOT / "perfbench" / "traffic"
                       / f"{name}.json").read_text())


def test_open_loop_is_fixed_by_its_seed():
    mix = dict(_mix("longprompt_open"))
    mix.pop("schedule_seed")
    a = open_loop(mix, BIG, 30.0, 10.0)
    b = open_loop(mix, BIG, 30.0, 10.0)
    assert a == b
    assert np.array_equal(a[3].tokens(BIG, 32064), b[3].tokens(BIG, 32064))
    c = open_loop(mix, BIG + 1, 30.0, 10.0)
    assert [s.due for s in a] != [s.due for s in c]


def test_a_fixed_schedule_leaves_the_seed_the_token_ids():
    mix = _mix("longprompt_open")
    a = open_loop(mix, BIG, 30.0, 10.0)
    b = open_loop(mix, BIG + 1, 30.0, 10.0)
    assert a == b            # the same due times and lengths, in order
    assert not np.array_equal(a[0].tokens(BIG, 32064),
                              b[0].tokens(BIG + 1, 32064))


def test_open_loop_arrivals_on_the_wall_clock():
    mix = _mix("longprompt_open")
    seconds = 30.0
    sends = open_loop(mix, 5, seconds, 20.0)
    window = [s for s in sends if s.in_window]
    assert len(window) == round(mix["rate_rps"] * seconds)
    dues = [s.due for s in sends]
    assert dues == sorted(dues)
    assert all(0.0 <= s.due < seconds for s in window)
    after = [s for s in sends if not s.in_window]
    assert after and all(seconds <= s.due < seconds + 20.0 for s in after)
    # the rate after the window is the window's, within Poisson noise
    assert abs(len(after) / 20.0 - mix["rate_rps"]) < 0.5 * mix["rate_rps"]


def test_every_seed_sends_the_same_lengths():
    mix = _mix("longprompt_open")
    mix = dict(mix)
    mix.pop("schedule_seed")
    runs = [[s for s in open_loop(mix, seed, 20.0, 0.0) if s.in_window]
            for seed in (1, 2, BIG)]
    for key in ("prompt_len", "max_new"):
        sets = [Counter(getattr(s, key) for s in r) for r in runs]
        assert sets[0] == sets[1] == sets[2]
    lens = [s.prompt_len for s in runs[0]]
    assert min(lens) >= 512 and max(lens) <= 3584
    assert 1300 < float(np.median(lens)) < 1800
    toks = runs[0][0].tokens(1, 32064)
    assert toks.min() >= 1 and toks.max() < 32064


def test_closed_loop_callers_are_fixed_by_the_seed():
    mix = _mix("chat_closed96")
    a, b = Callers(mix, BIG), Callers(mix, BIG)
    assert a.n == 96
    for c, j in ((0, 0), (95, 3), (7, 100)):     # past ``depth`` too
        assert a.request(c, j) == b.request(c, j)
        r = a.request(c, j)
        assert 128 <= r.prompt_len <= 768 and 64 <= r.max_new <= 512


def test_prompt_buckets_are_the_engines_pow2_pads():
    assert buckets(_mix("longprompt_open")) == [512, 1024, 2048, 4096]
    assert buckets(_mix("chat_closed96")) == [128, 256, 512, 1024]
    assert [pow2_bucket(n, 4224) for n in (1, 512, 513, 3584)] == \
        [1, 512, 1024, 4096]
    assert pow2_bucket(5000, 4224) == 4224
