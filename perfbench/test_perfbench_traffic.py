"""The traffic generator: it repeats for a seed, and every seed gets the
mix's sizes, shares and gaps in another order."""
import collections
import statistics

import numpy as np
import pytest

from perfbench import common, generator

DECODE = common.load_json("traffic", "decode_chat")
MIXED = common.load_json("traffic", "serve_mixed")
BURSTY = common.load_json("traffic", "serve_bursty")
SEEDS = (0, 2 ** 31 + 17)


@pytest.mark.parametrize("mix, rate", [(DECODE, 0.0), (MIXED, 30.0), (BURSTY, 120.0)])
def test_plan_repeats_for_a_seed_and_keeps_its_sizes_across_seeds(mix, rate):
    a = generator.plan(mix, SEEDS[0], 4, 30.0, rate)
    assert a == generator.plan(mix, SEEDS[0], 4, 30.0, rate)
    b = generator.plan(mix, SEEDS[1], 4, 30.0, rate)
    assert a != b
    for field in ("prompt_len", "output_len"):
        assert sorted(getattr(r, field) for r in a) == sorted(getattr(r, field) for r in b)
    toks = generator.tokens(SEEDS[0], a, 1000)
    assert all(len(t) == r.prompt_len and t.dtype == np.int32 for t, r in zip(toks, a))
    assert all((x == y).all() for x, y in zip(toks, generator.tokens(SEEDS[0], a, 1000)))


def test_backlog_lengths_follow_the_lognormal_in_every_block():
    p = generator.plan(DECODE, 5, 4, 30.0)
    assert len(p) == DECODE["arrivals"]["requests"] and all(r.due_s == 0.0 for r in p)
    block = DECODE["arrivals"]["block"]
    first = sorted(r.prompt_len for r in p[:block])
    for k in range(0, len(p), block):
        chunk = p[k:k + block]
        assert sorted(r.prompt_len for r in chunk) == first
        assert collections.Counter(r.member for r in chunk) == {m: block // 4 for m in range(4)}
    prompts = [r.prompt_len for r in p]
    outs = [r.output_len for r in p]
    assert 32 <= min(prompts) and max(prompts) <= 1024
    assert 16 <= min(outs) and max(outs) <= 256
    assert abs(statistics.median(prompts) - 256) <= 8
    assert abs(statistics.median(outs) - 64) <= 3
    # sigma 0.7: the quartiles sit at exp(+-0.6745 * 0.7) of the median
    q1, _, q3 = statistics.quantiles(prompts, n=4)
    assert q3 / q1 == pytest.approx(np.exp(2 * 0.6745 * 0.7), rel=0.06)


def test_poisson_rate_and_uniform_members():
    seconds, rate = 30.0, 30.0
    p = generator.plan(MIXED, 3, 3, seconds, rate)
    assert abs(len(p) - rate * seconds) <= 2
    due = [r.due_s for r in p]
    assert due == sorted(due) and due[-1] < seconds
    gaps = np.diff(due)
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.05)
    assert np.std(gaps) / gaps.mean() == pytest.approx(1.0, abs=0.1)  # exponential
    counts = collections.Counter(r.member for r in p)
    assert max(counts.values()) - min(counts.values()) <= 1
    assert all(r.prompt_len == 256 for r in p)


def test_bursts_share_a_due_time_and_a_member_with_zipf_shares():
    k = BURSTY["arrivals"]["burst"]
    seconds, rate = 30.0, 15.0 * k
    p = generator.plan(BURSTY, 4, 4, seconds, rate)
    assert len(p) % k == 0 and abs(len(p) / k - rate / k * seconds) <= 1
    bursts = [p[j:j + k] for j in range(0, len(p), k)]
    assert all(len({(r.due_s, r.member) for r in b}) == 1 for b in bursts)
    counts = collections.Counter(b[0].member for b in bursts)
    shares = [counts[m] / len(bursts) for m in range(4)]
    assert shares == pytest.approx([0.48, 0.24, 0.16, 0.12], abs=0.01)
    assert all(r.prompt_len == 512 for r in p)


def test_gaps_bunch_as_a_poisson_stream_and_keep_their_set_across_seeds():
    rate, seconds = 32.0, 60.0
    runs = [generator.plan(MIXED, seed, 3, seconds, rate) for seed in (9, 2 ** 31 + 9)]
    gaps = [np.diff([0.0] + [r.due_s for r in p]) for p in runs]
    # the same gaps in another order; their sum is the window, less the last
    assert np.allclose(np.sort(gaps[0]), np.sort(gaps[1]))
    for g in gaps:
        # arrivals per second: a Poisson count's variance equals its mean
        # (a stream dealt evenly over blocks read well under half of it)
        counts = np.bincount(np.cumsum(g).astype(int), minlength=int(seconds))
        assert counts.var() / counts.mean() == pytest.approx(1.0, abs=0.4)
        # stretches of 16 gaps spread as sums of 16 exponentials do (cv 1/4)
        sums = g[: len(g) // 16 * 16].reshape(-1, 16).sum(1)
        assert np.std(sums) / np.mean(sums) == pytest.approx(0.25, abs=0.08)
