"""The metric arithmetic on synthetic records and spans."""

import math

import pytest

from helpers import REPO  # noqa: F401
from perfbench import cell, reduce, trace


def rec(i, sent, done, audio=1.0, ok=True, due=None):
    return {"id": i, "sent": sent, "done": done, "ok": ok, "due": due,
            "audio_s": audio if ok else 0.0}


def test_rtf_window_closes_with_the_last_request_sent():
    # a closed loop: the last request was sent before --seconds had passed
    # and finished after it; the window runs to its reply
    recs = [rec(0, 10.0, 14.0, 30.0), rec(1, 14.0, 18.0, 30.0), rec(2, 18.0, 22.5, 30.0)]
    start, end = cell.window_bounds(recs, t_go=9.9)
    assert (start, end) == (10.0, 22.5)
    assert cell.rtf(recs, start, end) == pytest.approx(12.5 / 90.0)


def test_rtf_counts_a_slow_requests_whole_wall():
    # a slower request lengthens the window instead of dropping out of it
    fast = [rec(0, 0.0, 4.0, 30.0), rec(1, 4.0, 8.0, 30.0)]
    slow = [rec(0, 0.0, 4.0, 30.0), rec(1, 4.0, 9.0, 30.0)]
    assert cell.rtf(slow, *cell.window_bounds(slow, 0)) > cell.rtf(fast, *cell.window_bounds(fast, 0))


def test_percentiles_count_failures_as_misses():
    sched = [{"id": i} for i in range(10)]
    recs = [rec(i, i + 0.0, i + 1.0 + 0.1 * i, due=float(i)) for i in range(8)]
    recs.append(rec(8, 8.0, None, ok=False, due=8.0))           # failed
    lat = cell.latencies(sched, recs)                            # id 9 never came
    assert sorted(lat)[-2:] == [math.inf, math.inf]
    assert cell.percentile(lat, 0.90) == math.inf
    assert cell.percentile(lat, 0.50) == pytest.approx(1.4)
    assert cell.percentile(lat[:8], 0.90) == pytest.approx(1.7)


def test_idle_share_is_one_less_the_union_of_overlapping_spans():
    ms = 1_000_000
    events = [(0, 4 * ms, "dq_gemv_kernel<1>"), (3 * ms, 6 * ms, "attend_split_kernel"),
              (5 * ms, 6 * ms, "other"), (8 * ms, 9 * ms, "other")]
    spans = [("engine call of 1", 0, 10 * ms), ("s2mel", 6 * ms, 8 * ms)]
    out = trace.reduce_events(events, 0, 10 * ms, spans)
    assert out["busy_s"] == pytest.approx(0.007)
    assert out["groups"]["decode_chain"] == pytest.approx(0.006)
    assert out["kernel_s"]["other"] == pytest.approx(0.002)
    ctx = {"device": out}
    assert reduce.idle_pct(ctx) == pytest.approx(30.0)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps == {"s2mel": pytest.approx(0.002), "engine call of 1": pytest.approx(0.001)}


def test_clipped_to_the_window():
    ms = 1_000_000
    out = trace.reduce_events([(-5 * ms, 2 * ms, "k"), (9 * ms, 20 * ms, "k")], 0, 10 * ms, [])
    assert out["busy_s"] == pytest.approx(0.003)
    assert dict(out["breakdown"]["idle_gaps"]) == {trace.OUTSIDE: pytest.approx(0.007)}


def test_group_size_mean():
    assert reduce.group_mean({"batch_sizes": [1, 2, 4, 1]}) == pytest.approx(2.0)
    assert reduce.group_mean({"batch_sizes": []}) is None

