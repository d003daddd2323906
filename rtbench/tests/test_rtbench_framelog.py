"""The frame log's numbers on a synthetic window with every kind of frame."""
import math
from types import SimpleNamespace

import pytest

from rtbench.framelog import NO_TAIL_MS, Frame, by_class, nearest_rank, summarize
from rtbench.spec import metric_reader
from rtbench.tests.helpers import HERE


def _log():
    f = []
    # 18 decode frames on time, latencies 1..18 ms (deadline 50 ms).
    for i in range(18):
        f.append(Frame("decode", 1, i, 1, due=float(i), deadline=0.05, admitted=True,
                       completion=i + (i + 1) / 1e3))
    # A late decode frame: done 60 ms after it was due.
    f.append(Frame("decode", 1, 18, 1, due=18.0, deadline=0.05, admitted=True,
                   completion=18.06))
    # A prompt frame of 512 tokens on time (300 ms of 500).
    f.append(Frame("p512", 2, 0, 512, due=0.0, deadline=0.5, admitted=True, completion=0.3))
    # A shed prompt frame, and one never completed: no completion.
    f.append(Frame("p512", 2, 1, 512, due=1.0, deadline=0.5, admitted=True, shed=True))
    f.append(Frame("p512", 2, 2, 512, due=2.0, deadline=0.5, admitted=True))
    # A prompt frame served by a shrunk job: done in time, but not what was asked.
    f.append(Frame("p512", 2, 3, 512, due=3.0, deadline=0.5, admitted=True, completion=3.1,
                   degraded=True))
    # Two frames of a refused stream.
    f += [Frame("p512", 3, i, 512, due=float(i), deadline=0.5, admitted=False)
          for i in range(2)]
    return f


def test_counts_and_goodput():
    s = summarize(_log(), seconds=10.0)
    assert s["attempted"] == 25  # every frame offered, the refused stream's too
    assert s["failed"] == 1  # never completed; shed, late and shrunk are misses
    assert s["admitted_frames"] == 23
    assert s["missed"] == 4  # late, shed, never completed, shrunk
    assert s["goodput_tok_s"] == pytest.approx((18 + 512) / 10.0)


def test_by_class_sorts_every_miss():
    c = by_class(_log())
    assert c["decode"]["admitted"] == 19 and c["decode"]["late"] == 1
    p = c["p512"]
    assert (p["admitted"], p["on_time"], p["shed"], p["never"], p["shrunk"]) == (4, 1, 1, 1, 1)


def test_miss_share_is_the_miss_count_over_admitted_frames():
    reader = metric_reader("miss_share", HERE)
    assert reader.read(SimpleNamespace(frames=_log())) == pytest.approx(100.0 * 4 / 23)
    refused = [Frame("a", 1, 0, 4, 0.0, 0.1, admitted=False)]
    assert reader.read(SimpleNamespace(frames=refused)) is None


def test_tail_is_exact_and_counts_missing_frames_as_infinite():
    frames = _log()
    s = summarize(frames, seconds=10.0)
    # 23 latencies; rank ceil(0.95 * 23) = 22: the two missing frames are
    # the 22nd and 23rd, so the tail has no finite value.
    assert s["p95_latency_ms"] == NO_TAIL_MS
    done = [f for f in frames if f.completion is not None and f.admitted]
    s2 = summarize(done, seconds=10.0)
    lat = sorted(f.latency for f in done)
    assert s2["p95_latency_ms"] == pytest.approx(lat[math.ceil(0.95 * len(lat)) - 1] * 1e3)
    assert s2["p95_latency_ms"] == pytest.approx(100.0)  # 21 frames: rank 20


@pytest.mark.parametrize("q,want", [(0.5, 5), (0.95, 10), (1.0, 10), (0.1, 1)])
def test_nearest_rank(q, want):
    assert nearest_rank([10, 1, 9, 2, 8, 3, 7, 4, 6, 5], q) == want


def test_no_attempted_frames_have_no_tail():
    s = summarize([Frame("a", 1, 0, 4, 0.0, 0.1, admitted=False)], seconds=1.0)
    assert s["admitted_frames"] == 0 and "p95_latency_ms" not in s
