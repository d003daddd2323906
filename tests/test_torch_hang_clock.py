"""The port's device clock on a shared stream, on the CPU.

Slices of one card share one CUDA stream, so a job can wait behind
other slices' work before the device reaches it. ``AsyncDevice`` with a
``mark_fn`` (on the card: a CUDA event recorded ahead of the job's
launches) starts the job's watchdog and measured clocks when that mark
completes, however late the loop runs that start, so the wait is not
counted as time the device spent on the job; without a mark the clock
starts at submit, as before. Here the marks and handles are fakes on the wall clock, and the watchdog's
signals go to the real ``SliceHealthMonitor`` (hung past
``hang_after``: quarantined) over a one-slice stand-in for the cluster.
"""
import threading
import time
from types import SimpleNamespace

import pytest

from repro_torch import core as P
from repro_torch.serving.async_device import AsyncDevice

EXPECTED = 0.02  # the job's profiled WCET (s)
# deadline max(0.02 x 2, 0.1) = 0.1 s; hung after 0.1 x 6 / 2 = 0.3 s
CFG = P.WatchdogConfig(slack=2.0, hang_slack=6.0, min_deadline=0.1)
REACH = 0.5  # the stream reaches the late job 0.5 s after its submit
RUN = 0.05  # then it runs this long


class _At:
    """A mark or handle that blocks until an instant on perf_counter, or
    until ``release`` is set (``at`` None: never on its own)."""

    def __init__(self, at=None, release=None):
        self.at, self.release = at, release or threading.Event()

    def _block(self):
        if self.at is None:
            self.release.wait()
        else:
            time.sleep(max(0.0, self.at - time.perf_counter()))

    synchronize = wait = _block


class _Cluster:
    """The monitor's view of one live slice: health, liveness, fail_slice,
    and the WCET rescale a suspect slice's re-profile asks for."""

    def __init__(self, loop):
        self.loop = loop
        self.slices = {"s": SimpleNamespace(health=P.HEALTHY, alive=True, scheduler=None)}
        self.device = None

    def fail_slice(self, name):
        self.slices[name].alive = False
        self.device.close()

    def _rescale(self, name, drift):
        self.drift = drift


def _run(mark_at, done_at, use_mark=True, throttle=None, hold_loop=None, enqueue=0.0):
    """One job through AsyncDevice under the armed watchdog; ``mark_at``
    and ``done_at`` are seconds after submit (None: never); ``hold_loop``
    (at, seconds) blocks the loop's thread in a callback, as closing a
    wedged slice's device does; ``enqueue``: seconds the dispatch holds
    the loop's thread, as a host-bound eager step does. Returns
    (monitor, completions, measured (expected, actual) pairs, the submit
    instant on the loop's clock)."""
    loop = P.WallClock()
    cluster = _Cluster(loop)
    monitor = P.SliceHealthMonitor(cluster, CFG)
    wedge = threading.Event()
    t0 = time.perf_counter()
    at = lambda s: None if s is None else t0 + s
    def dispatch(job):
        time.sleep(enqueue)
        return _At(at(done_at), wedge)

    dev = AsyncDevice(loop, dispatch_fn=dispatch,
                      mark_fn=(lambda: _At(at(mark_at), wedge)) if use_mark else None)
    dev.watchdog = P.CompletionWatchdog(
        loop, CFG, on_overdue=lambda job, e, el: monitor.note_overdue("s", job, e, el))
    measured = []
    dev.on_measured = lambda e, a: (measured.append((e, a)), monitor.note_complete("s", e, a))
    cluster.device = dev
    device = dev
    if throttle is not None:  # a fault wrapper around the real device, as the cluster builds
        device = P.FaultyDevice(dev, P.FaultPlan((P.FaultSpec(P.DELAY, 0, **throttle),)))
    done = []
    submitted = loop.now
    device.submit("job", EXPECTED, lambda job, t: done.append(t))
    if hold_loop is not None:
        loop.schedule(submitted + hold_loop[0], lambda: time.sleep(hold_loop[1]))
    loop.run(until=submitted + 2.0)
    wedge.set()
    dev.close()
    return monitor, done, measured, submitted


def _quarantines(monitor):
    return [(t, r) for t, _n, _o, new, r in monitor.transitions if new == P.QUARANTINED]


def test_a_job_the_stream_reaches_late_is_not_quarantined():
    monitor, done, measured, _ = _run(REACH, REACH + RUN)
    assert _quarantines(monitor) == [] and len(done) == 1
    # The measured clock also starts at the mark: about RUN, not REACH + RUN.
    (expected, actual), = measured
    assert expected == EXPECTED and actual < REACH


def test_without_a_mark_the_clock_starts_at_submit():
    # The same job and wait, with no mark (the CPU's engine): the
    # clock runs from submit and the wait reads as a hang.
    monitor, done, _, submitted = _run(REACH, REACH + RUN, use_mark=False)
    (t, reason), = _quarantines(monitor)
    assert "hung" in reason and t - submitted >= CFG.hang_after(EXPECTED)
    assert done == []  # the slice failed before its completion landed


def test_a_wedged_job_is_still_quarantined_at_hang_after():
    # The stream reaches the job at once and it never completes.
    monitor, done, _, submitted = _run(0.0, None)
    (t, reason), = _quarantines(monitor)
    assert "hung" in reason
    # At the first heartbeat past hang_after (heartbeats every deadline),
    # give or take the host's scheduling.
    late = CFG.hang_after(EXPECTED) + CFG.deadline_for(EXPECTED) + 0.2
    assert CFG.hang_after(EXPECTED) <= t - submitted < late
    assert done == []


@pytest.mark.parametrize("reach", [0.0, REACH])
def test_a_throttled_job_behind_a_late_stream_lives(reach):
    # FaultyDevice's DELAY holds the completion to max(4 x WCET, WCET +
    # 0.16) = 0.18 s after the stream reaches the job, under the 0.3 s
    # hang, wherever the stream reaches it.
    monitor, done, _, _ = _run(reach, reach + RUN, throttle=dict(factor=4.0, extra=0.16))
    assert _quarantines(monitor) == [] and len(done) == 1


@pytest.mark.parametrize("reach", [0.0, REACH])
def test_a_throttled_job_behind_a_late_stream_is_late(reach):
    # The throttle is counted from where the watchdog's clock starts,
    # so a job that waited behind other slices' work is still late:
    # overdue at the 0.1 s deadline, then completed late at 0.18 s,
    # two consecutive late signals, and the slice turns suspect.
    monitor, done, measured, _ = _run(reach, reach + RUN, throttle=dict(factor=4.0, extra=0.16))
    assert len(done) == 1
    (_expected, actual), = measured
    assert actual >= 0.18
    assert [(old, new) for _t, _n, old, new, _r in monitor.transitions] == [
        (P.HEALTHY, P.SUSPECT)]
    assert "late completion" in monitor.transitions[0][4]


def test_a_throttled_job_reached_while_the_loop_is_held_is_late():
    # The loop's thread is held from 0.01 s to 0.13 s after submit (as
    # while it enqueues another slice's eager job), across the instant
    # the stream reaches the job (0.02 s), so the loop runs the job's
    # begin post at 0.13 s. The watchdog's clock still starts at 0.02 s:
    # the job is overdue as soon as the loop is free, then completes late
    # at 0.20 s, and the slice turns suspect. Timed from the post, the
    # deadline (0.23 s) would fall after the completion: one late
    # signal, no transition.
    monitor, done, measured, _ = _run(0.02, 0.02 + RUN, throttle=dict(factor=4.0, extra=0.16),
                                      hold_loop=(0.01, 0.12))
    assert len(done) == 1
    (_expected, actual), = measured
    assert actual >= 0.18
    assert [(old, new) for _t, _n, old, new, _r in monitor.transitions] == [
        (P.HEALTHY, P.SUSPECT)]


def test_a_held_loop_does_not_turn_a_throttled_job_into_a_hang():
    # The loop's thread is held from 0.05 s to 0.55 s after submit. The
    # throttled job completes at 0.18 s, inside the hold, so its first
    # heartbeat (due at 0.1 s) runs at 0.55 s behind the completion
    # posted at 0.18 s: the completion runs first, the check is void.
    # The held loop reads the completion late (one late signal), not
    # hung past 0.3 s.
    monitor, done, measured, _ = _run(0.0, RUN, throttle=dict(factor=4.0, extra=0.16),
                                      hold_loop=(0.05, 0.5))
    assert _quarantines(monitor) == [] and len(done) == 1
    (_expected, actual), = measured
    assert actual >= 0.5
    assert monitor.transitions == []


def test_the_measured_clock_starts_where_the_stream_reached_the_job():
    # The loop's thread is held (as while it enqueues a long eager job)
    # from before the mark completes until after the job is done: the
    # begin post runs late, right before the completion, yet the measured
    # time still runs from the mark's instant, not from the post.
    # The mark completes at 0.1 s, the loop runs its post at 0.35 s:
    # timed from the post, the job would read about 0.
    _, done, measured, _ = _run(0.1, 0.1 + RUN, hold_loop=(0.05, 0.3))
    assert len(done) == 1
    (_expected, actual), = measured
    assert actual >= 0.15


def test_the_measured_clock_counts_the_jobs_own_enqueue():
    # The stream reaches the job at once, and the dispatch holds the
    # loop's thread 0.2 s enqueueing it (an eager step): the job's time
    # runs from the mark, through its enqueue, to its completion.
    # Timed from the end of the enqueue it would read about 0.05 s; the
    # margin covers the waiter's wake-up on a loaded host.
    _, done, measured, _ = _run(0.0, 0.25, enqueue=0.2)
    assert len(done) == 1
    (_expected, actual), = measured
    assert actual >= 0.15


def test_a_dispatch_that_raises_leaves_no_job_to_the_waiter():
    # The waiter holds the job's mark before the dispatch runs; a
    # dispatch that raises must leave it nothing to wait on, so the
    # device still closes cleanly (no wedged waiter) and holds no loop.
    loop = P.WallClock()

    def dispatch(job):
        raise ValueError("enqueue failed")

    dev = AsyncDevice(loop, dispatch_fn=dispatch, mark_fn=lambda: _At(time.perf_counter()))
    with pytest.raises(ValueError, match="enqueue failed"):
        dev.submit("job", EXPECTED, lambda job, t: None)
    dev.close()
    assert not dev.wedged and not dev._waiter.is_alive()
    loop.run(until=loop.now + 0.1)  # returns: no hold was taken
