"""The trace reduction on a synthetic device timeline."""
import pytest

from rtbench import devtrace, spec


class Ev:
    def __init__(self, name, start, dur, dev="DeviceType.CUDA"):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


def test_union_and_gaps():
    total, gaps = devtrace.union_ns([(0, 10), (5, 15), (20, 30), (30, 31)])
    assert total == 26 and gaps == [(15, 20)]


def test_jobs_kernels_busy_and_labels():
    costs = spec.kernel_costs()
    ev = [
        Ev("decode_mma_kernel<64>", 100, 50),       # job 0 (dispatched at 90)
        Ev("nvjet_gemm", 160, 40),                  # job 0
        Ev("decode_combine_kernel", 200, 10),       # job 0
        Ev("flash_wgmma_kernel", 400, 100),         # job 1 (dispatched at 380)
        Ev("wkv6_chunk_out_kernel", 520, 30),       # job 1
        Ev("aten::copy_", 0, 5000, "DeviceType.CPU"),  # host events are not device time
        Ev("late_kernel", 2000, 100),               # outside the window
    ]
    t = devtrace.reduce(ev, (0, 1000), costs, marks=[(90, 0), (380, 1)],
                        release_ns={0: 80, 1: 200})
    assert t.busy_s == pytest.approx(230e-9)
    assert t.window_s == pytest.approx(1e-6)
    assert t.jobs[0].by_kernel == {"decode_attention": 60}
    assert t.jobs[0].span_ns == 110 and t.jobs[0].busy_ns == 100  # idle 150-160
    assert t.jobs[1].by_kernel == {"flash_attention": 100, "wkv6": 30}
    labels = dict((round(s * 1e9), k) for k, s in t.idle_gaps)
    # 210-400: job 1 released at 200, before the device went idle, dispatched at 380.
    assert labels[190] == "released job waiting for the host (completion, EDF pick, dispatch)"
    # 500-520: job 1 was already launching.
    assert labels[20] == "host enqueueing the running job"
    assert [k for k, _ in t.device_ops][0] == "flash_wgmma_kernel"


def test_unreleased_gap_label():
    marks = [0, 500]
    assert devtrace.gap_label((100, 600), marks, {1: 550}).startswith("no job released")
