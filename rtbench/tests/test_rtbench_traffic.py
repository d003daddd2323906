"""The frozen traffic generators against the port's originals: the same
plans (offsets and payload bytes) and the same traces for the same seeds."""
import numpy as np
import pytest

from repro_torch.core import traces as port_traces
from repro_torch.ingest import sources as port_sources
from rtbench.traffic import sources, traces

SEED = 2**31 + 17


@pytest.mark.parametrize("name,kw", [
    ("PeriodicSource", {}),
    ("CameraSource", {"jitter_frac": 0.2}),
    ("BurstSource", {"burst": 4, "duty": 0.5, "intra_frac": 0.125}),
])
@pytest.mark.parametrize("shape", [(), (16,)])
def test_plans_equal_the_ports(name, kw, shape):
    args = dict(period=0.05, n_frames=40, payload_shape=shape, vocab=49155, seed=SEED)
    ours = getattr(sources, name)(**args, **kw).plan()
    theirs = getattr(port_sources, name)(**args, **kw).plan()
    assert [p.offset for p in ours] == [p.offset for p in theirs]
    assert all(np.array_equal(a.payload, b.payload) for a, b in zip(ours, theirs))


def test_traces_equal_the_ports():
    kw = dict(mean_period=0.15, mean_deadline=0.3, n_requests=12, models=("a", "b"),
              shapes=((8,), (16,)), seed=5)
    ours = traces.generate_trace(traces.TraceSpec(**kw))
    theirs = port_traces.generate_trace(port_traces.TraceSpec(**kw))
    assert [(r["model"], r["shape"], r["period"], r["relative_deadline"], r["n_frames"],
             r["start_time"]) for r in ours] == [
        (r.category.model_id, tuple(r.category.shape_key), r.period, r.relative_deadline,
         r.n_frames, r.start_time) for r in theirs]
