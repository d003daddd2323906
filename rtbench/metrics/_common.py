"""Helpers the readers share."""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from rtbench.costs import model as model_costs, peaks


def traced_jobs(reading, kind: Optional[str] = None) -> Iterator[Tuple[object, object]]:
    """(job record, its device record) of every job the traced window saw."""
    if reading.trace is None:
        return
    for rec in reading.jobs:
        jd = reading.trace.jobs.get(rec.n)
        if jd is not None and (kind is None or rec.kind == kind):
            yield rec, jd


def frame_stages(reading) -> List[Dict[str, float]]:
    """Per completed frame ingested in the window, the seconds
    from ingest to its window's close (``window``) and from there to its
    dispatch (``queue``), from the port's frame spans."""
    tracer = reading.tracer
    if tracer is None:
        return []
    w0, w1 = reading.window
    stamps: Dict[Tuple[int, int], Dict[str, float]] = {}
    done = set()
    for ev in tracer.ring:
        if ev.rid < 0 or ev.idx < 0:
            continue
        key = (ev.rid, ev.idx)
        if ev.stage in ("ingest", "window_close", "edf_dispatch"):
            stamps.setdefault(key, {}).setdefault(ev.stage, ev.t)
        elif ev.stage in ("completed", "late"):
            done.add(key)
    out = []
    for key in done:
        st = stamps.get(key, {})
        if {"ingest", "window_close", "edf_dispatch"} <= st.keys() and w0 <= st["ingest"] < w1:
            out.append({"window": st["window_close"] - st["ingest"],
                        "queue": st["edf_dispatch"] - st["window_close"]})
    return out


def roofline_share(reading, kernel: str) -> Optional[float]:
    """Sum of the launches' bound times over the sum of their measured
    device times, in %, over the traced window's jobs; None where the
    cell's model does not run ``kernel`` (its configuration's
    ``serving.kernels``) or the trace shows no launch of it."""
    from rtbench import spec

    cost = spec.kernel_costs(reading.cell.bench_dir).get(kernel)
    if cost is None or kernel not in reading.model.get("kernels", ()):
        return None
    bound = measured = 0.0
    for rec, jd in traced_jobs(reading):
        shapes = cost.launch_shapes(rec, reading.model)
        t = jd.by_kernel.get(kernel, 0)
        if not shapes or t <= 0:
            continue
        bound += sum(peaks.bound_seconds(*cost.launch_cost(s)) for s in shapes)
        measured += t / 1e9
    if measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured


def step_flops(reading, rec) -> float:
    m, family = reading.model, reading.family
    if rec.kind == "decode":
        return model_costs.decode_step_flops(family, m, rec.ctx)
    return model_costs.prefill_flops(family, m, len(rec.frames), rec.length)
