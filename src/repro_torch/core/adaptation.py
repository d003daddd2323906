"""Adaptation Module (paper §4.4): penalty-driven overrun recovery.

Each category carries a penalty, initialized to 0. When the Worker
observes a job instance exceeding its profiled WCET, the excess is added
to the category's penalty and the DisBatcher is told to emit that
category's future job instances at a *reduced shape* (the paper shrinks
image resolution; our TPU adaptation shrinks the padded shape bucket —
e.g. a prefill bucket of 8192 tokens drops to 4096, which was profiled and
pre-compiled up front, so adaptation never triggers a recompile).

While reduced, every completed job repays the penalty by the time saved
relative to the *original-shape* profile; when the penalty reaches 0 the
original shape is restored.

Where no smaller profiled shape exists (e.g. rwkv6 decode: recurrent state
is shape-free), the penalty is still tracked — it then drains through
natural underruns (actual < profiled) — but no shape change happens. This
is the documented fallback for shape-free categories (DESIGN.md §4).

Arrival-side coupling (ingest gateway): the same penalty signal also
drives LOAD SHEDDING at the other end of the pipeline. The paper shrinks
resolution once a category overruns; the streaming gateway applies the
analogous degradation to a category's *arrival rate* — while a category
carries penalty, ``shed_scale`` tells the gateway to tighten that
category's queue-delay budget (sheds engage earlier), and every shed
frame is reported back via ``note_shed`` so the module sees both halves
of the degradation it is driving (``sheds`` telemetry mirrors
``shape_changes``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.disbatcher import DisBatcher
from repro_torch.core.profiler import ProfileTable
from repro_torch.core.request import Category, JobInstance

ShapeKey = Tuple[int, ...]
_EPS = 1e-9


def default_shrink(shape: ShapeKey) -> Optional[ShapeKey]:
    """Halve the spatial/sequence dims; None when nothing can shrink.

    (C, H, W) image -> (C, H//2, W//2); (S,) LM bucket -> (S//2,).
    """
    if len(shape) == 3:
        c, h, w = shape
        if h >= 2 and w >= 2:
            return (c, h // 2, w // 2)
        return None
    if len(shape) >= 1 and shape[-1] >= 2:
        return shape[:-1] + (shape[-1] // 2,)
    return None


class AdaptationModule:
    def __init__(
        self,
        table: ProfileTable,
        disbatcher: DisBatcher,
        shrink_fn: Callable[[ShapeKey], Optional[ShapeKey]] = default_shrink,
        enabled: bool = True,
    ):
        self.table = table
        self.disbatcher = disbatcher
        self.shrink_fn = shrink_fn
        self.enabled = enabled
        self.penalties: Dict[Category, float] = {}
        self.shape_changes = 0  # telemetry
        self.restores = 0
        self.sheds: Dict[Category, int] = {}  # gateway-reported drops
        # Device-health coupling (SliceHealthMonitor): True while this
        # scheduler's device is drifting (slice suspect/quarantined).
        self.device_degraded = False

    def penalty(self, category: Category) -> float:
        return self.penalties.get(category, 0.0)

    # ----- arrival-side degradation (ingest gateway) --------------------
    PENALIZED_BUDGET_TIGHTEN = 2.0
    # Same lever, different trigger: the slice health monitor reports
    # sustained WCET drift (suspect state) via ``note_device_health``.
    DEGRADED_BUDGET_TIGHTEN = 2.0

    def shed_scale(self, category: Category) -> float:
        """Queue-budget tightening factor for the gateway's load shedder.

        1.0 while the category is healthy; ``PENALIZED_BUDGET_TIGHTEN``
        while it carries overrun penalty — a penalized category's device
        time is already proving scarcer than profiled, so its arrival
        queue must be held to a stricter bound (shed earlier) until the
        penalty drains. Multiplied by ``DEGRADED_BUDGET_TIGHTEN`` while
        the health monitor holds the device degraded (slice suspect):
        every category on a drifting device sheds earlier, penalty or
        not. Disabled adaptation never tightens.
        """
        if not self.enabled:
            return 1.0
        scale = 1.0
        if self.penalties.get(category, 0.0) > _EPS:
            scale = self.PENALIZED_BUDGET_TIGHTEN
        if self.device_degraded:
            scale *= self.DEGRADED_BUDGET_TIGHTEN
        return scale

    def note_device_health(self, healthy: bool) -> None:
        """SliceHealthMonitor report: this scheduler's device entered
        (``healthy=False``) or left (``healthy=True``) a drifting state.
        While degraded, ``shed_scale`` tightens for every category."""
        self.device_degraded = not healthy

    def note_shed(self, category: Category, n: int = 1) -> None:
        """Gateway report: ``n`` frames of ``category`` were shed."""
        self.sheds[category] = self.sheds.get(category, 0) + n

    def telemetry(self) -> Dict[str, object]:
        """JSON-able adaptation state for the cluster telemetry snapshot:
        live penalty mass per category, shape-change / restore counts,
        gateway-reported sheds, and the device-health coupling."""
        return {
            "enabled": self.enabled,
            "device_degraded": self.device_degraded,
            "shape_changes": self.shape_changes,
            "restores": self.restores,
            "penalties": {str(c): p for c, p in self.penalties.items()},
            "sheds": {str(c): n for c, n in self.sheds.items()},
        }

    def _shrunken(self, category: Category) -> Optional[ShapeKey]:
        """The next profiled shape below the category's current shape.

        The candidate must be profiled in the SAME regime as the
        category (bucketed prefill curve vs flat decode entry): a
        prefill category whose halved seq happens to equal some decode
        category's shape must NOT shrink into it — the WCET there is a
        different program's cost, and the serving bridge would dispatch
        the job as the wrong step kind. Flat (slot-arena decode)
        categories never shape-shrink at all: their state is resident
        in a per-seq arena whose rows the stream LEASED — a shrunk seq
        would be a different arena where the stream holds no row.
        Their penalty drains through natural underruns instead, the
        same documented fallback as shape-free categories.
        """
        key = (category.model_id, tuple(category.shape_key))
        if key in self.table.flat_entries:
            return None
        pool = self.table.entries
        cur = self.disbatcher.shape_override(category) or category.shape_key
        cand = self.shrink_fn(cur)
        while cand is not None:
            if (category.model_id, tuple(cand)) in pool:
                return cand
            cand = self.shrink_fn(cand)
        return None

    def on_job_complete(self, job: JobInstance, actual: float) -> None:
        if not self.enabled:
            return
        cat = job.category
        if job.shape_key == cat.shape_key:
            # Running at original shape: only overruns matter here.
            profiled = self.table.wcet(cat.model_id, job.shape_key, job.batch_size)
            excess = actual - profiled
            if excess > _EPS:
                self.penalties[cat] = self.penalties.get(cat, 0.0) + excess
                reduced = self._shrunken(cat)
                if reduced is not None:
                    self.disbatcher.set_shape_override(cat, reduced)
                    self.shape_changes += 1
            return
        # Running reduced: repay penalty by time saved vs the original
        # shape's profile (paper: "subtract the saved execution time").
        profiled_orig = self.table.wcet(cat.model_id, cat.shape_key, job.batch_size)
        saved = profiled_orig - actual
        p = self.penalties.get(cat, 0.0) - saved
        if p <= _EPS:
            self.penalties[cat] = 0.0
            self.disbatcher.set_shape_override(cat, None)
            self.restores += 1
        else:
            self.penalties[cat] = p
