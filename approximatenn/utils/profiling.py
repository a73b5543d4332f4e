"""Tracing, per-stage timing, and metrics (SURVEY.md §5).

The reference's entire observability story is the wall-clock totals of
``time_results.c`` (``/root/reference/timing.h:7-17``).  This module is the
framework-grade replacement: named stage timers that wait for device
completion (``jax.block_until_ready``, so they measure device work, not
dispatch), and a wrapper around ``jax.profiler`` for XPlane traces
viewable in XProf/TensorBoard.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageTimes:
    """Accumulated wall-clock per named stage."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, out=None):
        """Time a stage; the body appends the stage's outputs to the
        yielded list, which is waited on before the clock stops."""
        sink: list = []
        t0 = time.perf_counter()
        try:
            yield sink
        finally:
            if sink:
                import jax

                jax.block_until_ready(sink)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:28s} {t*1e3:10.2f} ms total  {t/c*1e3:9.2f} ms/call  x{c}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "ann_trace"):
    """Capture an XPlane device trace around a region (view with XProf /
    TensorBoard).  No-ops gracefully if the profiler is unavailable."""
    import jax

    started = False
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:
        pass
    try:
        yield logdir
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def annotate(name: str):
    """Named region that shows up in profiler traces
    (``jax.profiler.TraceAnnotation``)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
