"""Observability: phase timers, throughput counters, profiler traces.

Equivalent of the reference's kernel-launch logging (the only tracing
it has: log_info of thread-block geometry per glaunch,
utilities/src/debug.h:281-282, 359-360, at GRTCODE_INFO verbosity) —
upgraded per SURVEY.md §5: the grid-points/s metric from BASELINE.json is
a first-class counter, phases are wall-clock timed with explicit device
synchronization (block_until_ready), and a context manager wraps
``jax.profiler`` for on-demand XLA traces.

Everything here is host-side and zero-cost when unused; nothing touches
the jitted compute path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

log = logging.getLogger("grtcode_jax")


@dataclasses.dataclass
class PhaseStats:
    seconds: float = 0.0
    calls: int = 0
    points: int = 0

    @property
    def points_per_second(self) -> float:
        return self.points / self.seconds if self.seconds > 0 else 0.0


class Metrics:
    """Accumulates named phase timings and grid-point throughput.

    >>> m = Metrics()
    >>> with m.phase("lw_fluxes", points=ncol * nlayers * nw):
    ...     out = step(batch)          # sync=out to block on the result
    >>> m.report()
    """

    def __init__(self):
        self.phases: dict[str, PhaseStats] = {}

    @contextlib.contextmanager
    def phase(self, name: str, points: int = 0, sync=None):
        """Time a phase; `points` adds column*layer*wavenumber work items
        to the throughput counter; pass the phase's output pytree as
        ``sync`` via ``set_result`` to include device execution time."""
        box = {}
        start = time.perf_counter()
        try:
            yield box
        finally:
            result = box.get("result", sync)
            if result is not None:
                import jax
                jax.block_until_ready(result)
            dt = time.perf_counter() - start
            st = self.phases.setdefault(name, PhaseStats())
            st.seconds += dt
            st.calls += 1
            st.points += int(points)
            log.info("phase %s: %.3fs (%d pts, %.3g pts/s)", name, dt,
                     points, points / dt if dt > 0 else 0.0)

    def points_per_second(self, name: str) -> float:
        return self.phases[name].points_per_second

    def report(self) -> str:
        lines = [f"{'phase':<24}{'calls':>6}{'seconds':>10}{'pts/s':>12}"]
        for name, st in sorted(self.phases.items()):
            lines.append(f"{name:<24}{st.calls:>6}{st.seconds:>10.3f}"
                         f"{st.points_per_second:>12.3g}")
        return "\n".join(lines)


def grid_points(num_columns: int, num_layers: int, num_wavenumbers: int) -> int:
    """The north-star work unit: column x layer x wavenumber points
    (BASELINE.json driver metric)."""
    return int(num_columns) * int(num_layers) * int(num_wavenumbers)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """On-demand XLA profiler trace (viewable in TensorBoard/XProf); a
    None logdir is a no-op so callers can thread a CLI flag through."""
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield
    log.info("wrote profiler trace to %s", logdir)
