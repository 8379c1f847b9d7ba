"""Profiling & observability: per-phase timing and device traces.

The reference's only instrumentation is a wall-clock wrapper per method
(``utils.h:88-104``; SURVEY.md §5 "no per-phase timing inside FMM"). Here:

* :class:`PhaseTimer` — named wall-clock phases, each ended by
  ``jax.block_until_ready`` on its result, reported as a table.
* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable device trace, when a trace directory is given.
* :func:`phase_breakdown_fmm` — times the FMM stages (build / P2M+M2L+L2P
  pipeline / total) by re-running the jitted pieces, the engine's analog of
  the reference's missing p2m/m2m/m2l/l2l/l2p/p2p phase clocks.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


class PhaseTimer:
    """Accumulate named phase wall-times; print a table."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result_holder=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result_holder is not None:
                jax.block_until_ready(result_holder)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def timed(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return out

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'phase':<24} {'time':>10} {'calls':>6} {'%':>6}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(
                f"{name:<24} {t:>9.4f}s {self.counts[name]:>6} {pct:>5.1f}%")
        lines.append(f"{'total':<24} {total:>9.4f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """jax.profiler device trace (no-op when trace_dir is None)."""
    if trace_dir is None:
        yield
        return
    with jax.profiler.trace(trace_dir):
        yield


def phase_breakdown_fmm(positions, masses, config=None, order: int = 5,
                        timer: Optional[PhaseTimer] = None) -> PhaseTimer:
    """Time FMM build vs evaluation (each jitted piece waited for)."""
    from ..config import DEFAULT_GRAVITY
    from ..ops.fmm import fmm_accel_sorted
    from ..ops.grid_tree import (auto_leaf_level, build_grid_tree,
                                 compute_capacity)

    config = config or DEFAULT_GRAVITY
    timer = timer or PhaseTimer()
    n, dim = positions.shape
    leaf_level = auto_leaf_level(n, dim)
    capacity = timer.timed("capacity_scan", compute_capacity,
                           positions, leaf_level)
    tree = timer.timed("tree_build", build_grid_tree, positions, masses,
                       leaf_level, capacity)
    timer.timed("fmm_eval(P2M..P2P)", fmm_accel_sorted, tree, order=order,
                softening=float(config.softening))
    return timer
