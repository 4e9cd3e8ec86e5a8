"""Observability: iteration records, divergence detection, profiling hooks.

The reference's observability is `disp` lines + tic/toc (SURVEY.md §5.1,
§5.5); here solvers emit structured per-iteration records to an optional
callback, detect divergence instead of looping to the cap, and expose a
profiler context for device trace capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import time
from typing import Callable, List, Optional

logger = logging.getLogger("fish_eye_bundle_adjustment_tpu")


@dataclasses.dataclass
class IterationRecord:
    iteration: int
    delta_l1: float
    elapsed_s: float
    cg_tol: Optional[float] = None
    # adaptive-LM trail (solver/schur.py run_gn_loop): False for a rejected
    # trial step (x unchanged, lambda raised); `damping` is lambda AFTER
    # this step's update
    accepted: bool = True
    damping: Optional[float] = None

    def __str__(self):
        extra = f" cg_tol={self.cg_tol:.2e}" if self.cg_tol is not None else ""
        if self.damping:
            extra += f" lm={self.damping:.2e}"
        if not self.accepted:
            extra += " REJECTED"
        return (
            f"iter {self.iteration}: sum|delta|={self.delta_l1:.6g} "
            f"t={self.elapsed_s:.3f}s{extra}"
        )


class SolverDivergence(RuntimeError):
    """Raised when the Gauss-Newton iteration produces non-finite or
    exploding corrections (the reference would silently loop to its
    iteration cap — main.m:490-493)."""

    def __init__(self, iteration: int, delta_l1: float, history: List[float]):
        self.iteration = iteration
        self.delta_l1 = delta_l1
        self.history = history
        super().__init__(
            f"adjustment diverged at iteration {iteration}: "
            f"sum|delta|={delta_l1:.6g} (history: {['%.3g' % d for d in history[-5:]]})"
        )


def check_divergence(iteration: int, delta_l1: float, history: List[float],
                     explode_factor: float = 1e6) -> None:
    """NaN/Inf or a 1e6x blow-up over the best-seen correction is divergence."""
    if not math.isfinite(delta_l1):
        raise SolverDivergence(iteration, delta_l1, history)
    finite = [d for d in history[:-1] if math.isfinite(d)]
    if finite and delta_l1 > explode_factor * min(finite):
        raise SolverDivergence(iteration, delta_l1, history)


ProgressFn = Callable[[IterationRecord], None]


def log_progress(rec: IterationRecord) -> None:
    """Default progress callback -> module logger (INFO)."""
    logger.info("%s", rec)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(str(log_dir)):
        yield


class Stopwatch:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
