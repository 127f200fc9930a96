"""Benchmark/timing utilities.

The reference never timed itself (SURVEY.md section 6: no cudaEvent/chrono
anywhere); the BASELINE metric is paths/sec/chip, so timing is a first-class
subsystem here: warm-up (compile), best-of-N wall clock with
``block_until_ready``, and an optional ``jax.profiler`` trace capture.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Callable, Optional

import jax

__all__ = ["BenchResult", "time_fn", "profile_trace"]


@dataclasses.dataclass(frozen=True)
class BenchResult:
    best_s: float
    mean_s: float
    reps: int
    work: Optional[float] = None     # e.g. paths or path-steps per call

    @property
    def throughput(self) -> Optional[float]:
        return None if self.work is None else self.work / self.best_s

    def __str__(self):
        s = f"best {self.best_s*1e3:.3f} ms / mean {self.mean_s*1e3:.3f} ms"
        if self.work is not None:
            s += f" -> {self.throughput:,.0f} units/sec"
        return s


def time_fn(fn: Callable, *, reps: int = 10, warmup: int = 1,
            work: Optional[float] = None) -> BenchResult:
    """Best-of-reps wall time of ``fn()`` (must return a JAX array or
    pytree).

    Each call ends in ``jax.block_until_ready``: JAX returns before the
    device finishes, so a timing without it measures the enqueue.
    """
    def run():
        return jax.block_until_ready(fn())

    for _ in range(warmup):
        run()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return BenchResult(best_s=min(times), mean_s=sum(times) / len(times),
                       reps=reps, work=work)


@contextmanager
def profile_trace(logdir: str):
    """Capture a ``jax.profiler`` trace (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
