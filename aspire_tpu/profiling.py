"""Tracing and profiling utilities.

The reference has no profiling infrastructure (SURVEY.md §5: the only
instrumentation is the likelihood-eval counter and SMCHistory). This
module adds the device-side observability layer: phase wall-clock timers
feeding particles/s and ESS/s metrics, a context manager around the
JAX profiler for device traces, and the card description every
measurement is reported with.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import subprocess
import time
from collections import defaultdict

import jax

logger = logging.getLogger("aspire_tpu")


@dataclasses.dataclass
class PhaseStats:
    total_s: float = 0.0
    count: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Profiler:
    """Phase wall-clock accumulator.

    Usage::

        prof = Profiler()
        with prof.phase("mutate"):
            ...
        prof.summary()  # dict of phase -> {total_s, count, mean_s}
    """

    def __init__(self, block_until_ready: bool = True):
        self.phases: dict[str, PhaseStats] = defaultdict(PhaseStats)
        self.block_until_ready = block_until_ready
        self._counters: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, result_getter=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            elapsed = time.perf_counter() - t0
            stats = self.phases[name]
            stats.total_s += elapsed
            stats.count += 1

    def add(self, counter: str, value: float) -> None:
        """Accumulate a throughput counter (e.g. particle-steps)."""
        self._counters[counter] += value

    def rate(self, counter: str, phase: str) -> float:
        """counter units per second of the given phase."""
        total = self.phases[phase].total_s
        return self._counters[counter] / total if total > 0 else 0.0

    def summary(self) -> dict:
        out = {
            name: {
                "total_s": stats.total_s,
                "count": stats.count,
                "mean_s": stats.mean_s,
            }
            for name, stats in self.phases.items()
        }
        out["counters"] = dict(self._counters)
        return out

    def log_summary(self) -> None:
        for name, stats in sorted(self.phases.items()):
            logger.info(
                "phase %-20s total %8.3fs  n=%4d  mean %8.4fs",
                name,
                stats.total_s,
                stats.count,
                stats.mean_s,
            )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """JAX profiler trace (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("Device trace written to %s", log_dir)


def card_line() -> str:
    """``name, power.limit`` of each GPU, as nvidia-smi reports them.

    A card may run below its maximum power limit, and then slower under
    load, so every measurement is reported beside this line.
    """
    try:
        out = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=60,
            check=True,
        )
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"
    return out.stdout.strip()
