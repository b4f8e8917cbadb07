"""Per-stage profiling: timers + mean/min/max/total report.

Equivalent of the reference's profiling subsystem: ``GPUTimer`` wrapping
CL event timestamps (CLUtils.hpp:439-494), ``ProfilingInfo`` series with the
mean/min/max/total/speedup report (CLUtils.hpp:240-361, printed as at
opencl/bmfr.cpp:489-517), and ``CPUTimer`` (CLUtils.hpp:371-431).

Per-dispatch device timestamps come from the XLA profiler traces; for the
routine report we use wall-clock around ``block_until_ready`` and expose
:func:`trace` for capturing xplane traces when kernel-level timing is
needed.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


class CPUTimer:
    """chrono-style start/stop timer (CLUtils.hpp:371-431 equivalent)."""

    def __init__(self):
        self._t0 = None
        self._duration_ms = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        self._duration_ms = (time.perf_counter() - self._t0) * 1e3
        return self._duration_ms

    def duration(self):
        return self._duration_ms


def timed(fn, *args):
    """Run ``fn(*args)`` and time it to completion on the device — the
    equivalent of the reference's CL event end timestamp
    (opencl/bmfr.cpp:497-502). Returns ``(seconds, output)``."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


@dataclass
class ProfilingInfo:
    """Fixed-label timing series with the reference's report format
    (CLUtils.hpp:240-361)."""

    label: str
    times_ms: list = field(default_factory=list)

    def __getitem__(self, i):
        return self.times_ms[i]

    def append(self, ms):
        self.times_ms.append(ms)

    def mean(self):
        return sum(self.times_ms) / max(len(self.times_ms), 1)

    def min(self):
        return min(self.times_ms) if self.times_ms else 0.0

    def max(self):
        return max(self.times_ms) if self.times_ms else 0.0

    def total(self):
        return sum(self.times_ms)

    def report_row(self):
        return (f"{self.label:<55}{self.mean():>10.3f}{self.min():>10.3f}"
                f"{self.max():>10.3f}{self.total():>12.3f}")


def print_report(infos):
    """mean/min/max/total table, mirroring ProfilingInfo::print
    (CLUtils.hpp:313-332)."""
    header = (f"{'stage':<55}{'mean ms':>10}{'min ms':>10}"
              f"{'max ms':>10}{'total ms':>12}")
    lines = [header, "-" * len(header)]
    lines += [p.report_row() for p in infos]
    report = "\n".join(lines)
    print(report)
    return report


@contextlib.contextmanager
def trace(logdir):
    """Capture an XLA xplane trace for per-kernel device timings (the deep
    equivalent of CL_QUEUE_PROFILING_ENABLE, opencl/bmfr.cpp:191)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
