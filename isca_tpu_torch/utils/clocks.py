"""Hierarchical named timers (mpp_clock equivalent) + memory reporting.

Port of isca_tpu/utils/clocks.py (reference: src/shared/mpp/mpp.F90 clocks,
mpp_clock_id/begin/end with a summary at fms_end, and memutils
print_memuse_stats). The clock and the resident set come from the port's
native library (isca_tpu_torch.native, built with g++ at first use). For
device work wrap the region so it ends in `torch.cuda.synchronize()`, or use
torch.profiler for kernel-level traces.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

from isca_tpu_torch.native import ns_clock, rss_kb


class Clocks:
    def __init__(self):
        self._total = defaultdict(int)
        self._count = defaultdict(int)
        self._start = {}

    def begin(self, name: str):
        self._start[name] = ns_clock()

    def end(self, name: str):
        self._total[name] += ns_clock() - self._start.pop(name)
        self._count[name] += 1

    @contextlib.contextmanager
    def clock(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def summary(self) -> str:
        lines = ["%-32s %12s %8s %12s" % ("clock", "total (s)", "calls", "avg (ms)")]
        for name in sorted(self._total, key=self._total.get, reverse=True):
            tot = self._total[name] / 1e9
            n = self._count[name]
            lines.append("%-32s %12.3f %8d %12.3f" % (name, tot, n, tot / n * 1e3))
        lines.append("rss: %.1f MB" % (rss_kb() / 1024.0))
        return "\n".join(lines)


CLOCKS = Clocks()
