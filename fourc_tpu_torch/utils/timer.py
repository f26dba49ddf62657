"""Phase timers.

Counterpart of fourc_tpu/utils/timer.py (the reference's Teuchos::TimeMonitor
scoped timers).  Host wall time: a phase that launches device work and does
not wait for it counts only the launches.  Usage:

    timers = Timers()
    with timers("assembly"):
        ...
    print(timers.summary())
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Timers:
    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def summary(self) -> str:
        if not self.total:
            return "(no timers)"
        w = max(len(k) for k in self.total)
        lines = [f"{'scope':<{w}}  {'total[s]':>10}  {'count':>6}  {'mean[ms]':>10}"]
        for k in sorted(self.total, key=lambda k: -self.total[k]):
            tot, n = self.total[k], self.count[k]
            lines.append(f"{k:<{w}}  {tot:>10.4f}  {n:>6d}  {1e3 * tot / n:>10.3f}")
        return "\n".join(lines)
