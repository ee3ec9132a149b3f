"""Wall-clock section timing — the TimerOutput analogue (reference
cracks.cc:1185-1186, 4289): accumulate per-section call counts and wall
times, print a summary table.

Usage:
    timer = Timer()
    with timer.section("Time step loop"):
        ...
    print(timer.summary())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Timer:
    def __init__(self):
        self.wall = defaultdict(float)
        self.calls = defaultdict(int)
        self._t0 = time.time()

    @contextlib.contextmanager
    def section(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            self.wall[name] += time.time() - start
            self.calls[name] += 1

    def summary(self) -> str:
        total = time.time() - self._t0
        lines = [
            "+---------------------------------------------+------------"
            "+------------+",
            f"| Total wallclock time elapsed since start    | {total:9.3g}s"
            "  |            |",
            "| Section                         | no. calls |  wall time "
            "| % of total |",
            "+---------------------------------+-----------+------------"
            "+------------+",
        ]
        for name in sorted(self.wall, key=self.wall.get, reverse=True):
            w = self.wall[name]
            pct = 100.0 * w / total if total > 0 else 0.0
            lines.append(
                f"| {name:31s} | {self.calls[name]:9d} | {w:9.3g}s "
                f"| {pct:9.2f}% |")
        lines.append(lines[3])  # closing separator row
        return "\n".join(lines)


def memory_stats() -> str:
    """VmPeak/VmRSS report (reference cracks.cc:4577-4580)."""
    try:
        with open("/proc/self/status") as f:
            fields = {}
            for line in f:
                if line.startswith(("VmPeak", "VmRSS")):
                    k, v = line.split(":", 1)
                    fields[k] = v.strip()
        return (f"VMPEAK, Resident in kB: "
                f"{fields.get('VmPeak', '?')} {fields.get('VmRSS', '?')}")
    except OSError:  # pragma: no cover
        return "memory stats unavailable"
