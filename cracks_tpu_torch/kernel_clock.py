"""The device clock of the kernel measurements (``chip_smoke.py`` and the
tuning and A/B scripts under ``scripts/``): the card's time for one call,
from a cold L2 that holds no dirty line.

    clock = KernelClock(torch.device("cuda"))
    ms = clock.median_ms(fn)          # median of 25 readings
    ms = clock.once_ms(fn)            # one reading

Each reading flushes the L2 by reading a 128 MB buffer (more than twice
the H100's 50 MB) that nothing writes, so every line left in the L2 is
clean and a timed kernel that evicts lines writes none back; queues a
device-side sleep longer than the host's enqueue of `fn`, so the two
events bracket the card's work alone; and reads the events around one
call of `fn`.  ``dirty=True`` flushes by writing the buffer instead
(``zero_()``), the earlier clock of these measurements, kept for
comparison: it leaves the L2 full of dirty lines, and a kernel that
reads more than a few MB then pays their write-back to device memory
inside its window.
"""

from __future__ import annotations

import statistics

import torch

SLEEP_CYCLES = 400_000         # about 0.2 ms: longer than the enqueue
FLUSH_BYTES = 2 ** 27          # 128 MB
REPS, WARMUP = 25, 3           # readings of a median, untimed calls before


class KernelClock:
    """CUDA-event timing of single calls on one device behind an L2 flush
    (see the module's note)."""

    def __init__(self, device):
        self.buf = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32,
                              device=device)

    def once_ms(self, fn, dirty=False):
        """One reading of fn's device time in ms; the L2 flushed by a read
        of the buffer, or by a write with `dirty`."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if dirty:
            self.buf.zero_()
        else:
            self.buf.sum()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def median_ms(self, fn):
        """The median of REPS readings after WARMUP untimed calls."""
        for _ in range(WARMUP):
            fn()
        return statistics.median(self.once_ms(fn) for _ in range(REPS))
