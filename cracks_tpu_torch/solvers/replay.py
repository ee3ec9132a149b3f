"""Replaying a loop body from a CUDA graph (torch).

The matrix-free Krylov loops (`solvers/linear.py`) and the power
iteration of the geometric GMG (`solvers/multigrid.py`) repeat one body
whose operator is hundreds of small kernels: a jvp of the element
residual, and for the V-cycle one per smoothing step on every level.
Launched one by one, those launches set the time.  `replayer` runs the
body eagerly once (which also warms up every library handle), captures
it into a CUDA graph on its second call, and replays the graph from
then on: one launch for all of its kernels.  The body must update its
state in place, on tensors that exist before the capture; the replay
runs the same kernels on the same addresses, so it computes what the
eager loop computes.  On the CPU the body simply runs, and so it does
in a rank of a process group (`parallel.dist`): there the body gathers
from the other ranks, and a collective cannot be captured.
"""

from __future__ import annotations

import torch

from ..parallel import dist


def _graphed(step):
    """`step` captured into a CUDA graph (recorded, not run) on a side
    stream; returns the graph's replay.  Unlike `torch.cuda.graph`, the
    capture neither synchronizes the device nor empties the allocator's
    cache: a solve captures a few graphs, and each emptied cache would
    cost the next eager kernels their allocations again."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            step()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph.replay


def replayer(step, cuda: bool):
    """A function that runs `step` each call: eagerly the first time,
    from a CUDA graph captured at the second call when `cuda` and this
    process is no rank of a process group."""
    calls = 0
    run = step
    cuda = cuda and dist.current() is None

    def call():
        nonlocal calls, run
        if calls == 1 and cuda:
            run = _graphed(step)
        calls += 1
        run()

    return call
