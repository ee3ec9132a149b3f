"""Ranks of a run across processes: torch.distributed, one process per
rank.

A run on W ranks holds its D = ``n_devices`` shards D/W consecutive
shards to a rank (`sharding.make_shard_mesh`); the shards meet only in
`sharding.psum_shards`, `sharding.pmax_shards` and, in the replicated
cell-axis mode, `sharding.CellRange.gather`, which call
`all_gather_shards` and `all_max` here, and, on the lattice layout, in
the row exchanges of `sharding.ppermute_rows` and `sharding.Slab`,
which call `exchange_rows`: one round of point-to-point sends between
neighbour ranks.

Each rank sets its process group up from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and the
rendezvous address) or from an explicit rendezvous (`launch`, for tests
and scripts).  Its device is ``cuda:(LOCAL_RANK % device_count)``
unless the caller asks for the CPU.  The transport:

- NCCL when every rank of a host has a card of its own;
- gloo when ranks share a card or run on the CPU.  Gloo's CUDA support
  covers only broadcast and all_reduce, so a CUDA tensor goes through a
  pinned host buffer: copied out (the one wait of a collective), then
  gathered on the host, and what goes back is copied without a wait.
  Every staged collective starts with that blocking copy out, which
  also ends the previous collective's copies back, so a pinned buffer
  is never rewritten while a copy from it is pending.

A failed ``init_process_group`` or a failed collective raises; nothing
falls back to another transport or to one process.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import uuid
from typing import NamedTuple

import torch
import torch.distributed as tdist

# seconds a collective (and the rendezvous) may wait for the other ranks
TIMEOUT_S = 300.0

# collectives and the bytes each rank put into them, since the last
# reset (`reset_counts`)
COUNTS = dict(collectives=0, bytes=0)
# of them, the replicated cell-axis mode's gathers of per-cell terms
# (`sharding.CellRange.gather`) and their bytes
CELL_GATHERS = dict(gathers=0, bytes=0)
# neighbour row exchanges (`exchange_rows`) and the bytes each rank sent
# in them, since the last reset; of them the seam lattice's own, the
# mirror row's glued columns sent across a rank boundary
EXCHANGES = dict(exchanges=0, bytes=0, seam=0, seam_bytes=0)


class Ranks(NamedTuple):
    """This process's place in the run."""

    rank: int
    world: int
    device: torch.device
    backend: str               # "nccl" or "gloo"

    @property
    def staged(self) -> bool:
        """CUDA tensors through pinned host buffers (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"


_current: Ranks | None = None
_pinned: dict = {}


def current() -> Ranks | None:
    """The ranks set up by `init_process_group` in this process, or
    None (a one-process run)."""
    return _current


def _env_int(name: str, value):
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"{name} is not set: launch with torchrun or "
                         "pass it explicitly")
    return int(os.environ[name])


def init_process_group(*, device=None, init_method: str = "env://",
                       rank=None, world_size=None, local_rank=None,
                       local_world_size=None,
                       timeout_s: float = TIMEOUT_S) -> Ranks:
    """Join the run's process group and return this process's `Ranks`.

    Arguments left at None come from torchrun's environment.  `device`
    "cpu" puts the rank on the CPU; otherwise the rank takes card
    LOCAL_RANK % device_count (no card raises).  NCCL when the host's
    ranks (LOCAL_WORLD_SIZE) have a card each, else gloo.  When every
    rank runs on this host the sockets of both bind the loopback
    interface (unless GLOO_SOCKET_IFNAME / NCCL_SOCKET_IFNAME say
    otherwise)."""
    global _current
    if _current is not None:
        raise RuntimeError("the process group is already set up")
    rank = _env_int("RANK", rank)
    world = _env_int("WORLD_SIZE", world_size)
    local_rank = _env_int("LOCAL_RANK", local_rank)
    local_world = (int(os.environ.get("LOCAL_WORLD_SIZE", world))
                   if local_world_size is None else int(local_world_size))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("a rank on a card was requested but "
                               "torch.cuda is not available")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= n_cards else "gloo"
    if local_world == world:
        # every rank on this host: the transports' sockets on loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    kw = dict(backend=backend, init_method=init_method, rank=rank,
              world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        kw["device_id"] = dev
    tdist.init_process_group(**kw)
    _current = Ranks(rank, world, dev, backend)
    return _current


def destroy_process_group() -> None:
    """Leave the process group (if this process joined one)."""
    global _current
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _current = None
    _pinned.clear()


def describe(ranks: Ranks) -> str:
    """The transport, for the run's log line."""
    how = (", CUDA tensors staged through pinned host memory"
           if ranks.staged else "")
    return f"{ranks.world} ranks over {ranks.backend}{how}"


def reset_counts() -> None:
    COUNTS.update(collectives=0, bytes=0)
    CELL_GATHERS.update(gathers=0, bytes=0)
    EXCHANGES.update(exchanges=0, bytes=0, seam=0, seam_bytes=0)


def _host(shape, dtype, slot: str = "") -> torch.Tensor:
    """A pinned host buffer of this shape and dtype, kept for reuse (one
    per `slot`, so that buffers in use together never alias)."""
    key = (tuple(shape), dtype, slot)
    buf = _pinned.get(key)
    if buf is None:
        buf = _pinned[key] = torch.empty(shape, dtype=dtype,
                                         pin_memory=True)
    return buf


_all_gather = getattr(tdist, "all_gather_single", None) or \
    tdist.all_gather_into_tensor


def _gather(out: torch.Tensor, x: torch.Tensor, ranks: Ranks) -> None:
    """out = every rank's x, rank-major.  Over gloo one all-to-all of x
    repeated W times: one round of W - 1 sends, where gloo's ring
    all-gather takes W - 1 rounds of its loopback latency
    (`scripts/bench_rank_transport.py`)."""
    if ranks.backend == "gloo":
        tdist.all_to_all_single(
            out, x.unsqueeze(0).expand((ranks.world,) + x.shape)
            .reshape(out.shape).contiguous())
    else:
        _all_gather(out, x)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`, through a pinned buffer, without a
    wait (only after a staged collective's copy out; see above)."""
    buf = _host(t.shape, t.dtype)
    buf.copy_(t)
    return buf.to(device, non_blocking=True)


def all_gather_shards(x: torch.Tensor, ranks: Ranks, *,
                      to_host: bool = False) -> torch.Tensor:
    """Every rank's (D/W, ...) block, rank-major: a (D, ...) tensor on
    x's device, equal on all ranks.  Staged, with `to_host` it stays on
    the host, in a pinned buffer that the next collective reuses."""
    x = x.contiguous()
    out_shape = (x.shape[0] * ranks.world,) + tuple(x.shape[1:])
    COUNTS["collectives"] += 1
    COUNTS["bytes"] += x.numel() * x.element_size()
    if not ranks.staged:
        out = x.new_empty(out_shape)
        _gather(out, x, ranks)
        return out
    src = _host(x.shape, x.dtype)
    src.copy_(x)
    out = _host(out_shape, x.dtype)
    _gather(out, src, ranks)
    return out if to_host else out.to(x.device, non_blocking=True)


def all_max(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """The elementwise largest of every rank's x (exact in any order)."""
    COUNTS["collectives"] += 1
    COUNTS["bytes"] += x.numel() * x.element_size()
    if not ranks.staged:
        y = x.clone()
        tdist.all_reduce(y, op=tdist.ReduceOp.MAX)
        return y
    buf = _host(x.shape, x.dtype)
    buf.copy_(x)
    tdist.all_reduce(buf, op=tdist.ReduceOp.MAX)
    return buf.to(x.device, non_blocking=True)


def exchange_rows(ranks: Ranks, *, down=None, up=None, from_below=None,
                  from_above=None, seam: bool = False):
    """One round of sends between neighbour ranks: `down` (a tensor or
    None) goes to rank - 1 and `up` to rank + 1; `from_below` /
    `from_above` (a (shape, dtype) pair or None) say what arrives from
    rank - 1 / rank + 1.  Both sides of a boundary must agree on what
    crosses it.  Returns (tensor from below, tensor from above), None
    where nothing arrives, on the device of the sent tensors (or of the
    ranks).  Staged ranks copy what they send into pinned host buffers
    (the one wait: it also ends every earlier copy back, so no buffer is
    rewritten under a pending copy) and copy what arrives back without a
    wait; NCCL sends CUDA tensors as they are.  `seam` counts the round
    as the seam lattice's too."""
    dev = ranks.device
    sends = [(t, ranks.rank + d, s) for t, d, s in
             ((down, -1, "down"), (up, 1, "up")) if t is not None]
    recvs = [(spec, ranks.rank + d, s) for spec, d, s in
             ((from_below, -1, "below"), (from_above, 1, "above"))
             if spec is not None]
    for _, peer, _ in sends + recvs:
        if not 0 <= peer < ranks.world:
            raise ValueError(f"rank {ranks.rank} of {ranks.world} has no "
                             f"neighbour {peer}")
    sent = sum(t.numel() * t.element_size() for t, _, _ in sends)
    EXCHANGES["exchanges"] += 1
    EXCHANGES["bytes"] += sent
    if seam:
        EXCHANGES["seam"] += 1
        EXCHANGES["seam_bytes"] += sent
    if ranks.staged:
        torch.cuda.current_stream(dev).synchronize()
        out = []
        for t, peer, slot in sends:
            buf = _host(t.shape, t.dtype, "send-" + slot)
            buf.copy_(t)
            out.append(buf)
        inbox = [_host(shape, dtype, "recv-" + slot)
                 for (shape, dtype), _, slot in recvs]
    else:
        out = [t.contiguous() for t, _, _ in sends]
        inbox = [torch.empty(shape, dtype=dtype, device=dev)
                 for (shape, dtype), _, _ in recvs]
    ops = ([tdist.P2POp(tdist.irecv, buf, peer)
            for buf, (_, peer, _) in zip(inbox, recvs)]
           + [tdist.P2POp(tdist.isend, buf, peer)
              for buf, (_, peer, _) in zip(out, sends)])
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    got = {}
    for buf, (_, _, slot) in zip(inbox, recvs):
        got[slot] = (buf.to(dev, non_blocking=True) if ranks.staged
                     else buf)
    return got.get("below"), got.get("above")


# ---------------------------------------------------------------------------
# a launcher for tests and scripts
# ---------------------------------------------------------------------------

class RankFailed(RuntimeError):
    """A rank of a `launch` raised, died or outlived the deadline."""


def _rank_main(rank, fn, args, world, device, init_method, timeout_s,
               n_threads, results):
    if n_threads:
        torch.set_num_threads(n_threads)
    ranks = init_process_group(
        device=device, init_method=init_method, rank=rank, world_size=world,
        local_rank=rank, local_world_size=world, timeout_s=timeout_s)
    # by value: the queue's own pickler would share a tensor's storage
    # with this process, which is about to end.  A rank that raises
    # leaves its group up, so the others fail only once it has exited
    # and its error is the one `launch` reports
    results.put((rank, pickle.dumps(fn(ranks, *args))))
    destroy_process_group()


def launch(fn, world: int, *, device, rendezvous_dir: str, args=(),
           timeout_s: float = TIMEOUT_S, deadline_s: float = 600.0,
           n_threads: int | None = 1) -> list:
    """Run fn(ranks, *args) on `world` spawned ranks on `device` ("cuda"
    or "cpu") and return each rank's result, rank-ordered.

    The ranks meet through a fresh ``file://`` rendezvous in
    `rendezvous_dir` (no port to race for), and their collectives give
    up after `timeout_s`.  When a rank raises or dies, or the launch
    passes `deadline_s`, the other ranks are killed and `RankFailed`
    carries the failing rank's traceback.  `fn` and its results must
    pickle; each rank runs `n_threads` torch threads."""
    import torch.multiprocessing as tmp
    init = "file://" + os.path.join(os.path.abspath(rendezvous_dir),
                                    f"rendezvous-{uuid.uuid4().hex}")
    results = tmp.get_context("spawn").SimpleQueue()
    procs = tmp.start_processes(
        _rank_main, args=(fn, args, world, device, init, timeout_s,
                          n_threads, results),
        nprocs=world, join=False, start_method="spawn")
    out = {}
    end = time.monotonic() + deadline_s
    try:
        done = False
        while not done:
            done = procs.join(timeout=0.2)
            while not results.empty():
                rank, payload = results.get()
                out[rank] = pickle.loads(payload)
            if not done and time.monotonic() > end:
                left = sorted(set(range(world)) - set(out))
                raise RankFailed(f"the launch of {world} ranks passed its "
                                 f"deadline of {deadline_s} s with ranks "
                                 f"{left} unfinished")
    except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
        raise RankFailed(f"rank {e.error_index} of {world} failed: "
                         f"{e}") from None
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return [out[r] for r in range(world)]
