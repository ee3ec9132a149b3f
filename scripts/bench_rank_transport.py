"""What one collective of the halo pool costs on W ranks of one card.

    python3 scripts/bench_rank_transport.py [iterations]

The ranks of a W-process run on one card share it (gloo, CUDA tensors
staged through pinned host memory; `cracks_tpu_torch/parallel/dist.py`).
For W = 1, 2 and 4 spawned ranks (`dist.launch`), each rank times, in ms
per iteration (median of its iterations, the largest over the ranks):

- ``gather cpu all_gather``: one gloo all-gather of a 4.6 kB CPU
  tensor (the pool of a block-CG iteration), W - 1 rounds of a ring;
- ``gather cpu all_to_all``: the same gather as one all-to-all of the
  rank's block repeated W times, one round of W - 1 sends (what
  `dist.all_gather_shards` does over gloo);
- ``gather staged``: the same from and to a CUDA tensor
  (`dist.all_gather_shards`: device-to-host copy, gather, copy back);
- ``psum staged``: `sharding.psum_shards` of a (1,) CUDA tensor;
- ``kernels``: 100 small kernels and a host read, no collective (one
  iteration's launches; with W > 1 the ranks' contexts share the card);
- ``kernels + 4 psums``: both, as a block-CG iteration has them.

At W = 4 the ranks run once more while this process polls nvidia-smi
every 0.5 s, as `chip_smoke.py` phase 20 does to read the card's idle
share ("W=4 sampled").  Prints one line per (W, variant), also into
``chiprun_out/bench_rank_transport.txt``, and, last, the card's name
and power limit.  Needs a card; the ranks start in about 10 s each.
"""

import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as tdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _timed(fn, iterations):
    for _ in range(10):
        fn()
    out = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(out)


def _rank(ranks, iterations):
    from cracks_tpu_torch.parallel import dist, sharding
    dev = ranks.device
    mesh = sharding.make_shard_mesh([dev] * ranks.world, ranks=ranks)
    pool_cpu = torch.zeros(1, 577, dtype=torch.float64)
    pool_dev = pool_cpu.to(dev)
    one = torch.ones(1, dtype=torch.float64, device=dev)
    x = torch.zeros(4096, dtype=torch.float64, device=dev)

    def kernels():
        for _ in range(100):
            x.add_(1.0)

    def step():
        kernels()
        for _ in range(4):
            sharding.psum_shards(one, mesh)
        bool(x[0] > 0)

    def launches():
        kernels()
        bool(x[0] > 0)

    def all_gather():
        out = pool_cpu.new_empty((ranks.world,) + pool_cpu.shape[1:])
        tdist.all_gather_into_tensor(out, pool_cpu)
        return out

    def all_to_all():
        out = pool_cpu.new_empty((ranks.world,) + pool_cpu.shape[1:])
        tdist.all_to_all_single(out, pool_cpu.expand(
            (ranks.world,) + pool_cpu.shape[1:]).contiguous())
        return out

    out = dict(kernels=_timed(launches, iterations))
    if ranks.world > 1:
        out.update({
            "gather cpu all_gather": _timed(all_gather, iterations),
            "gather cpu all_to_all": _timed(all_to_all, iterations),
            "gather staged": _timed(
                lambda: dist.all_gather_shards(pool_dev, ranks), iterations),
            "psum staged": _timed(
                lambda: bool(sharding.psum_shards(one, mesh)[0] > 0),
                iterations),
            "kernels + 4 psums": _timed(step, iterations)})
    return out


def _poll(stop):
    while not stop.wait(0.5):
        subprocess.run(["nvidia-smi", "--query-gpu=utilization.gpu",
                        "--format=csv,noheader,nounits", "--id=0"],
                       capture_output=True, timeout=30)


def main(iterations=200):
    import threading
    from cracks_tpu_torch.parallel import dist
    if not torch.cuda.is_available():
        raise RuntimeError("bench_rank_transport needs a card")
    lines = []
    for world, sampled in ((1, False), (2, False), (4, False), (4, True)):
        stop = threading.Event()
        poller = threading.Thread(target=_poll, args=(stop,), daemon=True)
        if sampled:
            poller.start()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                outs = dist.launch(_rank, world, args=(iterations,),
                                   device="cuda", rendezvous_dir=tmp,
                                   timeout_s=120, deadline_s=300,
                                   n_threads=max(1, (os.cpu_count() or 8)
                                                 // world))
        finally:
            stop.set()
            if sampled:
                poller.join()
        for name in outs[0]:
            lines.append(f"W={world}{' sampled' if sampled else ''} {name}: "
                         f"{max(o[name] for o in outs):.3f} ms per iteration"
                         f" (ranks {[round(o[name], 3) for o in outs]})")
            print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines.append(smi.stdout.strip())
    print(lines[-1])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "bench_rank_transport.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
