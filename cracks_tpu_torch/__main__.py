"""Command-line driver::

    python -m cracks_tpu_torch <parameters.prm> [key=value ...]
        [device=cuda|cpu]

Runs the simulation described by the parameter file, with any
``Parameters`` field overridable as ``key=value``, on the given device.
The device defaults to ``cuda``, and a missing card raises; the port
never falls back to the CPU on its own.

On W ranks, one process each::

    torchrun --standalone --nproc-per-node W -m cracks_tpu_torch \
        <parameters.prm> n_devices=D dof_sharding=lattice [device=cpu]

Each rank joins the process group from torchrun's environment and takes
card LOCAL_RANK % device_count (or the CPU), NCCL when every rank has a
card of its own, else gloo (`parallel/dist.py`); W must divide D, and
the halo pool runs D / W shards on each rank.  Rank 0 prints and writes
the output.  Without torchrun the run is one process.
"""

import os
import sys


def _convert(template, value: str):
    if isinstance(template, bool):
        low = value.strip().lower()
        if low not in ("true", "false", "1", "0", "yes", "no", "on", "off"):
            raise ValueError(f"not a boolean: {value!r}")
        return low in ("true", "1", "yes", "on")
    return type(template)(value)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m cracks_tpu_torch <parameter_file> "
              "[key=value ...] [device=cuda|cpu]")
        return 2

    from .driver import run_prm
    from . import config

    base = config.load_parameters(argv[0])
    device = "cuda"
    overrides = {}
    for extra in argv[1:]:
        key, sep, value = extra.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {extra!r}")
        if key == "device":
            device = value
        else:
            overrides[key] = _convert(getattr(base, key), value)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from .parallel import dist
        ranks = dist.init_process_group(device=device)
        try:
            if ranks.rank == 0:
                print(f"Problem dimension: "
                      f"{base.replace(**overrides).dimension}")
            run_prm(argv[0], device=ranks.device, **overrides)
        finally:
            dist.destroy_process_group()
        return 0
    print(f"Problem dimension: {base.replace(**overrides).dimension}")
    run_prm(argv[0], device=device, **overrides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
