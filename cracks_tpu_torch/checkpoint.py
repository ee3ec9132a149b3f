"""Checkpoint / resume.

Port of ``cracks_tpu/checkpoint.py``.  The reference has no
checkpoint-restart (its run() state lives in memory only); a
checkpoint holds everything run() needs to continue a simulation: the
forest's cells, the solution triplet, the time-stepping state, the
Sneddon refinement-cycle countdown and the statistics table so far.

Format: one .npz of host arrays, the same keys as the JAX package's,
so either package reads the other's checkpoints.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def save_checkpoint(path: str, sim, state) -> None:
    """Write the full restartable state of a driver.Simulation."""
    meta = dict(
        time=sim.time, timestep=sim.timestep,
        timestep_number=sim.timestep_number,
        old_timestep=sim.old_timestep,
        old_old_timestep=sim.old_old_timestep,
        min_cell_diameter=sim.min_cell_diameter,
        constant_k=sim.constant_k, alpha_eps=sim.alpha_eps,
        output_counter=sim.output_counter,
        refinement_cycle=sim.refinement_cycle,
        refinement_cycles_left=sim.refinement_cycles_left,
    )
    st = sim.statistics
    stats = dict(columns=st.columns, data=st.data, formats=st.formats,
                 n_rows=st.n_rows)
    host = lambda x: x.cpu().numpy()
    np.savez_compressed(
        path,
        meta=json.dumps(meta),
        statistics=json.dumps(stats),
        forest_root=sim.forest.root,
        forest_level=sim.forest.level,
        forest_anchor=sim.forest.anchor,
        u=host(state.u), phi=host(state.phi), u_old=host(state.u_old),
        phi_old=host(state.phi_old), phi_oold=host(state.phi_oold),
    )


def load_checkpoint(path: str, params, *, device, verbose: bool = True):
    """(Simulation, SolutionState) on `device` from a checkpoint.

    The coarse mesh is rebuilt from the parameters (deterministic), the
    forest's cells are restored verbatim and the System is set up for
    the restored mesh."""
    from .driver import Simulation, SolutionState

    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        stats = json.loads(str(data["statistics"]))
        arrays = {k: data[k] for k in data.files
                  if k not in ("meta", "statistics")}

    sim = Simulation(params.replace(n_global_pre_refine=0), device=device,
                     verbose=verbose)
    # the run's own parameters from here on: the level cap and the
    # mesh-dependent h of the non-Sneddon cases count the global
    # refinements (the JAX loader keeps the zero)
    sim.p = params
    sim.forest.root = arrays["forest_root"]
    sim.forest.level = arrays["forest_level"]
    sim.forest.anchor = arrays["forest_anchor"]
    sim.mesh = sim.forest.extract()
    sim.min_cell_diameter = meta["min_cell_diameter"]
    sim.constant_k = meta["constant_k"]
    sim.alpha_eps = meta["alpha_eps"]
    sim.setup_system()
    sim.time = meta["time"]
    sim.timestep = meta["timestep"]
    sim.timestep_number = meta["timestep_number"]
    sim.old_timestep = meta["old_timestep"]
    sim.old_old_timestep = meta["old_old_timestep"]
    sim.output_counter = meta["output_counter"]
    sim.refinement_cycle = meta["refinement_cycle"]
    sim.refinement_cycles_left = meta["refinement_cycles_left"]
    # the table so far, so the per-step rewrite keeps the earlier rows
    st = sim.statistics
    st.columns = list(stats["columns"])
    st.data = {k: list(v) for k, v in stats["data"].items()}
    st.formats = {k: tuple(v) for k, v in stats["formats"].items()}
    st.n_rows = stats["n_rows"]

    dev = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    state = SolutionState(u=dev(arrays["u"]), phi=dev(arrays["phi"]),
                          u_old=dev(arrays["u_old"]),
                          phi_old=dev(arrays["phi_old"]),
                          phi_oold=dev(arrays["phi_oold"]))
    if state.phi.shape[0] != sim.mesh.n_vertices:
        raise ValueError(f"checkpoint {path}: its solution does not match "
                         "its forest")
    return sim, state
