"""Fleet-scale ILI simulation: many items, each running the same program
on different sensor inputs (the port of `repro/flexibits/fleet.py`).

A thin wrapper with the reference's historical signature:
`run_fleet_sharded` runs the fleet through `repro_torch.fleet.engine`'s
stream (one chunk of every item, segments, the port's default stepper)
over the shards of `mesh` and returns the full per-item final state,
O(fleet) on the host and the device. New code should use
`repro_torch.fleet` directly (heterogeneous plans, O(chunk) host memory,
carbon reports).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.flexibench.base import Workload
from repro_torch.flexibits import iss
from repro_torch.flexibits.cycles import Core, system_power_mw
from repro_torch.fleet import engine


def fleet_inputs(w: Workload, n_items: int, seed: int = 0) -> np.ndarray:
    """`n_items` memory images of workload `w`, inputs drawn from
    `default_rng(seed)` in one block (the reference's item order)."""
    rng = np.random.default_rng(seed)
    xs = w.gen_inputs(rng, n_items)
    base = w.initial_memory(np.zeros(w.n_inputs, np.int32))
    mems = np.tile(base, (n_items, 1))
    mems[:, :xs.shape[1]] = xs
    return mems


def run_fleet_sharded(w: Workload, mems: np.ndarray, mesh,
                      seg_steps: int = 4096) -> iss.ISSState:
    """Run the fleet with its items dealt over the shards of `mesh` (a
    sequence of devices, one per shard; None: one shard on the card).

    Returns the lane-batched final `ISSState` of every item, in item
    order, on the mesh's (first) device, bit-exact with the reference's
    `run_fleet_sharded`; the wrapper runs with timing off, so `n_cycles`
    is 0."""
    mems = np.asarray(mems, np.int32)
    n = mems.shape[0]
    res = engine.run_stream(
        w.program.code, engine.array_source(mems), n_items=n,
        mem_words=mems.shape[1], max_steps=w.max_steps, chunk=n,
        seg_steps=seg_steps, out_addr=w.out_addr, keep_state=True,
        mesh=mesh)
    dev = engine.mesh_devices(mesh, None)[0]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int32)).to(dev)
    return iss.ISSState(
        regs=t(res.regs), pc=t(res.pc), mem=t(res.mems),
        halted=torch.as_tensor(res.halted).to(dev),
        n_instr=t(res.n_instr), n_two_stage=t(res.n_two_stage),
        mix=t(res.mix_items),
        n_cycles=torch.zeros(n, dtype=iss.I32, device=dev))


def fleet_energy_kwh(state: iss.ISSState, core: Core,
                     vm_kb: float, clock_hz: float = 10_000.0) -> float:
    """Total fleet energy for one execution per item."""
    n_one = (state.n_instr - state.n_two_stage).cpu().numpy().astype(
        np.float64)
    n_two = state.n_two_stage.cpu().numpy().astype(np.float64)
    cycles = (n_one * core.cycles_one_stage()
              + n_two * core.cycles_two_stage())
    seconds = cycles / clock_hz
    joules = system_power_mw(core, vm_kb) * 1e-3 * seconds
    return float(joules.sum()) / 3.6e6
