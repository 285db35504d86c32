"""NVM/VM memory profiler (paper Table 3 + §A.2 methodology analogue).

NVM = program words + read-only constant words (the paper's .text +
.rodata). VM = reserved input/global RAM + measured peak stack. Our
workloads are stack-free (leaf routines use registers), so VM is the
reserved image + the high-water mark of RAM words the ISS actually wrote.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.flexibench.base import Workload
from repro_torch.flexibits.pyiss import PyISS


def profile_memory(w: Workload, n_samples: int = 3,
                   seed: int = 0) -> Dict[str, float]:
    rng = np.random.default_rng(seed)
    xs = w.gen_inputs(rng, n_samples)
    ro_start = w.program.ro_base // 4
    hi_water = 0
    for x in xs:
        mem0 = w.initial_memory(x)
        sim = PyISS(w.program.code, w.total_mem_words, mem0)
        sim.run(w.max_steps)
        # VM high-water: highest RAM word (below the ROM segment) that
        # differs from the initial image or was an input/global
        writable = np.nonzero(
            (sim.mem[:ro_start] != mem0[:ro_start])
        )[0]
        hw = int(writable.max()) + 1 if len(writable) else w.n_inputs
        hi_water = max(hi_water, hw, w.n_inputs + 1)
    return {
        "nvm_kb": w.program.nvm_bytes / 1024.0,
        "vm_kb": 4.0 * hi_water / 1024.0,
        "code_words": int(len(w.program.code)),
        "const_words": int(len(w.program.ro_words)),
    }
