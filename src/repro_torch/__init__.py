"""PyTorch / CUDA port of the fleet simulation, the carbon sweep and the
LM stack's serving and training paths, beside the JAX reference in
`repro`.

It runs on one NVIDIA card by default (`device=None` means "cuda" and
raises without one; pass `device="cpu"` for the plain PyTorch path). It
imports `torch` and `numpy`, never `jax` and never the reference
package: the reference's JAX-free modules it needs are copied here.

Layout mirrors the reference: `flexibits/` (ISA, assembler, cycle model,
FlexiLint analysis, the lane-vectorized simulator), `flexibench/` (the
11 workloads), `kernels/` (the CUDA kernels, their wrappers and their
nvcc build), `core/` (carbon model, core selection, the sweep),
`fleet/` (the packed resident engine, plans and the carbon report),
`configs/`, `models/`, `optim/`, `data/` and `launch/` (LM serving and
training, meshes, the dry run and its H100 roofline), `distributed/`
(checkpoints, sharding rules, the mesh context, the int8 all-reduce,
elastic resume), `convert.py`
(state and parameter carry-across with the reference) and `device.py`
(the device policy).
"""
