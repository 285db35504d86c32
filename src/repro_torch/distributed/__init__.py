"""Distributed-run support of the port (the reference's `distributed/`).

- `checkpoint`  — atomic, integrity-checked checkpoints of flat array
                  dicts, in the reference's on-disk format
- `sharding`    — the reference's name-and-shape sharding rules on its
                  stacked leaves, device-free meshes, DTensor placement
- `meshctx`     — the installed mesh, logical-axis `shard_act`, the
                  batch group and a differentiable sum over it
- `compression` — the int8 error-feedback gradient all-reduce
- `elastic`     — resume a checkpoint onto a different mesh
"""
