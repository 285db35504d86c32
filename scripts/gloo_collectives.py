"""Which collectives a gloo group runs on CUDA tensors (card only, ~1 min).

Two ranks share card 0 over gloo (NCCL refuses two ranks on one device,
so `chip_smoke.py`'s phase 28 runs its tensor-parallel step this way).
Each collective runs in a pair of ranks of its own, since a failing one
can kill its process: c10d's all-reduce, all-gather into a tensor,
reduce-scatter of a tensor and broadcast, and DTensor's functional
all-reduce, all-gather and reduce-scatter (Partial -> Replicate, Shard
-> Replicate and Partial -> Shard redistributions on a (2,) mesh).
Prints one line a collective, ok with its result or how it failed;
`distributed/meshctx.py` moves DTensors only with the ones that work.

Usage: python3 scripts/gloo_collectives.py
"""
import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp

CASES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
         "broadcast", "dtensor_partial_to_replicate",
         "dtensor_shard_to_replicate", "dtensor_partial_to_shard")


def _one(rank, init, case, out):
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.full((4,), float(rank + 1), device=dev)
    if case == "all_reduce":
        dist.all_reduce(x)
        got = x
    elif case == "all_gather_into_tensor":
        got = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(got, x)
    elif case == "reduce_scatter_tensor":
        got = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(got, x)
    elif case == "broadcast":
        dist.broadcast(x, 0)
        got = x
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = init_device_mesh("cuda", (2,))
        src, dst = {"dtensor_partial_to_replicate": (Partial(), Replicate()),
                    "dtensor_shard_to_replicate": (Shard(0), Replicate()),
                    "dtensor_partial_to_shard": (Partial(), Shard(0))}[case]
        got = DTensor.from_local(x, mesh, [src]).redistribute(
            mesh, [dst]).to_local()
    torch.cuda.synchronize()
    if rank == 0:
        with open(out, "w") as f:
            f.write(str(got.tolist()))
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_collectives: needs a CUDA card", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    with tempfile.TemporaryDirectory() as d:
        for case in CASES:
            init, out = os.path.join(d, f"{case}.init"), os.path.join(
                d, f"{case}.out")
            try:
                mp.spawn(_one, args=(init, case, out), nprocs=2, join=True)
                with open(out) as f:
                    print(f"{case}: ok {f.read()}", flush=True)
            except mp.ProcessExitedException as e:
                print(f"{case}: the rank died ({e})", flush=True)
            except mp.ProcessRaisedException as e:
                print(f"{case}: raised {str(e).splitlines()[-1]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
