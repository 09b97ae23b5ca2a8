#!/usr/bin/env python3
"""Which collective, as DTensor issues it (``torch.distributed``'s
functional collectives), can gloo carry on CUDA tensors?

Run from the root of a checkout on a machine with one GPU:

    python3 tools/gloo_cuda_probe.py

Two gloo ranks on ``cuda:0`` (NCCL refuses two ranks on one card), one
pair of processes an op, so that a crash kills only its pair: a (2,) mesh
of device type "cuda", then each of all-reduce, all-gather, reduce-scatter,
all-to-all and broadcast on a CUDA tensor, and the DTensor redistributions
built on them.  One ``PROBE <op>: rcs [rank 0, rank 1]`` line an op; a
negative code is the signal that ended the rank (-11: a segmentation
fault).  The card's name and power limit come first.
"""
import subprocess
import sys
import tempfile
import time

OPS = ["init_mesh", "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single", "broadcast", "dtensor_partial_to_replicate",
       "dtensor_shard_to_replicate", "dtensor_replicate_to_shard", "dtensor_partial_to_shard",
       "dtensor_shard_to_shard"]


def rank(d, r, op):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", world_size=2, rank=r)
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("model",))
    x = torch.arange(8, dtype=torch.float32, device="cuda") + r
    g = (mesh, 0)
    if op == "all_reduce":
        y = funcol.all_reduce(x, "sum", g)
    elif op == "all_gather_into_tensor":
        y = funcol.all_gather_tensor(x, 0, g)
    elif op == "reduce_scatter_tensor":
        y = funcol.reduce_scatter_tensor(x, "sum", 0, g)
    elif op == "all_to_all_single":
        y = funcol.all_to_all_single(x, None, None, g)
    elif op == "broadcast":
        y = funcol.broadcast(x, 0, g)
    elif op.startswith("dtensor"):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        src, dst = {"dtensor_partial_to_replicate": (Partial(), Replicate()),
                    "dtensor_shard_to_replicate": (Shard(0), Replicate()),
                    "dtensor_replicate_to_shard": (Replicate(), Shard(0)),
                    "dtensor_partial_to_shard": (Partial(), Shard(0)),
                    "dtensor_shard_to_shard": (Shard(0), Shard(1))}[op]
        t = DTensor.from_local(torch.ones(4, 4, device="cuda") * (r + 1), mesh, [src])
        y = t.redistribute(mesh, [dst]).to_local()
    else:
        y = x
    if hasattr(y, "wait"):
        y = y.wait()
    torch.cuda.synchronize()
    print(op, r, y.flatten()[:6].tolist(), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) == 1:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip(), flush=True)
    if len(sys.argv) > 1:
        rank(sys.argv[1], int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    for op in OPS:
        with tempfile.TemporaryDirectory() as d:
            t = time.time()
            ps = [subprocess.Popen([sys.executable, __file__, d, str(r), op],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                  for r in range(2)]
            outs = []
            for p in ps:
                try:
                    out, _ = p.communicate(timeout=90)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                outs.append((p.returncode, out.strip().splitlines()[-3:] if out else []))
            last = outs[0][1][-1:] if outs[0][1] else ""
            print(f"PROBE {op}: rcs {[o[0] for o in outs]} {time.time() - t:.1f}s {last}",
                  flush=True)
            for rc, lines in outs:
                if rc:
                    print("   ", lines, flush=True)
