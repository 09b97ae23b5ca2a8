"""Production mesh construction (the dry-run's contract), the port of
``repro.launch.mesh``.

Single pod: (16, 16) -> ("data", "model"), 256 cards.
Multi-pod:  (2, 16, 16) -> ("pod", "data", "model"), 512 cards.

A function, so importing this module opens nothing: the caller opens the
process group first (the dry-run a fake one of 256 or 512 ranks,
``launch.dryrun.fake_process_group``).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"need {need} devices for the production mesh, have {have}"
            " (the dry-run opens a fake process group of 512 ranks)"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
