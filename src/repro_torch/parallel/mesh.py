"""The comet mesh: the paper's three parallelism axes over torch devices.

The port of ``repro.parallel.mesh`` (``make_comet_mesh`` and
``comet_mesh_from_production``).  ``repro`` runs
one program under ``shard_map`` over a ``("pf", "pv", "pr")`` ``Mesh`` of
devices (vector elements / vector number / round-robin); the port runs one
controller over a ``CometMesh``, an ``(n_pf, n_pv, n_pr)`` array of
``torch.device``s, and ``repro_torch.parallel.ring`` places each rank's
shards on its device and moves the ring between them.

A device may repeat: several ranks then share one card (or the CPU), the
counterpart of XLA's virtual host devices.  On a host with several cards,
one rank a card, the ring's copies are peer copies between them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["COMET_AXES", "CometMesh", "make_comet_mesh", "comet_mesh_from_production",
           "physical_device"]

COMET_AXES = ("pf", "pv", "pr")


@dataclass(frozen=True, eq=False)
class CometMesh:
    """An ``(n_pf, n_pv, n_pr)`` object array of ``torch.device``s, one per
    rank.  ``eq=False``: meshes compare by identity, as engine caches key
    them."""

    devices: np.ndarray
    axis_names: tuple = COMET_AXES
    ranks: np.ndarray | None = None  # process ranks, when built from a DeviceMesh

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, pf: int, pv: int, pr: int) -> torch.device:
        """The device of rank (pf, pv, pr)."""
        return self.devices[pf, pv, pr]

    def physical_devices(self) -> list:
        """The distinct devices of the mesh, in rank order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def physical_device(device: torch.device) -> torch.device:
    """``cuda`` without an index names the current card: give it the
    index, so that one card is one device however it was named."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_comet_mesh(n_pf: int = 1, n_pv: int = 1, n_pr: int = 1,
                    devices=None) -> CometMesh:
    """The first ``n_pf * n_pv * n_pr`` of ``devices`` as a comet mesh, in
    ``repro``'s order (pf slowest, pr fastest).  ``devices=None`` means the
    visible CUDA cards; a device may repeat."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [physical_device(torch.device(d)) for d in devices]
    need = n_pf * n_pv * n_pr
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return CometMesh(arr.reshape(n_pf, n_pv, n_pr))


def comet_mesh_from_production(mesh, n_pf: int = 1) -> CometMesh:
    """Reshape a production ``DeviceMesh``'s ranks, ("data", "model") or
    ("pod", "data", "model"), into the comet axes as ``repro`` does: pv <-
    (pod x) data, and model splits into pf x pr.  ``ranks`` holds the
    arrangement; a rank's device is its card (``cuda:<rank>``, one host) or
    the mesh's device type."""
    ranks = mesh.mesh.cpu().numpy()  # (data, model) or (pod, data, model)
    if ranks.ndim == 3:
        ranks = ranks.reshape(-1, ranks.shape[-1])  # fold pod into data
    n_pv, n_model = ranks.shape
    if n_model % n_pf:
        raise ValueError(f"n_pf={n_pf} does not divide the model axis ({n_model})")
    n_pr = n_model // n_pf
    arr = ranks.reshape(n_pv, n_pf, n_pr).transpose(1, 0, 2)
    devices = np.empty(arr.shape, dtype=object)
    for idx, r in np.ndenumerate(arr):
        devices[idx] = (torch.device("cuda", int(r)) if mesh.device_type == "cuda"
                        else torch.device(mesh.device_type))
    return CometMesh(devices, ranks=arr)
