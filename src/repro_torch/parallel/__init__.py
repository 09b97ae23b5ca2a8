"""Decompositions over several ranks: the comet mesh and its ring (one
controller for every rank), and the LM stack's sharding rules on a
``DeviceMesh`` (``parallel.sharding``): ``repro.parallel``'s
counterparts."""
from repro_torch.parallel.mesh import (COMET_AXES, CometMesh, comet_mesh_from_production,
                                      make_comet_mesh)

__all__ = ["COMET_AXES", "CometMesh", "comet_mesh_from_production", "make_comet_mesh"]
