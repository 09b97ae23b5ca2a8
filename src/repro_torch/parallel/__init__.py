"""Decompositions over several ranks: the comet mesh and its ring
(``repro.parallel``'s counterpart, one controller for every rank)."""
from repro_torch.parallel.mesh import COMET_AXES, CometMesh, make_comet_mesh

__all__ = ["COMET_AXES", "CometMesh", "make_comet_mesh"]
