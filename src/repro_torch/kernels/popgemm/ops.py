"""Raw form of the rectangular popcount kernel.

No ``register_impl`` here, as in ``repro``: popcount is the ``levels == 1``
specialization of ``impl="levels"``, chosen by the ``TileExecutor``."""
from __future__ import annotations

import torch

from .kernel import metric2_pop

__all__ = ["pop_planes"]


def pop_planes(Pa, Pb):
    """Raw ``popcount(Pa AND Pb)`` numerator (row 7): the 3-way pairwise
    terms under ``impl="levels"``, ``levels == 1``.  Zero stats and no
    epilogue, as ``repro``'s ``pop_planes`` -> (m, n) fp32."""
    za = torch.zeros((Pa.shape[2],), dtype=torch.float32, device=Pa.device)
    zb = torch.zeros((Pb.shape[2],), dtype=torch.float32, device=Pb.device)
    return metric2_pop(Pa, Pb, za, zb, epilogue=None)
