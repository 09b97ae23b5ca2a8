"""Public wrappers of the min-plus kernels and the ``impl="pallas"``
registration, as ``repro.kernels.mgemm.ops``: ``mgemm`` (row 1) is the
registered ``impl="pallas"`` contraction; ``metric2_tiles`` /
``czek2_metric`` (row 2) and ``metric2_tri`` (row 3) are the fused metric
kernels the ``TileExecutor`` calls."""
from __future__ import annotations

from repro_torch.core.mgemm import register_impl

from .kernel import czek2_metric, metric2_tiles, metric2_tri, mgemm

__all__ = ["mgemm", "czek2_metric", "metric2_tiles", "metric2_tri"]

register_impl("pallas", mgemm)
