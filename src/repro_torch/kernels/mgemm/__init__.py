from .kernel import (  # noqa: F401
    BT,
    czek2_metric,
    metric2_tiles,
    metric2_tiles_plain,
    metric2_tri,
    metric2_tri_plain,
    mgemm,
    tri_tile_coords,
    unpack_tri_tiles,
)
