from .kernel import (  # noqa: F401
    LEVELS_WINDOW,
    levels_count_planes,
    metric2_levels,
    metric2_levels_tri,
    mgemm_levels,
    plane_rect_plain,
    plane_rect_words,
    plane_tri_plain,
)
from .ops import (  # noqa: F401
    mgemm_levels_planes,
    mgemm_levels_planes_xla,
    mgemm_levels_xla,
)
from .planes import (  # noqa: F401
    POPCOUNT,
    PackedPlanes,
    decode_bitplanes,
    encode_bitplanes,
    encode_bitplanes_np,
    pad_planes,
    plane_popcounts,
    planes_nbytes,
    shard_planes_fields,
    slice_planes_vectors,
    take_planes_vectors,
    values_from_planes,
)
