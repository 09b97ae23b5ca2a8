from .kernel import (  # noqa: F401
    metric2_pop,
    metric2_pop_plain,
    metric2_pop_tri,
    metric2_pop_tri_plain,
    threeway_batch_pop,
    threeway_batch_pop_plain,
)
from .ops import pop_planes  # noqa: F401
