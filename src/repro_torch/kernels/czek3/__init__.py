from .kernel import fold_split, minplus3_plain, plane3_plain, threeway_batch_levels  # noqa: F401
from .ops import czek3_step, threeway_batch, threeway_step  # noqa: F401
