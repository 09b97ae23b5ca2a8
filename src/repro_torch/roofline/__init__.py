"""The dry-run's roofline: per-device counts of an eager step
(``counts``) and their three-term H100 roofline (``analysis``), the
counterparts of ``repro.roofline``."""
from repro_torch.roofline.analysis import HW_H100, analyze  # noqa: F401
