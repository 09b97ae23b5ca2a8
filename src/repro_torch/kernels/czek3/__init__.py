from .kernel import plane3_plain, threeway_batch_levels  # noqa: F401
