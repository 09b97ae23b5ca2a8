"""Data-pipeline uses of the similarity engine (``dedup``), as
``repro.data``; its synthetic token source belongs to LM training (ROADMAP
item 9b, training) and is not ported yet."""
from repro_torch.data.dedup import count_profiles, find_near_duplicates  # noqa: F401
