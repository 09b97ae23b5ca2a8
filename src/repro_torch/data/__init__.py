"""Data-pipeline uses of the similarity engine (``dedup``), as
``repro.data``; its synthetic token source belongs to the LM stack (ROADMAP
item 9b) and is not ported."""
from repro_torch.data.dedup import count_profiles, find_near_duplicates  # noqa: F401
