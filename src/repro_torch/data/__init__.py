"""Data pipelines, as ``repro.data``: uses of the similarity engine
(``dedup``) and the synthetic LM token source of training (``tokens``)."""
from repro_torch.data.dedup import count_profiles, find_near_duplicates  # noqa: F401
from repro_torch.data.tokens import PrefetchIterator, SyntheticTokens  # noqa: F401
