"""repro_torch.stream — out-of-core streaming campaigns.

The port of ``repro.stream``: disk -> pinned host -> card streaming over a
``repro_torch.store`` dataset's field shards.  ``StreamPlan`` chunks the
packed byte axis, ``ShardPrefetcher`` stages the next chunk from the shard
mmaps while the card contracts the current one, and the cross-shard merge
epilogue in ``pipeline`` folds the per-chunk fp32 numerator and stat
partials, accumulated on the card, into outputs bit-identical to an
in-memory campaign.  Peak host payload memory is the staging buffers,
bounded by ``CometConfig.max_host_bytes``, never the dataset size.
"""
from repro_torch.stream.pipeline import (  # noqa: F401
    stream_threeway,
    stream_threeway_batched,
    stream_twoway,
    stream_twoway_batched,
    stream_twoway_delta,
)
from repro_torch.stream.plan import StreamChunk, StreamPlan, fill_chunk  # noqa: F401
from repro_torch.stream.prefetch import ShardPrefetcher  # noqa: F401

__all__ = [
    "StreamPlan",
    "StreamChunk",
    "fill_chunk",
    "ShardPrefetcher",
    "stream_twoway",
    "stream_threeway",
    "stream_twoway_batched",
    "stream_threeway_batched",
    "stream_twoway_delta",
]
