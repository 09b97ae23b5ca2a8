"""StreamPlan — the out-of-core chunk schedule over a store's byte axis.

The port of ``repro.stream.plan`` (pure Python): the geometry,
the chunk spans and every error are ``repro``'s letter for letter.

A streamed campaign never holds the full ``(levels, kb, n_v)`` payload in
host RAM.  The global byte (field) axis is cut into chunks of ``chunk_kb``
bytes; each chunk is staged into a reusable host buffer of shape
``(levels, chunk_kb, n_v_padded)`` and fed through the chunk program as if
it were the whole campaign payload.  The byte axis is the CONTRACTION axis
and zero bytes encode zero fields (inert in every plane contraction), so
the per-chunk partial numerators and partial stats simply ADD across
chunks; the cross-shard merge epilogue (``repro_torch.stream.pipeline``)
applies the metric assembly once at the end.

Geometry rules:

* ``chunk_kb`` is a multiple of ``n_pf`` so every chunk's byte axis would
  split evenly over a field decomposition (1 on one device);
* every staging buffer has the SAME shape (the tail chunk is zero-padded),
  so the buffers are allocated once and reused;
* disk shards are mmap views; a chunk may span shard-file boundaries, so
  each chunk carries explicit ``(shard, lo, hi, buf_offset)`` spans.

Host-memory accounting: double buffering stages at most two chunks at once
(one being copied to the card, one being prefetched), so

    peak_host_bytes = min(2, n_chunks) * levels * chunk_kb * n_v_padded

and ``max_host_bytes`` bounds that peak, NOT the dataset size.  When the
budget cannot fit two minimal (``chunk_kb = n_pf``) chunks the plan raises
instead of silently overshooting.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["StreamChunk", "StreamPlan", "fill_chunk"]


@dataclass(frozen=True)
class StreamChunk:
    """One staged byte range of the global payload."""

    index: int
    start: int  # global byte offset (inclusive)
    stop: int  # global byte offset (exclusive), <= plan.kb
    #: ((shard_rank, shard_lo, shard_hi, buf_offset), ...) — the mmap
    #: sub-ranges that fill this chunk's buffer (chunks may cross disk
    #: shard file boundaries)
    spans: tuple

    @property
    def nbytes_valid(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class StreamPlan:
    """Chunk schedule for one streamed campaign.

    ``kb``/``kbs``/``n_shards``/``levels`` describe the on-disk payload;
    ``n_v`` is the PADDED campaign vector count (the staging buffers carry
    the campaign geometry, so a chunk feeds the chunk program directly);
    ``n_v_data`` the true on-disk column count (columns past it stay zero).
    """

    levels: int
    kb: int  # true payload byte length (ceil(n_f / 8))
    kbs: int  # disk shard byte length (kb / n_shards)
    n_shards: int
    n_v: int  # padded campaign vector count (buffer width)
    n_v_data: int  # true dataset vector count
    n_pf: int
    chunk_kb: int
    max_host_bytes: int = 0  # 0 = unbounded (informational)

    def __post_init__(self):
        if self.chunk_kb < 1 or self.chunk_kb % self.n_pf:
            raise ValueError(
                f"chunk_kb={self.chunk_kb} must be a positive multiple of "
                f"n_pf={self.n_pf}"
            )
        if self.kb != self.kbs * self.n_shards:
            raise ValueError(
                f"kb={self.kb} != kbs={self.kbs} * n_shards={self.n_shards}"
            )

    # -- derived sizes ------------------------------------------------------

    @property
    def n_chunks(self) -> int:
        return max(1, math.ceil(self.kb / self.chunk_kb))

    @property
    def chunk_shape(self) -> tuple:
        """Static staging-buffer shape (identical for every chunk)."""
        return (self.levels, self.chunk_kb, self.n_v)

    @property
    def chunk_nbytes(self) -> int:
        return self.levels * self.chunk_kb * self.n_v

    @property
    def n_buffers(self) -> int:
        """Staging buffers allocated: 2 (double buffering), or 1 when the
        whole payload fits a single chunk."""
        return min(2, self.n_chunks)

    @property
    def peak_host_bytes(self) -> int:
        """Bound on staged payload bytes resident at once."""
        return self.n_buffers * self.chunk_nbytes

    # -- schedule -----------------------------------------------------------

    def chunks(self) -> list:
        """All chunks in stream order, with their disk-shard spans."""
        out = []
        for c in range(self.n_chunks):
            start = c * self.chunk_kb
            stop = min(start + self.chunk_kb, self.kb)
            spans = []
            g = start
            while g < stop:
                rank = g // self.kbs
                lo = g - rank * self.kbs
                hi = min(self.kbs, lo + (stop - g))
                spans.append((rank, lo, hi, g - start))
                g += hi - lo
            out.append(StreamChunk(index=c, start=start, stop=stop,
                                   spans=tuple(spans)))
        return out

    # -- construction -------------------------------------------------------

    @classmethod
    def plan(
        cls, *, levels: int, kb: int, kbs: int, n_shards: int, n_v: int,
        n_v_data: int, n_pf: int = 1, max_host_bytes: int = 0,
    ) -> "StreamPlan":
        """Pick ``chunk_kb`` for a campaign.

        Default (no budget): one disk shard per chunk, rounded up to the
        ``n_pf`` multiple — the store's shard files ARE the natural I/O
        unit.  With ``max_host_bytes``: the largest ``n_pf``-multiple chunk
        whose double-buffered staging fits the budget.
        """
        full = -(-kb // n_pf) * n_pf  # one chunk covering everything
        if max_host_bytes:
            row_bytes = levels * n_v  # host bytes per staged payload byte
            budget_kb = max_host_bytes // (2 * row_bytes)
            chunk_kb = (budget_kb // n_pf) * n_pf
            if chunk_kb < n_pf:
                need = 2 * row_bytes * n_pf
                raise ValueError(
                    f"max_host_bytes={max_host_bytes} cannot stage two "
                    f"minimal chunks (need >= {need} bytes for chunk_kb="
                    f"{n_pf} double-buffered); raise the budget or lower "
                    f"n_pf/levels"
                )
            chunk_kb = min(chunk_kb, full)
        else:
            chunk_kb = min(max(-(-kbs // n_pf) * n_pf, n_pf), full)
        return cls(
            levels=levels, kb=kb, kbs=kbs, n_shards=n_shards, n_v=n_v,
            n_v_data=n_v_data, n_pf=n_pf, chunk_kb=chunk_kb,
            max_host_bytes=max_host_bytes,
        )

    @classmethod
    def for_reader(cls, reader, *, n_v: int, n_pf: int = 1,
                   max_host_bytes: int = 0) -> "StreamPlan":
        """Plan over a ``DatasetReader``-shaped object (manifest dims)."""
        return cls.plan(
            levels=reader.levels, kb=reader.kb,
            kbs=reader.kb // reader.n_shards, n_shards=reader.n_shards,
            n_v=n_v, n_v_data=reader.n_v, n_pf=n_pf,
            max_host_bytes=max_host_bytes,
        )


def fill_chunk(buf, chunk: StreamChunk, shard_of, n_v_data: int) -> None:
    """Copy one chunk's shard spans into a staging buffer (in place).

    ``shard_of(rank)`` returns the ``(levels, kbs, n_v_data)`` shard view
    (typically an ``np.memmap``); the copy out of it is what actually
    faults the file pages in, so running this on the prefetch thread
    overlaps disk I/O with the card's work.  Bytes past the valid range
    (tail chunk) are zeroed — zero bytes encode zero fields, inert in any
    plane contraction.  Columns past ``n_v_data`` are campaign padding and
    are never written (the pipeline zeroes them once at allocation).
    """
    for rank, lo, hi, off in chunk.spans:
        buf[:, off:off + (hi - lo), :n_v_data] = shard_of(rank)[:, lo:hi, :]
    used = chunk.nbytes_valid
    if used < buf.shape[1]:
        buf[:, used:, :] = 0
