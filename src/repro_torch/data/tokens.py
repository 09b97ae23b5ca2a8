"""Synthetic LM token pipeline (``repro.data.tokens``): deterministic,
shard-aware, prefetched.

Every batch is a pure function of (seed, step, shard), so a restart
resumes bit-identically from a checkpointed step with no data state to
persist, and each data-parallel host draws only its own slice.  The draws
are ``repro``'s numpy calls in ``repro``'s order, so ``batch_at(step)``
equals ``repro``'s bit for bit in every family.  Batches stay numpy; the
trainer moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticTokens:
    vocab_size: int
    batch: int  # global batch
    seq_len: int
    seed: int = 0
    shard: int = 0  # this host's data shard
    num_shards: int = 1
    family: str = "dense"  # encdec / vlm need extra fields
    d_model: int = 0

    @property
    def local_batch(self) -> int:
        if self.batch % self.num_shards:
            raise ValueError(f"batch {self.batch} is not a multiple of "
                             f"num_shards {self.num_shards}")
        return self.batch // self.num_shards

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (this shard's slice)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.shard]))
        B, S = self.local_batch, self.seq_len
        # zipf-flavoured token distribution, avoiding id 0 (pad)
        z = rng.zipf(1.3, size=(B, S + 1))
        toks = (z % (self.vocab_size - 1)) + 1
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.family == "encdec":
            out["src_embeds"] = rng.standard_normal((B, S, self.d_model),
                                                    dtype=np.float32) * 0.02
        if self.family == "vlm":
            out["embeds"] = rng.standard_normal((B, S, self.d_model),
                                                dtype=np.float32) * 0.02
            out.pop("tokens")
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch (a depth-k queue) over a batch source;
    ``next`` gives ``(step, batch)`` from ``start_step`` on.  ``close``
    stops the thread."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
