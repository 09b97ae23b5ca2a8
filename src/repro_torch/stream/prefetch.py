"""ShardPrefetcher — background double-buffered staging loader.

The port of ``repro.stream.prefetch``.  The streaming pipeline's
I/O half: a single worker thread fills reusable staging buffers one chunk
ahead of the consumer, so chunk ``s+1``'s disk reads (mmap page faults and
the copy into the staging buffer) overlap chunk ``s``'s copy to the card
and its kernels.

Buffer discipline is a free-queue / ready-queue pair (no modulo-index
races): the worker takes an empty buffer from the free queue, fills it,
and posts it on the ready queue; the consumer iterates ``(index, buffer)``
pairs and MUST hand each buffer back via ``release()`` once nothing reads
it any more (on the card: once its host-to-device copy has completed).
With two buffers the worker is therefore never more than one chunk ahead,
which bounds peak host bytes at exactly ``StreamPlan.peak_host_bytes``.

Overlap accounting (two clock reads per chunk): ``stage_seconds`` is worker
time spent inside ``fill`` and ``stall_seconds`` is consumer time blocked
on the ready queue; ``meta["stream"]`` records both.

Tracing: each fill is a ``prefetch-stage`` span on the worker thread; the
creating context is carried into the worker (``contextvars.copy_context()``,
only while tracing), so the spans nest under the campaign's.

Error handling is symmetrical and leak-free:

* a ``fill`` exception is captured, posted on the ready queue, and
  re-raised in the consumer thread on its next iteration;
* consumer-side exceptions unwind through ``__exit__``, which unblocks and
  joins the worker; no thread outlives the ``with`` block either way.
"""
from __future__ import annotations

import contextvars
import queue
import threading
import time

from repro_torch.obs import trace as obs

__all__ = ["ShardPrefetcher"]

_DONE = object()  # worker finished every item
_STOP = object()  # consumer shut down; unblocks a worker waiting on free_q


class _WorkerError:
    def __init__(self, exc):
        self.exc = exc


class ShardPrefetcher:
    """Iterate ``(index, buffer)`` with the fills running one item ahead.

    ``fill(index, buffer)`` stages item ``index`` into ``buffer`` in place;
    ``buffers`` is the reusable staging pool (usually two buffers of one
    chunk each).  Use as a context manager::

        with ShardPrefetcher(fill, n_items, buffers) as pf:
            for idx, buf in pf:
                consume(buf)
                pf.release(buf)

    After (or during) iteration, ``pf.stage_seconds`` / ``pf.stall_seconds``
    report worker fill time and consumer ready-queue wait time.
    """

    def __init__(self, fill, n_items: int, buffers):
        if not buffers:
            raise ValueError("need at least one staging buffer")
        self._fill = fill
        self._n_items = n_items
        self._free = queue.Queue()
        for buf in buffers:
            self._free.put(buf)
        self._ready = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="repro_torch-stream-prefetch", daemon=True
        )
        self._started = False
        self.stage_seconds = 0.0  # written by the worker thread only
        self.stall_seconds = 0.0  # written by the consumer thread only
        # Carry the creating context's open-span stack into the worker so
        # staging spans nest under the campaign span (tracing only).
        self._ctx = contextvars.copy_context() if obs.enabled() else None

    # -- worker -------------------------------------------------------------

    def _run(self):
        if self._ctx is not None:
            self._ctx.run(self._run_inner)
        else:
            self._run_inner()

    def _run_inner(self):
        try:
            for idx in range(self._n_items):
                buf = self._free.get()
                if buf is _STOP or self._stop.is_set():
                    return
                t0 = time.perf_counter()
                with obs.span("prefetch-stage") as sp:
                    self._fill(idx, buf)
                    sp.add(chunk=idx)
                self.stage_seconds += time.perf_counter() - t0
                self._ready.put((idx, buf))
        except BaseException as exc:  # propagated to the consumer
            self._ready.put(_WorkerError(exc))
        else:
            self._ready.put(_DONE)

    # -- consumer -----------------------------------------------------------

    def __enter__(self):
        self._thread.start()
        self._started = True
        return self

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            item = self._ready.get()
            self.stall_seconds += time.perf_counter() - t0
            if item is _DONE:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item

    def release(self, buf) -> None:
        """Return a consumed buffer to the pool (the worker may refill it)."""
        self._free.put(buf)

    def close(self) -> None:
        """Stop the worker and join it (idempotent; never leaks a thread)."""
        self._stop.set()
        self._free.put(_STOP)  # unblock a worker waiting for a buffer
        if self._started:
            self._thread.join()

    def __exit__(self, *exc_info):
        self.close()
        return False
