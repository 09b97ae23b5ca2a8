"""Thread-aware span tracer with zero overhead when disabled.

The port of ``repro.obs.trace``: the same names, events, output and errors.

* **Disabled is free.**  The module-global ``_tracer`` is ``None`` by
  default and ``span()`` returns ONE shared no-op singleton: a traced call
  site costs a global read and an ``is None`` branch, with no allocation,
  no lock and no clock read.  The engines therefore leave their span calls
  in place; campaign checksums and untraced timings are untouched unless a
  tracer is installed.

* **Thread-aware.**  Events carry ``threading.get_ident()`` as the Chrome
  ``tid``; span nesting is tracked in a ``contextvars.ContextVar`` so
  callers that hop threads (``ShardPrefetcher``'s staging worker,
  ``SimilarityService``'s campaign workers) carry their logical parent
  across via ``contextvars.copy_context()``: the B event records the
  parent path in ``args["parent"]``.

* **Chrome trace-event output.**  ``Tracer.chrome_trace()`` emits strictly
  matched B/E duration pairs (ts in microseconds, monotonic clock) that
  load directly in Perfetto / ``chrome://tracing``;
  ``validate_chrome_trace`` is the stdlib-only schema checker.

* **Device time.**  Wall time around launches on the card measures the
  enqueue, not the kernels; ``fence(x)`` synchronizes the device of a CUDA
  tensor (only while tracing), so a span closed after a fence reads device
  time.  With tracing off the fence is a no-op and launches stay
  asynchronous.

The roofline bound of a span's launches is ``repro_torch.obs.roofline``'s
(the port has no compiled program to price, so it counts each launch).
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time

__all__ = [
    "Tracer",
    "aggregate_phases",
    "current_path",
    "disable",
    "enable",
    "enabled",
    "fence",
    "format_phase_table",
    "get_tracer",
    "span",
    "validate_chrome_trace",
    "CANONICAL_PHASES",
]

#: Canonical campaign phases, in pipeline order.  ``format_phase_table``
#: always prints a row for each (count 0 when the phase never ran — an
#: encode row at 0 on a dataset campaign is the zero-encode proof), so
#: consumers can grep for a phase unconditionally.
CANONICAL_PHASES = (
    "validate",
    "encode",
    "prefetch-stage",
    "ring-step",
    "delta-border",
    "merge",
)

_tracer: "Tracer | None" = None  # None == disabled (the zero-overhead path)

_SPAN_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_obs_span_stack", default=()
)


class _NullSpan:
    """The shared disabled-mode span: every method is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "_attrs", "_token")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self.name = name
        self._attrs = dict(attrs) if attrs else {}

    def add(self, **attrs):
        """Attach attributes (byte counts, step counts, ...) to the span;
        they ride on the closing E event."""
        self._attrs.update(attrs)
        return self

    def __enter__(self):
        stack = _SPAN_STACK.get()
        self._token = _SPAN_STACK.set(stack + (self.name,))
        args = {"parent": "/".join(stack)} if stack else None
        self._tracer._emit("B", self.name, self._tracer._clock(), args)
        return self

    def __exit__(self, *exc):
        self._tracer._emit(
            "E", self.name, self._tracer._clock(), self._attrs or None
        )
        _SPAN_STACK.reset(self._token)
        return False


class Tracer:
    """Collects B/E trace events; install with ``enable()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events = []  # (ph, name, ts_ns, tid, args)
        self._clock = time.perf_counter_ns
        self._t0 = self._clock()

    # -- recording -----------------------------------------------------------

    def span(self, name: str, attrs: dict = None) -> _Span:
        return _Span(self, name, attrs)

    def _emit(self, ph, name, ts_ns, args):
        tid = threading.get_ident()
        with self._lock:
            self._events.append((ph, name, ts_ns, tid, args))

    def complete(self, name: str, t0_ns: int, t1_ns: int,
                 attrs: dict = None, tid: int = None) -> None:
        """Record an interval measured externally (e.g. a queue wait whose
        endpoints live in different threads) as a matched B/E pair.

        ``tid`` overrides the thread id — intervals that OVERLAP a
        thread's own spans (a queue wait that began while the worker was
        still computing the previous request) go on a virtual lane so B/E
        nesting stays well-formed per (pid, tid)."""
        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            self._events.append(("B", name, t0_ns, tid, None))
            self._events.append(("E", name, t1_ns, tid, attrs or None))

    # -- reading -------------------------------------------------------------

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self, since: int = 0) -> list:
        """Snapshot of recorded events (optionally from index ``since``)."""
        with self._lock:
            return list(self._events[since:])

    def phase_stats(self, since: int = 0) -> dict:
        return aggregate_phases(self.events(since))

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``).

        Events are sorted by timestamp; the sort is stable, so same-thread
        same-tick B/E pairs keep their recorded (correct) order.
        """
        pid = os.getpid()
        out = []
        for ph, name, ts, tid, args in sorted(
            self.events(), key=lambda e: e[2]
        ):
            ev = {
                "name": name,
                "ph": ph,
                "ts": (ts - self._t0) / 1000.0,  # ns -> microseconds
                "pid": pid,
                "tid": tid,
            }
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
            f.write("\n")


# -- module-level API (the form instrumented code calls) ----------------------


def enable(tracer: Tracer = None) -> Tracer:
    """Install (and return) the process tracer; spans record from now on."""
    global _tracer
    _tracer = tracer if tracer is not None else Tracer()
    return _tracer


def disable() -> "Tracer | None":
    """Remove the process tracer (span calls become no-ops again) and
    return it, so the caller can still export what was recorded."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> "Tracer | None":
    return _tracer


def span(name: str, attrs: dict = None):
    """Open a span: ``with span("encode", {"bytes": n}) as sp: ...``.

    Disabled, this returns the shared no-op singleton — no allocation.
    (The ``attrs`` dict literal at an instrumented call site WOULD
    allocate even when disabled; hot paths therefore pass attrs via
    ``sp.add(...)`` inside the span or not at all.)"""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, attrs)


def current_path() -> tuple:
    """The context's open-span name stack (propagates with copy_context)."""
    return _SPAN_STACK.get()


def fence(x):
    """Synchronize the device of ``x`` (a tensor, or a tuple or list of
    them, as the ranks of a decomposition give) when it is a CUDA tensor,
    each distinct device once, only while tracing, so the enclosing span
    measures device time, not launch time; returns ``x`` untouched.  A CPU
    tensor, and any call while tracing is off, costs nothing."""
    if _tracer is not None:
        done = set()
        for t in x if isinstance(x, (tuple, list)) else (x,):
            device = getattr(t, "device", None)
            if device is not None and device.type == "cuda" and device not in done:
                import torch

                done.add(device)
                torch.cuda.synchronize(device)
    return x


# -- aggregation + formatting -------------------------------------------------


def aggregate_phases(events) -> dict:
    """``{name: {"count", "seconds"}}`` from matched B/E pairs (per tid)."""
    stacks, agg = {}, {}
    for ph, name, ts, tid, _args in sorted(events, key=lambda e: e[2]):
        if ph == "B":
            stacks.setdefault(tid, []).append((name, ts))
        elif ph == "E":
            st = stacks.get(tid)
            if st and st[-1][0] == name:
                _, t0 = st.pop()
                a = agg.setdefault(name, {"count": 0, "seconds": 0.0})
                a["count"] += 1
                a["seconds"] += (ts - t0) / 1e9
    return agg


def format_phase_table(phases: dict) -> str:
    """Human-readable per-phase table (what the CLI prints after --trace).

    Every canonical phase gets a row even at count 0; extra recorded
    phases follow in name order.  Self-time is not computed — nested
    spans (a merge inside a campaign) each report their own wall time.
    """
    names = list(CANONICAL_PHASES) + sorted(
        n for n in phases if n not in CANONICAL_PHASES and n != "roofline"
    )
    total = sum(phases.get(n, {}).get("seconds", 0.0) for n in names) or 1.0
    rows = ["phase            count     seconds    share"]
    for n in names:
        p = phases.get(n, {"count": 0, "seconds": 0.0})
        rows.append(
            f"{n:<16s} {p['count']:>5d} {p['seconds']:>11.6f} "
            f"{100.0 * p['seconds'] / total:>7.1f}%"
        )
    return "\n".join(rows)


# -- stdlib-only trace-file checker (used by CI and the property test) --------


def validate_chrome_trace(payload) -> int:
    """Raise ValueError unless ``payload`` is a well-formed Chrome
    trace-event object as this tracer emits it: a ``traceEvents`` list of
    B/E events with the required fields, timestamps monotonically
    non-decreasing, and every E matching the innermost open B of the same
    name on its (pid, tid) stack.  Returns the event count."""
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise ValueError("not a Chrome trace object: missing 'traceEvents'")
    events = payload["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    last_ts = None
    stacks = {}
    for i, ev in enumerate(events):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"traceEvents[{i}] missing field {field!r}")
        if ev["ph"] not in ("B", "E"):
            raise ValueError(
                f"traceEvents[{i}] phase {ev['ph']!r} is not 'B'/'E'"
            )
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"traceEvents[{i}].ts must be a number")
        if last_ts is not None and ev["ts"] < last_ts:
            raise ValueError(
                f"traceEvents[{i}].ts {ev['ts']} < previous {last_ts} "
                "(timestamps must be monotonic)"
            )
        last_ts = ev["ts"]
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            stacks.setdefault(key, []).append(ev["name"])
        else:
            st = stacks.get(key)
            if not st or st[-1] != ev["name"]:
                raise ValueError(
                    f"traceEvents[{i}]: E {ev['name']!r} does not match "
                    f"open B {st[-1] if st else None!r} on {key}"
                )
            st.pop()
    dangling = {k: v for k, v in stacks.items() if v}
    if dangling:
        raise ValueError(f"unclosed B events: {dangling}")
    return len(events)
