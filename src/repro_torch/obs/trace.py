"""Span-based tracing + the :class:`Telemetry` facade of the port.

PyTorch port's copy of ``repro/obs/trace.py``. A *span* is one timed
region of the request path. Spans nest through a per-thread stack: while
a **root** span (a serve tile, a flush, a maintenance op) is open, every
nested stage span that finishes on the same thread both records its
duration into the shared ``sivf_stage_seconds{stage=...}`` histogram
*and* adds to the root's per-stage breakdown, which is what lets a
slow-query-log entry say "23 ms total: 1 ms plan, 19 ms prefetch, 3 ms
scan".

A Telemetry records while it is ``enabled`` **or** while a
``torch.profiler`` session records (:attr:`Telemetry.recording`):
profiling the process traces SIVF's stages, with no setting of its own.
Off, every entry point returns after that one check: no clock read, no
CUDA event, no allocation.

Spans time the host: a stage that only launches device work ends when
the launch returns. A span opened with ``device=`` a CUDA device also
records a CUDA event pair on that device's current stream, and its
``device_ms`` is the stage's time on the stream, gaps included. The
events come from a pool and are resolved without a synchronise on the
hot path: those already complete by ``query()`` when a root span closes,
the rest by one synchronise in :meth:`Telemetry.spans`.

Every finished span is kept in a bounded in-memory log (the last
:data:`SPAN_LOG_SIZE`, read by :meth:`Telemetry.spans`): its name, id,
parent and root ids, attributes, ``t0_ns`` / ``t1_ns`` on
``time.perf_counter_ns()`` (whatever ``clock`` the histogram reads) and
``device_ms`` (``None`` for a host-only span or off CUDA). A device trace
of the same process joins it through one clock offset.

:class:`Telemetry` bundles what one handle needs: a
:class:`~repro_torch.obs.metrics.MetricsRegistry`, the span tracer and
its log, and the rolling slow-query log (the N slowest root spans over a
threshold, with their stage breakdown and tenant / filter / epoch
attributes).

Usage::

    tel = Telemetry(enabled=True, slow_threshold_s=0.010)
    with tel.span("serve.search", root=True, tenant="app", epoch=3):
        with tel.span("plan"):
            ...
        with tel.span("scan", device=torch.device("cuda")):
            ...
    tel.snapshot()            # JSON-able dict (metrics + slow queries)
    tel.render_prometheus()   # Prometheus text exposition
    tel.spans()               # {"spans": [record, ...], "wrapped": False}
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch.obs.metrics import MetricsRegistry

STAGE_HISTOGRAM = "sivf_stage_seconds"

# finished spans kept for spans(): a traced 51-s search window on one
# H100 finishes up to about 55,000 (six a PQ search call)
SPAN_LOG_SIZE = 1 << 17


class Span:
    """One timed region; produced by :meth:`Telemetry.span` /
    :meth:`Telemetry.open_span`. ``stages`` accumulates nested spans'
    durations (root spans only, by stage name). ``id``, ``parent`` and
    ``root_id`` place it in its tree: ``parent`` is the span open on the
    thread when it began (``None`` at the top), ``root_id`` the id of the
    tree's top span (one request)."""

    __slots__ = ("name", "root", "attrs", "t0", "t1", "stages", "_tel",
                 "id", "parent", "root_id", "t0_ns", "t1_ns", "device_ms",
                 "_events")

    def __init__(self, tel: "Telemetry", name: str, root: bool,
                 attrs: dict, t0: float):
        self._tel = tel
        self.name = name
        self.root = root
        self.attrs = attrs
        self.t0 = t0
        self.t1: float | None = None
        self.stages: dict[str, float] = {}
        self.id = next(tel._ids)
        st = tel._stack()
        if st:
            self.parent, self.root_id = st[-1].id, st[-1].root_id
        else:
            self.parent, self.root_id = None, self.id
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns: int | None = None
        self.device_ms: float | None = None
        self._events = None

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None
                else self._tel._clock()) - self.t0

    def add_stage(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    def record(self) -> dict:
        """The span as :meth:`Telemetry.spans` reports it."""
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "root": self.root_id, "t0_ns": self.t0_ns,
                "t1_ns": self.t1_ns, "attrs": dict(self.attrs),
                "device_ms": self.device_ms}

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, root={self.root}, "
                f"dur={self.duration_s * 1e3:.3f}ms, stages="
                f"{sorted(self.stages)})")


class _NoopSpan:
    """Shared do-nothing context manager for the off fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add_stage(self, stage, seconds):
        pass


_NOOP = _NoopSpan()


class _Off:
    """Stands in for a Telemetry where a function was given none: never
    records."""

    __slots__ = ()
    recording = False

    def span(self, *args, **kwargs):
        return _NOOP


OFF = _Off()


class _SpanCtx:
    """Context manager binding one live span to the thread's stack (and,
    with a CUDA ``dev``, timing it on that device's current stream)."""

    __slots__ = ("_tel", "_span", "_dev")

    def __init__(self, tel: "Telemetry", span: Span, dev=None):
        self._tel = tel
        self._span = span
        self._dev = dev

    def __enter__(self) -> Span:
        self._tel._push(self._span)
        if self._dev is not None:
            self._span._events = self._tel._record_start(self._dev)
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._dev is not None:
            self._tel._record_end(self._span, self._dev)
        self._tel._pop(self._span)
        self._tel.finish_span(self._span)
        return False


class Telemetry:
    """Per-process (or per-handle) observability hub.

    Parameters
    ----------
    enabled:          master switch; flip :attr:`enabled` at runtime to
                      start/stop recording (the smoke's serve.load toggles
                      it between runs). Off, the handle still records
                      while a ``torch.profiler`` session does
                      (:attr:`recording`).
    slow_threshold_s: root spans at least this long enter the slow-query
                      log (0 logs every root span — tests use that).
    slow_log_size:    the log keeps the N slowest qualifying spans seen
                      since the last :meth:`clear_slow_log`.
    clock:            injectable monotonic clock for deterministic tests
                      (the span log's ``t0_ns`` / ``t1_ns`` always read
                      ``time.perf_counter_ns``).
    """

    def __init__(self, enabled: bool = True,
                 slow_threshold_s: float = 0.050,
                 slow_log_size: int = 32, clock=time.perf_counter):
        self.enabled = bool(enabled)
        self.slow_threshold_s = float(slow_threshold_s)
        self.slow_log_size = int(slow_log_size)
        self._clock = clock
        self.registry = MetricsRegistry()
        self._stage_hist = self.registry.histogram(
            STAGE_HISTOGRAM, "wall seconds per pipeline stage", ("stage",))
        self._slow_counter = self.registry.counter(
            "sivf_slow_queries_total",
            "root spans over the slow-query threshold")
        self._local = threading.local()
        self._slow_lock = threading.Lock()
        self._slow: list[dict] = []
        self._ids = itertools.count(1)
        self._log: collections.deque = collections.deque(
            maxlen=SPAN_LOG_SIZE)
        self._wrapped = False
        # device-timed spans whose end event may not have completed, in
        # the order they ended (appended lock-free, resolved under the
        # lock); events to reuse, by device index
        self._ev_lock = threading.Lock()
        self._unresolved: collections.deque = collections.deque()
        self._event_pool: dict[int, list] = {}

    @property
    def recording(self) -> bool:
        """True while :attr:`enabled` or while a ``torch.profiler`` session
        records (the flag PyTorch keeps for fast Python checks)."""
        return self.enabled or _autograd_profiler._is_profiler_enabled

    # -- span API ------------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()

    def span(self, name: str, root: bool | str = False, device=None,
             **attrs):
        """Context manager timing one region. Non-root spans feed the
        innermost enclosing root span's stage breakdown; root spans are
        slow-query-log candidates. ``root="auto"`` makes the span a root
        only when no root is already open on this thread (a directly-used
        Index.search is a root; the same call under a serve tile is a
        stage). ``device``: a ``torch.device`` whose current stream also
        times the region when it is a CUDA device (``device_ms``). No-op
        unless :attr:`recording`."""
        if not self.recording:
            return _NOOP
        if root == "auto":
            root = self._enclosing_root() is None
        dev = device if device is not None and device.type == "cuda" \
            else None
        return _SpanCtx(self, Span(self, name, bool(root), attrs,
                                   self._clock()), dev)

    def open_span(self, name: str, root: bool = True, **attrs
                  ) -> "Span | None":
        """Begin a span whose end is *not* lexically scoped (e.g. a serve
        tile: dispatched now, completed at result resolution). Pushes it
        on this thread's stack; call :meth:`exit_scope` when the region
        that spawns nested stages ends, then :meth:`finish_span` when the
        span's real end time arrives. Returns ``None`` unless
        :attr:`recording`."""
        if not self.recording:
            return None
        sp = Span(self, name, root, attrs, self._clock())
        self._push(sp)
        return sp

    def exit_scope(self, span: "Span | None") -> None:
        """Remove an :meth:`open_span` from the nesting stack without
        recording it (its duration keeps running)."""
        if span is not None:
            self._pop(span)

    def finish_span(self, span: "Span | None", t1: float | None = None
                    ) -> None:
        """Record a span: stage histogram, root bookkeeping (slow log) and
        the span log; a root also resolves the device times that are
        ready."""
        if span is None or not self.recording:
            return
        span.t1 = self._clock() if t1 is None else t1
        span.t1_ns = time.perf_counter_ns()
        dur = span.t1 - span.t0
        self._stage_hist.observe(dur, stage=span.name)
        root = self._enclosing_root()
        if root is not None and root is not span:
            root.add_stage(span.name, dur)
        if span.root and dur >= self.slow_threshold_s:
            self._log_slow(span, dur)
        if len(self._log) == self._log.maxlen:
            self._wrapped = True
        self._log.append(span)
        if span.root and self._unresolved:
            self._resolve(wait=False)

    def _enclosing_root(self) -> "Span | None":
        for sp in reversed(self._stack()):
            if sp.root:
                return sp
        return None

    def record_duration(self, stage: str, seconds: float,
                        attach: bool = True) -> None:
        """Record a pre-measured duration as if a span ran (queue waits
        are measured from request timestamps, not a context manager)."""
        if not self.recording:
            return
        self._stage_hist.observe(seconds, stage=stage)
        if attach:
            root = self._enclosing_root()
            if root is not None:
                root.add_stage(stage, seconds)

    def traced(self, name: str, root: bool = False):
        """Decorator form of :meth:`span`."""
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(name, root=root):
                    return fn(*a, **kw)
            return wrapper
        return deco

    # -- device time ---------------------------------------------------------

    def _record_start(self, dev) -> tuple:
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        pool = self._event_pool.setdefault(idx, [])
        evs = []
        for _ in range(2):
            try:
                evs.append(pool.pop())
            except IndexError:
                evs.append(torch.cuda.Event(enable_timing=True))
        stream = torch.cuda.current_stream(idx)
        evs[0].record(stream)
        return idx, stream, evs[0], evs[1]

    def _record_end(self, span: Span, dev) -> None:
        _, stream, _, end = span._events
        end.record(stream)
        self._unresolved.append(span)

    def _resolve(self, wait: bool) -> None:
        """Set ``device_ms`` of the device-timed spans whose end event has
        completed, oldest first (all of them after a synchronise of their
        devices when ``wait``), and return their events to the pool."""
        with self._ev_lock:
            if wait:
                for idx in {sp._events[0] for sp in self._unresolved}:
                    torch.cuda.synchronize(idx)
            while self._unresolved:
                sp = self._unresolved[0]
                idx, _, start, end = sp._events
                if not wait and not end.query():
                    break
                sp.device_ms = start.elapsed_time(end)
                sp._events = None
                self._event_pool[idx].extend((start, end))
                self._unresolved.popleft()

    def spans(self) -> dict:
        """The span log: ``{"spans": [record, ...], "wrapped": bool}``, the
        records in the order the spans finished (children before their
        parent), ``wrapped`` true when older spans were dropped. Each
        record: ``name``, ``id``, ``parent``, ``root``, ``t0_ns``,
        ``t1_ns`` (``time.perf_counter_ns``), ``attrs``, ``device_ms``.
        Device times not yet resolved are waited for here."""
        if self._unresolved:
            self._resolve(wait=True)
        return {"spans": [sp.record() for sp in list(self._log)],
                "wrapped": self._wrapped}

    # -- slow-query log ------------------------------------------------------

    def _log_slow(self, span: Span, dur: float) -> None:
        self._slow_counter.inc()
        entry = {
            "span": span.name,
            "duration_ms": round(dur * 1e3, 3),
            "stages_ms": {k: round(v * 1e3, 3)
                          for k, v in sorted(span.stages.items())},
            "t_wall": time.time(),
        }
        entry.update({k: v for k, v in span.attrs.items()
                      if v is not None})
        with self._slow_lock:
            self._slow.append(entry)
            if len(self._slow) > self.slow_log_size:
                self._slow.sort(key=lambda e: -e["duration_ms"])
                del self._slow[self.slow_log_size:]

    def slow_queries(self) -> list[dict]:
        """The current slow-query log, slowest first."""
        with self._slow_lock:
            return sorted(self._slow, key=lambda e: -e["duration_ms"])

    def clear_slow_log(self) -> None:
        with self._slow_lock:
            self._slow.clear()

    # -- metric passthrough --------------------------------------------------

    def counter(self, name, help="", labels=()):
        return self.registry.counter(name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self.registry.gauge(name, help, labels)

    def histogram(self, name, help="", labels=(), **kw):
        return self.registry.histogram(name, help, labels, **kw)

    def roll_window(self) -> None:
        self.registry.roll_window()

    # -- exporters -----------------------------------------------------------

    def snapshot(self) -> dict:
        from repro_torch.obs.export import snapshot
        return snapshot(self)

    def render_prometheus(self) -> str:
        from repro_torch.obs.export import render_prometheus
        return render_prometheus(self)
