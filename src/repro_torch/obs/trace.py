"""Span-based tracing + the :class:`Telemetry` facade of the port.

PyTorch port's copy of ``repro/obs/trace.py``. A *span* is one timed
region of the request path. Spans nest through a per-thread stack: while
a **root** span (a serve tile, a flush, a maintenance op) is open, every
nested stage span that finishes on the same thread both records its
duration into the shared ``sivf_stage_seconds{stage=...}`` histogram
*and* adds to the root's per-stage breakdown, which is what lets a
slow-query-log entry say "23 ms total: 1 ms plan, 19 ms prefetch, 3 ms
scan".

Spans time the host: a stage that only launches device work ends when
the launch returns, and the device time lands in whichever later stage
waits for it (``prefetch``'s read of the reference counts, a serve
tile's copy of its results to the host).

:class:`Telemetry` bundles what one handle needs: a
:class:`~repro_torch.obs.metrics.MetricsRegistry`, the span tracer and
the rolling slow-query log (the N slowest root spans over a threshold,
with their stage breakdown and tenant / filter / epoch attributes). With
``enabled=False`` (the process default) ``span()`` returns a shared
no-op context manager and every recording method returns after one
attribute check.

Usage::

    tel = Telemetry(enabled=True, slow_threshold_s=0.010)
    with tel.span("serve.search", root=True, tenant="app", epoch=3):
        with tel.span("plan"):
            ...
        with tel.span("scan"):
            ...
    tel.snapshot()            # JSON-able dict (metrics + slow queries)
    tel.render_prometheus()   # Prometheus text exposition
"""
from __future__ import annotations

import functools
import threading
import time

from repro_torch.obs.metrics import MetricsRegistry

STAGE_HISTOGRAM = "sivf_stage_seconds"


class Span:
    """One timed region; produced by :meth:`Telemetry.span` /
    :meth:`Telemetry.open_span`. ``stages`` accumulates nested spans'
    durations (root spans only, by stage name)."""

    __slots__ = ("name", "root", "attrs", "t0", "t1", "stages", "_tel")

    def __init__(self, tel: "Telemetry", name: str, root: bool,
                 attrs: dict, t0: float):
        self._tel = tel
        self.name = name
        self.root = root
        self.attrs = attrs
        self.t0 = t0
        self.t1: float | None = None
        self.stages: dict[str, float] = {}

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None
                else self._tel._clock()) - self.t0

    def add_stage(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, root={self.root}, "
                f"dur={self.duration_s * 1e3:.3f}ms, stages="
                f"{sorted(self.stages)})")


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add_stage(self, stage, seconds):
        pass


_NOOP = _NoopSpan()


class _SpanCtx:
    """Context manager binding one live span to the thread's stack."""

    __slots__ = ("_tel", "_span")

    def __init__(self, tel: "Telemetry", span: Span):
        self._tel = tel
        self._span = span

    def __enter__(self) -> Span:
        self._tel._push(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        self._tel._pop(self._span)
        self._tel.finish_span(self._span)
        return False


class Telemetry:
    """Per-process (or per-handle) observability hub.

    Parameters
    ----------
    enabled:          master switch. Disabled, every entry point is a
                      single-attribute-check no-op; flip
                      :attr:`enabled` at runtime to start/stop recording
                      (the smoke's serve.load toggles it between runs).
    slow_threshold_s: root spans at least this long enter the slow-query
                      log (0 logs every root span — tests use that).
    slow_log_size:    the log keeps the N slowest qualifying spans seen
                      since the last :meth:`clear_slow_log`.
    clock:            injectable monotonic clock for deterministic tests.
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

    def span(self, name: str, root: bool | str = False, **attrs):
        """Context manager timing one region. Non-root spans feed the
        innermost enclosing root span's stage breakdown; root spans are
        slow-query-log candidates. ``root="auto"`` makes the span a root
        only when no root is already open on this thread (a directly-used
        Index.search is a root; the same call under a serve tile is a
        stage). No-op when disabled."""
        if not self.enabled:
            return _NOOP
        if root == "auto":
            root = self._enclosing_root() is None
        return _SpanCtx(self, Span(self, name, bool(root), attrs,
                                   self._clock()))

    def open_span(self, name: str, root: bool = True, **attrs
                  ) -> "Span | None":
        """Begin a span whose end is *not* lexically scoped (e.g. a serve
        tile: dispatched now, completed at result resolution). Pushes it
        on this thread's stack; call :meth:`exit_scope` when the region
        that spawns nested stages ends, then :meth:`finish_span` when the
        span's real end time arrives. Returns ``None`` when disabled."""
        if not self.enabled:
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
        """Record a span: stage histogram + root bookkeeping (slow log)."""
        if span is None or not self.enabled:
            return
        span.t1 = self._clock() if t1 is None else t1
        dur = span.t1 - span.t0
        self._stage_hist.observe(dur, stage=span.name)
        root = self._enclosing_root()
        if root is not None and root is not span:
            root.add_stage(span.name, dur)
        if span.root and dur >= self.slow_threshold_s:
            self._log_slow(span, dur)

    def _enclosing_root(self) -> "Span | None":
        for sp in reversed(self._stack()):
            if sp.root:
                return sp
        return None

    def record_duration(self, stage: str, seconds: float,
                        attach: bool = True) -> None:
        """Record a pre-measured duration as if a span ran (queue waits
        are measured from request timestamps, not a context manager)."""
        if not self.enabled:
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
