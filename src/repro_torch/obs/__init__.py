"""repro_torch.obs — telemetry of the port (counterpart of ``repro/obs``).

Three pieces, plain Python and numpy (the tracer reads torch's profiler
flag and times device stages with CUDA events):

  * :mod:`repro_torch.obs.metrics` — Counter / Gauge / Histogram registry
    with label sets, fixed log2 latency buckets, windowed + cumulative
    counter reads, and the shared percentile helpers.
  * :mod:`repro_torch.obs.trace`   — span-based tracing
    (``Telemetry.span()``), per-stage histograms, the slow-query log,
    the span log (``Telemetry.spans()``) with device-timed stages.
  * :mod:`repro_torch.obs.export`  — Prometheus text renderer + JSON
    snapshot.

A process-wide default :class:`Telemetry` (disabled, the no-op fast
path, until :func:`enable` is called or while ``torch.profiler``
records) backs ``sivf_torch.telemetry``; handles (``Index``,
``ServeEngine``) use it unless given their own.
"""
from __future__ import annotations

from repro_torch.obs.export import (parse_prometheus, render_prometheus,
                                    snapshot, snapshot_json)
from repro_torch.obs.metrics import (BUCKETS_S, Counter, Gauge, Histogram,
                                     MetricsRegistry, WindowedCounter,
                                     latency_summary_ms, percentiles)
from repro_torch.obs.trace import Span, Telemetry

_default = Telemetry(enabled=False)


def default() -> Telemetry:
    """The process-wide default Telemetry (shared by every handle that
    wasn't constructed with an explicit ``telemetry=``)."""
    return _default


def enable(slow_threshold_s: float | None = None,
           slow_log_size: int | None = None) -> Telemetry:
    """Switch the default Telemetry on (optionally retuning the
    slow-query log) and return it."""
    if slow_threshold_s is not None:
        _default.slow_threshold_s = float(slow_threshold_s)
    if slow_log_size is not None:
        _default.slow_log_size = int(slow_log_size)
    _default.enabled = True
    return _default


def disable() -> Telemetry:
    """Switch the default Telemetry off (recorded data is kept)."""
    _default.enabled = False
    return _default


__all__ = [
    "BUCKETS_S", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Telemetry", "WindowedCounter", "default", "disable",
    "enable", "latency_summary_ms", "parse_prometheus", "percentiles",
    "render_prometheus", "snapshot", "snapshot_json",
]
