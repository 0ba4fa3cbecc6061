"""sivf_torch.telemetry — public facade over the port's process-default
Telemetry (counterpart of ``sivf.telemetry``).

Quickstart::

    import sivf_torch.telemetry as telemetry

    telemetry.enable(slow_threshold_s=0.025)
    ...serve traffic...
    snap = telemetry.snapshot()          # JSON-able dict
    text = telemetry.render_prometheus() # text exposition for a scrape
    log = telemetry.spans()              # the span log, device times too

The default records while enabled and, disabled, while a
``torch.profiler`` session records: profiling the process traces the
index's stages.

Handles constructed with an explicit ``telemetry=`` record into their
own instance instead; ``engine.telemetry()`` / ``index.telemetry()``
snapshot whichever instance the handle uses.
"""
from __future__ import annotations

from repro_torch import obs as _obs
from repro_torch.obs import Telemetry, disable, enable

__all__ = ["Telemetry", "enable", "disable", "get", "snapshot",
           "snapshot_json", "render_prometheus", "slow_queries",
           "spans", "roll_window"]


def get() -> Telemetry:
    """The process-default :class:`Telemetry` instance."""
    return _obs.default()


def snapshot() -> dict:
    """JSON-able snapshot (metrics + slow-query log) of the default
    Telemetry."""
    return _obs.default().snapshot()


def snapshot_json(indent: int | None = None) -> str:
    return _obs.snapshot_json(_obs.default(), indent=indent)


def render_prometheus() -> str:
    """Prometheus text exposition of the default Telemetry."""
    return _obs.default().render_prometheus()


def slow_queries() -> list[dict]:
    """Current slow-query log entries, slowest first."""
    return _obs.default().slow_queries()


def spans() -> dict:
    """The default Telemetry's span log (``Telemetry.spans``):
    ``{"spans": [record, ...], "wrapped": bool}``."""
    return _obs.default().spans()


def roll_window() -> None:
    """Start a new window for every counter's windowed reads."""
    return _obs.default().roll_window()
