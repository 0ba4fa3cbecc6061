"""Exporters of the port: Prometheus text exposition, JSON snapshot, and
a parser for the text.

PyTorch port's copy of ``repro/obs/export.py``. Both exporters read the
same :class:`~repro_torch.obs.metrics.MetricsRegistry` under its lock, so
a scrape taken mid-workload is internally consistent.
:func:`parse_prometheus` lets a test or the smoke hold a scrape against
the snapshot series by series without a Prometheus server.

Prometheus conventions kept:

  * ``# HELP`` / ``# TYPE`` headers per family.
  * Histograms expose cumulative ``_bucket{le=...}`` series ending in
    ``le="+Inf"``, plus ``_sum`` and ``_count``.
  * Counters expose both the cumulative total and a companion
    ``<name>_window`` gauge (delta since the last
    :meth:`~repro_torch.obs.metrics.MetricsRegistry.roll_window`).
"""
from __future__ import annotations

import json
import math
import time

from repro_torch.obs.metrics import Counter, Gauge, Histogram


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(names, values, extra=()) -> str:
    pairs = [f'{n}="{v}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{v}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(tel) -> str:
    """Render a Telemetry (or bare registry) in text exposition format."""
    reg = getattr(tel, "registry", tel)
    out: list[str] = []
    with reg._lock:
        for name in sorted(reg._families):
            fam = reg._families[name]
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            if isinstance(fam, Histogram):
                for lv, c in sorted(fam._children.items()):
                    acc = 0
                    for bound, n in zip(fam.buckets, c.counts):
                        acc += n
                        le = _labels_str(fam.label_names, lv,
                                         (("le", _fmt(bound)),))
                        out.append(f"{fam.name}_bucket{le} {acc}")
                    acc += c.counts[-1]
                    le = _labels_str(fam.label_names, lv, (("le", "+Inf"),))
                    out.append(f"{fam.name}_bucket{le} {acc}")
                    ls = _labels_str(fam.label_names, lv)
                    out.append(f"{fam.name}_sum{ls} {repr(float(c.sum))}")
                    out.append(f"{fam.name}_count{ls} {c.count}")
            elif isinstance(fam, Counter):
                for lv, c in sorted(fam._children.items()):
                    ls = _labels_str(fam.label_names, lv)
                    out.append(f"{fam.name}{ls} {_fmt(c.total)}")
                win = [(lv, c.total - c.mark)
                       for lv, c in sorted(fam._children.items())]
                if any(w for _, w in win) or win:
                    out.append(f"# HELP {fam.name}_window delta of "
                               f"{fam.name} since last roll_window")
                    out.append(f"# TYPE {fam.name}_window gauge")
                    for lv, w in win:
                        ls = _labels_str(fam.label_names, lv)
                        out.append(f"{fam.name}_window{ls} {_fmt(w)}")
            elif isinstance(fam, Gauge):
                for lv, c in sorted(fam._children.items()):
                    ls = _labels_str(fam.label_names, lv)
                    out.append(f"{fam.name}{ls} {_fmt(c.value)}")
    return "\n".join(out) + "\n"


def parse_prometheus(text: str) -> dict[str, float]:
    """Parse exposition text -> {"name{label=\"v\"}" : value}. Series
    names keep their label string verbatim so snapshots and scrapes can
    be diffed key-by-key (round-trip test uses this)."""
    series: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        series[key] = math.inf if val == "+Inf" else float(val)
    return series


def snapshot(tel) -> dict:
    """JSON-able snapshot of a Telemetry: metrics + slow-query log.

    Counters carry ``total`` and ``window``; histograms carry bucket
    counts plus bucket-estimated p50/p99 (``*_est`` to flag estimator
    resolution vs the exact benchmark percentiles).
    """
    reg = tel.registry
    metrics: dict[str, dict] = {}
    with reg._lock:
        for name in sorted(reg._families):
            fam = reg._families[name]
            entry: dict = {"kind": fam.kind, "help": fam.help,
                           "labels": list(fam.label_names), "series": []}
            if isinstance(fam, Histogram):
                entry["buckets"] = list(fam.buckets)
                for lv, c in sorted(fam._children.items()):
                    entry["series"].append({
                        "labels": dict(zip(fam.label_names, lv)),
                        "count": c.count, "sum": c.sum,
                        "counts": list(c.counts),
                        "p50_est": _bucket_pct(fam.buckets, c, 50.0),
                        "p99_est": _bucket_pct(fam.buckets, c, 99.0),
                    })
            elif isinstance(fam, Counter):
                for lv, c in sorted(fam._children.items()):
                    entry["series"].append({
                        "labels": dict(zip(fam.label_names, lv)),
                        "total": c.total, "window": c.total - c.mark})
            elif isinstance(fam, Gauge):
                for lv, c in sorted(fam._children.items()):
                    entry["series"].append({
                        "labels": dict(zip(fam.label_names, lv)),
                        "value": c.value})
            metrics[name] = entry
    return {
        "t_wall": time.time(),
        "metrics": metrics,
        "slow_queries": tel.slow_queries(),
        "slow_threshold_ms": tel.slow_threshold_s * 1e3,
    }


def _bucket_pct(buckets, child, q: float) -> float:
    if child.count == 0:
        return 0.0
    rank = math.ceil(q / 100.0 * child.count)
    acc = 0
    for i, n in enumerate(child.counts):
        acc += n
        if acc >= rank:
            return buckets[i] if i < len(buckets) else math.inf
    return math.inf  # pragma: no cover


def snapshot_json(tel, indent: int | None = None) -> str:
    return json.dumps(snapshot(tel), indent=indent, sort_keys=True)
