"""The program's own spans in the traced window, on the device trace's
clock.

While ``torch.profiler`` records (the ``--trace 1`` run), the port's
default ``repro_torch.obs`` Telemetry records too, and keeps each span
with ``t0_ns`` / ``t1_ns`` on ``time.perf_counter_ns``, the clock the
benchmark's own spans use, so ``Timeline.busy_ns`` reads the device
under them. Roots are the calls (``index.search``, ``mutation.dispatch``
with ``op`` ``add`` or ``remove``), their children the stages inside.

A program that keeps no span log (``Telemetry.spans`` absent) gives
``None`` here, and every reader that uses it reads nothing.
"""
from __future__ import annotations

import statistics

_last: tuple | None = None      # (timeline, Log): readers of one run share it


class Log:
    """Spans of one traced window: the roots by kind, each root's
    children by name in the order they began."""

    def __init__(self, records: list):
        self.roots: dict[str, list] = {}
        kids: dict[int, list] = {}
        for r in records:
            if r["parent"] is None:
                kind = r["name"] if r["name"] != "mutation.dispatch" \
                    else r["attrs"].get("op")
                self.roots.setdefault(kind, []).append(r)
            else:
                kids.setdefault(r["parent"], []).append(r)
        self._kids = {p: sorted(v, key=lambda r: r["t0_ns"])
                      for p, v in kids.items()}

    def calls(self, kind: str) -> list:
        """Roots of ``kind`` (``search``, ``add``, ``remove``), by start."""
        key = "index.search" if kind == "search" else kind
        return sorted(self.roots.get(key, []), key=lambda r: r["t0_ns"])

    def children(self, root: dict) -> list:
        """The root's stages, by start."""
        return self._kids.get(root["id"], [])

    def child(self, root: dict, name: str) -> dict | None:
        for c in self.children(root):
            if c["name"] == name:
                return c
        return None


def log(ctx) -> Log | None:
    """The program's spans that lie inside the traced window, or ``None``
    where the program keeps no span log."""
    global _last
    tl = ctx.timeline
    if _last is not None and _last[0] is tl:
        return _last[1]
    from repro_torch import obs
    read = getattr(obs.default(), "spans", None)
    if read is None:
        return None
    recs = [r for r in read()["spans"]
            if r["t1_ns"] is not None and tl.t0 <= r["t0_ns"]
            and r["t1_ns"] <= tl.t1]
    _last = (tl, Log(recs))
    return _last[1]


def idle_ms(ctx, a: int, b: int) -> float:
    """Milliseconds of ``[a, b]`` (perf_counter_ns) with the device idle."""
    return ((b - a) - ctx.timeline.busy_ns(a, b)) / 1e6


def median_device_ms(ctx, kind: str, stage: str) -> float | None:
    """The median ``device_ms`` of ``stage`` over the calls of ``kind``;
    ``None`` where no call timed it on the device."""
    spans = log(ctx)
    if spans is None:
        return None
    ms = [c["device_ms"] for r in spans.calls(kind)
          for c in [spans.child(r, stage)]
          if c is not None and c["device_ms"] is not None]
    return statistics.median(ms) if ms else None
