"""``add_idle_ms.stage`` (mutation plans: an add up to its one host read,
``assign`` and ``_insert_stage``, ``core/api.py`` ``_SingleOps.insert``).

The median over the window's ``add`` calls (``mutation.dispatch`` spans
with ``op="add"``) of the milliseconds from the span's start to its
``decide`` span's start with no device activity (``bench/lib/spans.py``).
Moves ``ingest_rows_per_s``. Reads nothing where the program keeps no
span log.
"""
import statistics

from bench.lib.spans import idle_ms, log


def read(ctx):
    spans = log(ctx)
    if spans is None:
        return None
    out = [idle_ms(ctx, r["t0_ns"], d["t0_ns"]) for r in spans.calls("add")
           for d in [spans.child(r, "decide")] if d is not None]
    return statistics.median(out) if out else None
