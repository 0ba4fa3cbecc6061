"""``add_idle_ms.commit`` (mutation plans: an add's commit after its host
read, ``core/index.py`` ``_insert_commit`` with PQ's ``encode``).

The median over the window's ``add`` calls of the milliseconds inside
their ``commit`` span with no device activity (``bench/lib/spans.py``).
Moves ``ingest_rows_per_s``. Reads nothing where the program keeps no
span log.
"""
import statistics

from bench.lib.spans import idle_ms, log


def read(ctx):
    spans = log(ctx)
    if spans is None:
        return None
    out = [idle_ms(ctx, c["t0_ns"], c["t1_ns"]) for r in spans.calls("add")
           for c in [spans.child(r, "commit")] if c is not None]
    return statistics.median(out) if out else None
