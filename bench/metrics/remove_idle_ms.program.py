"""``remove_idle_ms.program`` (mutation plans: ``core/api.py``
``Index.remove`` from its entry to its report, ``core/index.py``
``_delete_impl`` and the reclaim kernel).

The median over the window's ``remove`` calls (``mutation.dispatch``
spans with ``op="remove"``) of the milliseconds inside the span with no
device activity (``bench/lib/spans.py``). Moves ``ingest_rows_per_s``.
Reads nothing where the program keeps no span log.
"""
import statistics

from bench.lib.spans import idle_ms, log


def read(ctx):
    spans = log(ctx)
    calls = [] if spans is None else spans.calls("remove")
    if not calls:
        return None
    return statistics.median(idle_ms(ctx, r["t0_ns"], r["t1_ns"])
                             for r in calls)
