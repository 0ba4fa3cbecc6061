"""``search_idle_ms.program`` (front door: ``core/api.py``
``Index.search`` from its entry to its return).

The median over the window's ``index.search`` spans of the milliseconds
inside the span with no kernel, copy or set on the card (the program's
span against the profiler's device intervals, ``bench/lib/spans.py``).
Moves ``search_qps``. Reads nothing where the program keeps no span log.
"""
import statistics

from bench.lib.spans import idle_ms, log


def read(ctx):
    spans = log(ctx)
    calls = [] if spans is None else spans.calls("search")
    if not calls:
        return None
    return statistics.median(idle_ms(ctx, r["t0_ns"], r["t1_ns"])
                             for r in calls)
