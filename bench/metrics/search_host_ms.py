"""``search_host_ms`` (front door: ``core/api.py`` ``Index.search``).

The median over the window's search calls of the call's wall time, from
the call to its results on the host, that no device activity covers.
Moves ``search_qps``.
"""
import statistics


def read(ctx):
    calls = ctx.calls("search")
    if not calls:
        return None
    return statistics.median((c.t1 - c.t0) / 1e6 - ctx.busy_ms(c)
                             for c in calls)
