"""``add_host_ms`` (mutation plans: ``core/index.py`` insert, its staging,
the one host read of its commit decision, the commit, and the report).

The median over the window's ``add`` calls of the call's wall time that
no device activity covers. Moves ``ingest_rows_per_s``.
"""
import statistics


def read(ctx):
    calls = ctx.calls("add")
    if not calls:
        return None
    return statistics.median((c.t1 - c.t0) / 1e6 - ctx.busy_ms(c)
                             for c in calls)
