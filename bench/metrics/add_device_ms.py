"""``add_device_ms`` (mutation plans on the device: ``core/quantizer.py``
``assign``, ``core/pq.py`` ``encode``, ``core/index.py`` insert).

The median over the window's ``add`` calls of the device's busy time
inside the call. Moves ``ingest_rows_per_s``.
"""
import statistics


def read(ctx):
    calls = ctx.calls("add")
    if not calls:
        return None
    return statistics.median(ctx.busy_ms(c) for c in calls)
