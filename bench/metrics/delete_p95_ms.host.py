"""``delete_p95_ms.host`` (mutation plans: ``core/index.py`` delete, the
reclaim kernel and the report's host read).

The 95th percentile over the traced window's ``remove`` calls of the time
from the call to its report on the host. Moves ``ingest_rows_per_s``. It
is not an end-to-end metric: its runs on an H100 spread by 4-18 % (the
quartiles over the median, two sets of six runs of the same seeds in each
``ingest_churn`` cell), which would need a bound over 25 %.
"""
import numpy as np


def read(ctx):
    calls = ctx.calls("remove")
    if not calls:
        return None
    return float(np.percentile([(c.t1 - c.t0) / 1e6 for c in calls], 95))
