"""``idle_share.ingest`` (device): the share of the traced window in which
no kernel, copy or set ran on the card, in per cent (the union of the
profiler's device intervals over the wall time). Moves
``ingest_rows_per_s``.
"""


def read(ctx):
    tl = ctx.timeline
    if tl.window_s <= 0 or not tl.events:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
