"""``search_plan_device_ms`` (search plan: ``core/quantizer.py`` ``probe``,
``core/index.py`` ``gather_tables``, ``core/pq.py``'s ADC tables).

The median over the window's search calls of the device time of every
event of the call but the fused scan (kernels 1 and 2, with kernel 1's
plan, as ``bench/lib/kernels.py`` tells them) and the copies. Moves
``search_qps``.
"""
import statistics

from bench.lib.kernels import is_copy, masked_ms, scan_mask


def read(ctx):
    calls = ctx.calls("search")
    if not calls:
        return None
    out = []
    for c in calls:
        ev = ctx.events(c)
        out.append(masked_ms(ev, [not s and not is_copy(e[0]) for e, s in
                                  zip(ev, scan_mask(ev))]))
    return statistics.median(out)
