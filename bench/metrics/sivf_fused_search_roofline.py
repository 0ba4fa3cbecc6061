"""``sivf_fused_search_roofline`` (index kernels: kernel 1,
``src/repro_torch/csrc/sivf_fused_search.cu``).

Over a seeded sample of the window's search calls: the least time the
card could take for their scans (``bench/roofline/ivf_scan.py``: the live
rows of the distinct probed lists, the queries and the results at the HBM
rate, or 2 * dim FLOPs a query-row pair at the float32 rate, whichever is
larger) over kernel 1's profiled time in those calls, in per cent.
Moves ``search_qps``. Reads nothing where no call ran kernel 1.
"""
from bench.lib.kernels import kernel1_mask, masked_ms
from bench.roofline import ivf_scan


def read(ctx):
    calls = [(j, c) for j, c in enumerate(ctx.timeline.calls)
             if j in ctx.work]
    dim = int(ctx.config["data"]["dim"])
    k = int(ctx.config["data"]["k"])
    least = spent = 0.0
    for j, c in calls:
        ev = ctx.events(c)
        ms = masked_ms(ev, kernel1_mask(ev))
        if ms <= 0:
            continue
        w = ctx.work[j]
        least += ivf_scan.least_seconds(
            ivf_scan.flat_bytes(w["rows"], w["queries"], dim, k),
            ivf_scan.flat_flops(w["pairs"], dim), ctx.device_name)
        spent += ms / 1e3
    return None if spent <= 0 else 100.0 * least / spent
