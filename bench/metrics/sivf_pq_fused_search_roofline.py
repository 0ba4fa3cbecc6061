"""``sivf_pq_fused_search_roofline`` (index kernels: kernel 2,
``src/repro_torch/csrc/sivf_pq_fused_search.cu``).

As ``sivf_fused_search_roofline``: the least time of the scans' bytes
(each live row's codes and id in the distinct probed lists, the ADC
tables, the results) at the HBM rate over kernel 2's profiled time, in
per cent. Its table lookups are a bound of their own, not in the share.
Moves ``search_qps``. Reads nothing where no call ran kernel 2.
"""
from bench.lib.kernels import kernel2_mask, masked_ms
from bench.roofline import ivf_scan


def read(ctx):
    calls = [(j, c) for j, c in enumerate(ctx.timeline.calls)
             if j in ctx.work]
    pq = ctx.config["index"]["pq"]
    m, ksub = int(pq["m"]), 1 << int(pq["nbits"])
    k = int(ctx.config["data"]["k"])
    least = spent = 0.0
    for j, c in calls:
        ev = ctx.events(c)
        ms = masked_ms(ev, kernel2_mask(ev))
        if ms <= 0:
            continue
        w = ctx.work[j]
        least += ivf_scan.least_seconds(
            ivf_scan.pq_bytes(w["rows"], w["queries"], m, ksub, k), 0,
            ctx.device_name)
        spent += ms / 1e3
    return None if spent <= 0 else 100.0 * least / spent
