"""``search_scan_device_ms`` (index kernels: kernel 1 with its plan and
merge, or kernel 2, launched by ``core/index.py`` ``_scan_dispatch``).

The median over the window's ``index.search`` calls of their ``scan``
span's time on the device (a CUDA event pair on the stream,
``bench/lib/spans.py``). Moves ``search_qps``. Reads nothing where the
program keeps no span log or timed no stage on the device.
"""
from bench.lib.spans import median_device_ms


def read(ctx):
    return median_device_ms(ctx, "search", "scan")
