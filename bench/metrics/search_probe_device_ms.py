"""``search_probe_device_ms`` (search plan: ``core/quantizer.py`` ``probe``,
the coarse GEMM and the stable sort of the probed lists).

The median over the window's ``index.search`` calls of their ``probe``
span's time on the device (a CUDA event pair on the stream,
``bench/lib/spans.py``). Moves ``search_qps``. Reads nothing where the
program keeps no span log or timed no stage on the device.
"""
from bench.lib.spans import median_device_ms


def read(ctx):
    return median_device_ms(ctx, "search", "probe")
