"""The readers of the program's spans (``bench/lib/spans.py``) on a tiny
cell traced on the CPU: the program records under the harness's
profiler, each reader reads a number (or nothing, where its stage is
timed only on a CUDA device), and every program call lies inside the
benchmark's own span of the same call on the shared clock."""
import time

import pytest

from bench.lib import runner, spans
from bench.tests.test_bench_harness import SEED, tiny

IDLE = ("search_idle_ms.program", "add_idle_ms.stage", "add_idle_ms.commit",
        "remove_idle_ms.program")
DEVICE = ("search_probe_device_ms", "search_scan_device_ms")


@pytest.fixture
def traced(monkeypatch):
    """Run a tiny cell traced with the six readers; return the result and
    the readers' context."""
    seen = []

    class Kept(runner.Context):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    monkeypatch.setattr(runner, "Context", Kept)

    def go(cfg):
        per_layer = [{"name": n, "unit": "ms"} for n in IDLE + DEVICE]
        out = runner.run_cell(tiny(cfg, "tiny_search", per_layer), SEED,
                              0.4, True, "cpu", time.perf_counter(),
                              log=lambda s: None)
        return out, seen[-1]
    return go


@pytest.mark.parametrize("cfg", ["tiny_flat", "tiny_pq"])
def test_span_readers_read_the_traced_window(traced, cfg):
    out, ctx = traced(cfg)
    assert out["correct"] is True
    for name in IDLE:
        v = out["metrics"][name]["value"]
        assert 0.0 <= v < 1e3, name
    for name in DEVICE:                 # device_ms: CUDA events only
        assert name not in out["metrics"], name
    log = spans.log(ctx)
    stages = {c["name"] for r in log.calls("search")
              for c in log.children(r)}
    assert stages == ({"probe", "tables", "scan"} if cfg == "tiny_flat"
                      else {"probe", "tables", "adc", "scan"})


def test_program_calls_lie_inside_the_benchmarks_calls(traced):
    _, ctx = traced("tiny_flat")
    log = spans.log(ctx)
    for kind in ("search", "add", "remove"):
        calls = ctx.calls(kind)
        roots = log.calls(kind)
        assert len(roots) == len(calls) > 0, kind
        for c, r in zip(calls, roots):
            # the program's root sits inside the benchmark's span, which
            # for a search ends before the copy of its results
            assert c.t0 <= r["t0_ns"] <= r["t1_ns"] <= c.t_ret, kind
            assert r["attrs"].get("op", "search") == kind


def test_readers_read_nothing_without_a_span_log(monkeypatch, traced):
    from repro_torch import obs
    from repro_torch.obs.trace import Telemetry
    monkeypatch.delattr(Telemetry, "spans")
    monkeypatch.setattr(spans, "_last", None)
    out, _ = traced("tiny_flat")
    assert not set(IDLE + DEVICE) & set(out["metrics"])
    assert not hasattr(obs.default(), "spans")
