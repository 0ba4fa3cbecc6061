"""The harness end to end on the CPU at a tiny size: cells found by name
from new files, the result line's schema, the run-time import check, the
comparison's control and planted faults under the timed path."""
import dataclasses
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from bench.lib import runner, spec
from bench.lib.runbook import ring_slice

ROOT = Path(__file__).resolve().parents[2]
FIX = Path(__file__).resolve().parent / "fixtures"
SEED = 2**31 + 7


def tiny(cfg: str, mix: str, per_layer=(), end_to_end=None) -> spec.Cell:
    e2e = end_to_end or [{"name": "setup_s", "unit": "s"}]
    return spec.Cell(name=f"{cfg}.{mix}", chips=1,
                     config=spec.load_json(FIX / f"{cfg}.json"),
                     traffic=spec.load_json(FIX / f"{mix}.json"),
                     end_to_end=list(e2e), per_layer=list(per_layer),
                     bench_dir=ROOT / "bench")


def run(cell, trace=False, control=False, wrap=None, seconds=0.4):
    return runner.run_cell(cell, SEED, seconds, trace, "cpu",
                           time.perf_counter(), control=control,
                           wrap_index=wrap, log=lambda s: None)


# -- files found by name -----------------------------------------------------

def test_new_config_mix_and_metric_are_files_found_by_name(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bj = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(FIX / "tiny_flat.json", tmp_path / "bench" / "configs"
                / "newcfg.json")
    shutil.copy(FIX / "tiny_search.json", tmp_path / "bench" / "traffic"
                / "newmix.json")
    (tmp_path / "bench" / "metrics" / "calls_seen.py").write_text(
        "def read(ctx):\n    return len(ctx.calls('search'))\n")
    bj["configs"].append({"name": "newcfg", "source": "https://x.org/a",
                          "file": "bench/configs/newcfg.json",
                          "reduced": [], "why": "a test"})
    bj["workloads"].append({"name": "newcfg.newmix", "config": "newcfg",
                            "traffic": "newmix", "chips": 1, "why": "test"})
    bj["per_layer"].append({"name": "calls_seen", "unit": "calls",
                            "better": "higher", "source": "device_trace",
                            "layer": "front door", "moves": "search_qps",
                            "workloads": ["newcfg.newmix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bj))
    cell = spec.resolve("newcfg.newmix", root=tmp_path)
    assert cell.config["name"] == "tiny_flat"
    assert cell.traffic["name"] == "tiny_search"
    assert [m["name"] for m in cell.per_layer] == ["calls_seen"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    out = run(cell, trace=True)
    assert out["correct"] is True
    assert out["metrics"]["calls_seen"]["value"] == out["info"]["calls"][
        "search"] > 0
    # the shipped cells resolve too, each with its own files
    for w in bj["workloads"][:-1]:
        c = spec.resolve(w["name"], root=ROOT)
        assert c.config["name"] == w["config"]
        assert c.traffic["name"] == w["traffic"]
        for m in c.per_layer:
            assert callable(c.reader(m["name"]))


# -- the result line ---------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(trace):
    per_layer = [{"name": n, "unit": u} for n, u in (
        ("search_host_ms", "ms"), ("search_plan_device_ms", "ms"),
        ("idle_share.search", "%"), ("sivf_fused_search_roofline", "%"))]
    e2e = [{"name": "search_qps", "unit": "queries/s"},
           {"name": "search_p95_ms", "unit": "ms"},
           {"name": "setup_s", "unit": "s"}]
    out = run(tiny("tiny_flat", "tiny_search", per_layer, e2e), trace=trace)
    line = json.loads(json.dumps(out))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in dev
    for name, chk in line["checks"].items():
        assert set(chk) == {"value", "limit"}, name
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        assert set(line["metrics"]) == {"search_host_ms",
                                        "search_plan_device_ms",
                                        "idle_share.search"}
        for key in ("device_ops", "idle_gaps"):
            rows = line["breakdown"][key]
            assert 0 < len(rows) <= 10
            assert all(isinstance(r[0], str) and r[1] >= 0 for r in rows)
    else:
        assert set(line["metrics"]) == {"search_qps", "search_p95_ms",
                                        "setup_s"}
        assert line["metrics"]["search_qps"]["value"] > 0


def test_import_check_compares_whole_top_level_names():
    assert runner.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
         "repro.core.index", "sivf", "sivf.telemetry"]) == [
        "flax", "jax", "jaxlib", "repro", "sivf"]
    assert runner.forbidden_modules(
        ["repro_torch", "repro_torch.core", "sivf_torch", "jaxtyping",
         "reprocess", "sivfx", "numpy", "torch"]) == []


def test_ring_slice_wraps():
    t = torch.arange(10)
    assert ring_slice(t, 8, 4).tolist() == [8, 9, 0, 1]
    assert ring_slice(t, 13, 2).tolist() == [3, 4]


# -- correct: sound runs, the control, planted faults -------------------------

@pytest.mark.parametrize("cfg", ["tiny_flat", "tiny_pq"])
@pytest.mark.parametrize("mix", ["tiny_search", "tiny_ingest"])
def test_program_passes_and_tf32_control_fails(cfg, mix):
    out = run(tiny(cfg, mix), control=True)
    assert out["correct"] is True, out["checks"]
    assert out["control"]["correct"] is False, out["control"]
    nums = out["control"]["numbers"]
    assert nums["dist_err"]["value"] > nums["dist_err"]["limit"]


class Proxy:
    """The index with one call broken underneath the client."""

    def __init__(self, index):
        self._index = index

    def __getattr__(self, name):
        return getattr(self._index, name)


class Unchanged(Proxy):
    """``add`` returns the state unchanged and reports success."""

    def add(self, vecs, ids):
        import sivf_torch
        n = int(ids.shape[0])
        return sivf_torch.MutationReport(
            op="add", requested=n, accepted=n, overwritten=0, rejected=0,
            errors=sivf_torch.ErrorCode.NONE, n_live=self._index.n_live,
            padded_to=n)


class HalfBatch(Proxy):
    """``add`` commits half the batch and reports all of it."""

    def add(self, vecs, ids):
        h = int(ids.shape[0]) // 2
        rep = self._index.add(vecs[:h], ids[:h])
        return dataclasses.replace(rep, requested=2 * h, accepted=2 * h)


class AlteredAnswer(Proxy):
    """``search`` returns each query's nearest label from another query."""

    def search(self, queries, k, nprobe=None, **kw):
        res = self._index.search(queries, k, nprobe, **kw)
        lab = res.labels.clone()
        lab[:, 0] = res.labels.roll(1, 0)[:, 0]
        return dataclasses.replace(res, labels=lab)


@pytest.mark.parametrize("fault", [Unchanged, HalfBatch, AlteredAnswer])
@pytest.mark.parametrize("cfg", ["tiny_flat", "tiny_pq"])
def test_planted_faults_make_correct_false(fault, cfg):
    out = run(tiny(cfg, "tiny_search"), wrap=fault)
    assert out["correct"] is False
    bad = [n for n, c in out["checks"].items() if c["value"] > c["limit"]]
    want = {Unchanged: "live_ids_wrong", HalfBatch: "live_ids_wrong",
            AlteredAnswer: "search_wrong"}[fault]
    assert want in bad, out["checks"]


@pytest.mark.card
def test_tf32_control_fails_on_the_card(card):
    """The control at a small size on the card: the program passes, the
    reference in TF32 in its place fails."""
    cell = tiny("tiny_flat", "tiny_search")
    out = runner.run_cell(cell, SEED, 0.5, False, card, time.perf_counter(),
                          control=True, log=lambda s: None)
    assert out["correct"] is True
    assert out["control"]["correct"] is False
