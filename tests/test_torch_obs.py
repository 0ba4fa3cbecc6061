"""The port's telemetry against the reference's, on the CPU.

``repro_torch.obs`` (registry, spans, exporters) and the reference's
``repro.obs`` run the same operations under one injected clock and must
give equal snapshots (wall-clock stamps aside) and equal Prometheus text;
``percentiles`` / ``latency_summary_ms`` agree on the same samples. The
instrumented index: the reference's tiered ``sivf.Index`` and the port's
(``device="cpu"``) run the same ops, and record the same span names, the
same metric families and the same per-stage span counts, and the port's
cache-event counters equal its ``stats()``. The span semantics of
``tests/test_obs.py`` (nesting, ``root="auto"``, the open / exit_scope /
finish lifecycle, the disabled path, the slow-query log) hold on the
port's own.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
import sivf
import sivf_torch
from repro_torch.obs.trace import _NOOP

D, NL = 16, 8
PORT_FAMILIES = ("sivf_slabs_allocated_total", "sivf_slabs_reclaimed_total")
OBS = {"ref": jobs, "port": tobs}


def fake_clock():
    t = [0.0]
    return t, lambda: t[0]


def strip_wall(snap: dict) -> dict:
    """A snapshot without its wall-clock stamps."""
    snap = dict(snap)
    snap.pop("t_wall")
    snap["slow_queries"] = [{k: v for k, v in e.items() if k != "t_wall"}
                            for e in snap["slow_queries"]]
    return snap


def record(obs, t: list, clock):
    """One fixed sequence of counter, gauge, histogram and span operations
    (the values made from a seeded numpy generator)."""
    rng = np.random.default_rng(3)
    tel = obs.Telemetry(enabled=True, slow_threshold_s=0.004,
                        slow_log_size=3, clock=clock)
    c = tel.counter("sivf_serve_requests_total", "reqs", ("tenant", "op"))
    g = tel.gauge("sivf_serve_queue_depth", "depth")
    h = tel.histogram("sivf_serve_coalesce_rows", "rows",
                      buckets=tuple(float(2 ** i) for i in range(13)))
    for i in range(40):
        c.inc(int(rng.integers(1, 5)), tenant=f"t{i % 3}",
              op=("search", "add")[i % 2])
        g.set(float(rng.integers(0, 100)))
        h.observe(float(rng.integers(1, 300)))
        if i == 20:
            tel.roll_window()
    for i in range(12):
        with tel.span("serve.tile", root=True, tenant=f"t{i % 3}", epoch=i):
            t[0] += float(rng.uniform(0, 0.004))
            with tel.span("plan"):
                t[0] += float(rng.uniform(0, 0.002))
            with tel.span("index.search", root="auto"):
                t[0] += float(rng.uniform(0, 0.006))
        tel.record_duration("serve.queue", float(rng.uniform(0, 0.01)),
                            attach=False)
    sp = tel.open_span("serve.tile", root=True, rows=4)
    with tel.span("scan"):
        t[0] += 0.003
    tel.exit_scope(sp)
    with tel.span("prefetch"):
        t[0] += 0.001
    tel.finish_span(sp)
    return tel


def test_registry_spans_and_exports_equal_the_reference():
    got = {}
    for name, obs in OBS.items():
        t, clock = fake_clock()
        got[name] = record(obs, t, clock)
    ref, port = got["ref"], got["port"]
    assert strip_wall(port.snapshot()) == strip_wall(ref.snapshot())
    assert port.render_prometheus() == ref.render_prometheus()
    assert tobs.parse_prometheus(port.render_prometheus()) == \
        jobs.parse_prometheus(ref.render_prometheus())
    assert port.slow_queries()[0]["duration_ms"] >= \
        port.slow_queries()[-1]["duration_ms"]


@pytest.mark.parametrize("samples", [[], [0.001] * 10, "uniform", "range"])
def test_percentiles_agree_with_the_reference(samples):
    if samples == "uniform":
        samples = list(np.random.default_rng(0).uniform(size=997))
    elif samples == "range":
        samples = list(range(1, 101))
    qs = (50.0, 90.0, 99.0, 99.9)
    assert tobs.percentiles(samples, qs) == jobs.percentiles(samples, qs)
    assert tobs.latency_summary_ms(samples) == \
        jobs.latency_summary_ms(samples)
    assert tobs.BUCKETS_S == jobs.BUCKETS_S


@pytest.mark.parametrize("kind", ["counter", "gauge", "histogram"])
def test_label_validation_and_reregistration(kind):
    reg = tobs.MetricsRegistry()
    fam = getattr(reg, kind)("n", "h", ("tenant",))
    assert getattr(reg, kind)("n", "h", ("tenant",)) is fam
    with pytest.raises(ValueError, match="re-registered"):
        getattr(reg, kind)("n", "h", ("shard",))
    other = "gauge" if kind != "gauge" else "counter"
    with pytest.raises(ValueError, match="re-registered"):
        getattr(reg, other)("n", "h", ("tenant",))
    op = {"counter": "inc", "gauge": "set", "histogram": "observe"}[kind]
    with pytest.raises(ValueError, match="labels"):
        getattr(fam, op)(1, shard="0")
    with pytest.raises(ValueError, match="labels"):
        getattr(fam, op)(1)


def test_counter_windows_and_histogram_estimates():
    reg = tobs.MetricsRegistry()
    c = reg.counter("req_total", "requests", ("tenant",))
    c.inc(tenant="a")
    c.inc(4, tenant="a")
    reg.roll_window()
    c.inc(3, tenant="a")
    assert c.get(tenant="a") == 8 and c.get_window(tenant="a") == 3
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1, tenant="a")
    h = reg.histogram("lat", labels=("stage",))
    for v in (1e-6, 3e-6, 1e9):
        h.observe(v, stage="s")
    d = h.get(stage="s")
    assert d["counts"][0] == d["counts"][2] == d["counts"][-1] == 1
    assert h.percentile(50.0, stage="s") == tobs.BUCKETS_S[2]
    assert h.percentile(99.0, stage="s") == math.inf
    assert h.percentile(50.0, stage="empty") == 0.0
    w = tobs.WindowedCounter()
    w.add(5)
    w.mark()
    w.add(2)
    assert (w.total, w.window) == (7, 2)
    assert tobs.WindowedCounter().carry(w).window == 2


def test_span_lifecycle_root_auto_and_slow_log():
    t, clock = fake_clock()
    tel = tobs.Telemetry(enabled=True, slow_threshold_s=0.0,
                         slow_log_size=2, clock=clock)
    with tel.span("serve.tile", root=True, tenant="a", epoch=3):
        t[0] += 0.010
        with tel.span("plan"):
            t[0] += 0.002
        with tel.span("index.search", root="auto"):   # a stage here
            t[0] += 0.005
    (entry,) = tel.slow_queries()
    assert entry["duration_ms"] == pytest.approx(17.0)
    assert entry["stages_ms"] == {"plan": 2.0, "index.search": 5.0}
    assert entry["tenant"] == "a" and entry["epoch"] == 3
    tel.clear_slow_log()
    with tel.span("index.search", root="auto"):       # a root here
        t[0] += 0.001
    assert tel.slow_queries()[0]["span"] == "index.search"
    tel.clear_slow_log()

    @tel.traced("op", root=True)
    def work(ms):
        t[0] += ms / 1e3
        tel.record_duration("serve.queue", 0.003)

    for ms in (5, 1, 9):
        work(ms)
    assert [e["duration_ms"] for e in tel.slow_queries()] == [9.0, 5.0]
    assert tel.slow_queries()[0]["stages_ms"] == {"serve.queue": 3.0}
    assert tel.counter("sivf_slow_queries_total").get() == 5


def test_disabled_telemetry_records_nothing():
    tel = tobs.Telemetry(enabled=False)
    assert tel.span("x", root=True) is _NOOP
    assert tel.open_span("x") is None
    tel.exit_scope(None)
    tel.finish_span(None)
    tel.record_duration("x", 1.0)
    assert tel.slow_queries() == []
    assert tel.histogram("sivf_stage_seconds",
                         labels=("stage",)).items() == []


def test_process_default_and_the_facade():
    assert tobs.default().enabled is False
    assert sivf_torch.telemetry.get() is tobs.default()
    assert sivf_torch.telemetry.Telemetry is tobs.Telemetry
    cfg = sivf_torch.SIVFConfig(dim=D, n_lists=NL, n_slabs=64, capacity=32,
                                n_max=4096)
    rng = np.random.default_rng(1)
    idx = sivf_torch.Index(cfg, rng.normal(size=(NL, D)).astype(np.float32),
                           device="cpu")
    idx.add(rng.normal(size=(64, D)).astype(np.float32),
            np.arange(64, dtype=np.int32))
    idx.search(rng.normal(size=(2, D)).astype(np.float32), k=5, nprobe=2)
    hist = sivf_torch.telemetry.snapshot()["metrics"].get(
        "sivf_stage_seconds")
    assert hist is None or hist["series"] == []
    try:
        tel = sivf_torch.telemetry.enable(slow_threshold_s=0.5)
        assert tel is tobs.default() and tel.enabled
        assert tel.slow_threshold_s == 0.5
        idx.search(rng.normal(size=(2, D)).astype(np.float32), k=5,
                   nprobe=2)
        text = sivf_torch.telemetry.render_prometheus()
        assert 'sivf_stage_seconds_count{stage="index.search"} 1' in text
        assert sivf_torch.telemetry.snapshot_json()
    finally:
        sivf_torch.telemetry.disable()
        tobs.default().slow_threshold_s = 0.050


# ---------------------------------------------------------------------------
# the instrumented index, against the reference's
# ---------------------------------------------------------------------------

def twins(rng, device_slabs=24, attributes=(), deferred=False):
    """The reference's and the port's index, each with its own enabled
    Telemetry, on one set of centroids."""
    base = dict(dim=D, n_lists=NL, n_slabs=64, capacity=32, n_max=4096,
                device_slabs=device_slabs, attributes=attributes)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    jt = jobs.Telemetry(enabled=True, slow_threshold_s=0.0, slow_log_size=64)
    tt = tobs.Telemetry(enabled=True, slow_threshold_s=0.0, slow_log_size=64)
    j = sivf.Index(sivf.SIVFConfig(**base), jnp.asarray(cents),
                   telemetry=jt, deferred=deferred)
    t = sivf_torch.Index(sivf_torch.SIVFConfig(**base), cents, device="cpu",
                         telemetry=tt, deferred=deferred)
    return (j, jt), (t, tt)


def stage_counts(tel) -> dict:
    h = tel.histogram("sivf_stage_seconds", labels=("stage",))
    return {lv[0]: c.count for lv, c in h.items()}


def ops_on(rng, index, qs, j_side: bool):
    """A fixed op sequence: adds, an overwrite, a remove, searches (cold
    and warm), a filtered search and a maintenance pass."""
    vecs = rng.normal(size=(400, D)).astype(np.float32)
    ids = np.arange(400, dtype=np.int32)
    attrs = {"tenant": ids % 3}
    index.add(vecs, ids, attrs=attrs)
    index.add(vecs[:50] + 0.1, ids[:50], attrs={"tenant": ids[:50] % 3})
    index.remove(ids[100:160])
    index.flush()
    for _ in range(2):
        index.search(qs, k=5, nprobe=4)
    pred = (sivf if j_side else sivf_torch).Eq("tenant", 1)
    index.search(qs, k=5, nprobe=4, filter=pred)
    mt = sivf if j_side else sivf_torch
    index.maintain([mt.split(0, 1), mt.recluster(2)])


@pytest.mark.parametrize("device_slabs", [None, 24])
def test_index_spans_and_counters_match_the_reference(rng, device_slabs):
    (j, jt), (t, tt) = twins(rng, device_slabs, attributes=("tenant",),
                             deferred=True)
    qs = rng.normal(size=(4, D)).astype(np.float32)
    seed = int(rng.integers(1 << 30))
    ops_on(np.random.default_rng(seed), j, qs, True)
    ops_on(np.random.default_rng(seed), t, qs, False)
    snap_j, snap_t = j.telemetry(), t.telemetry()
    # the reference's families and stages, the same counts; beside them
    # the port's own: the slab counters and the stages inside its calls
    assert sorted(snap_t["metrics"]) == sorted(
        list(snap_j["metrics"]) + list(PORT_FAMILIES))
    ref_names = set(stage_counts(jt))
    port = stage_counts(tt)
    assert {n: c for n, c in port.items() if n in ref_names} == \
        stage_counts(jt)
    want = {"index.search", "mutation.dispatch", "mutation.flush",
            "maintenance.op"}
    if device_slabs:
        want |= {"plan", "prefetch", "scan"}
    assert ref_names == want
    # two adds, one remove and (untiered) three searches, all deferred
    added = {"assign": 2, "stage": 2, "decide": 2, "commit": 2,
             "delete": 1}
    if not device_slabs:
        added |= {"probe": 3, "tables": 3, "scan": 3}
    assert {n: c for n, c in port.items() if n not in ref_names} == added
    for name in ("sivf_index_mutation_rows_total",
                 "sivf_maintenance_ops_total",
                 "sivf_maintenance_rows_total",
                 "sivf_tiered_cache_events_total"):
        if name in snap_j["metrics"]:
            assert snap_t["metrics"][name]["series"] == \
                snap_j["metrics"][name]["series"], name
    # the slow log's roots and their attributes (durations aside)
    keys = [(e["span"], e.get("op"), e.get("epoch"), e.get("kind"),
             e.get("filter"), sorted(set(e["stages_ms"]) & ref_names))
            for e in tt.slow_queries()]
    assert sorted(keys, key=repr) == sorted(
        [(e["span"], e.get("op"), e.get("epoch"), e.get("kind"),
          e.get("filter"), sorted(e["stages_ms"]))
         for e in jt.slow_queries()], key=repr)
    # the launch signatures, counted per op, and their counter
    comp = t.stats()["compiles"]
    assert comp == t.compile_stats()
    if device_slabs:
        assert comp["search"] == 0
        assert comp["tiered_plan"] == 1 and comp["tiered_scan"] == 2
    else:
        assert comp["search"] == 2
    assert comp["add"] == 2 and comp["remove"] == 1
    assert tt.counter("sivf_jit_compile_events_total").get() == \
        t.compile_events() == sum(comp.values())
    assert tt.gauge("sivf_jit_executables").get() == sum(comp.values())


def test_tiered_cache_counters_equal_stats(rng):
    (_, _), (t, tt) = twins(rng, device_slabs=40)
    t.add(rng.normal(size=(1500, D)).astype(np.float32),
          np.arange(1500, dtype=np.int32))
    for q in range(8):          # different batches: misses and evictions
        t.search(rng.normal(size=(1, D)).astype(np.float32), k=5, nprobe=1)
    st = t.stats()
    ev = tt.counter("sivf_tiered_cache_events_total", labels=("event",))
    assert ev.get(event="hit") == st["cache_hits"] > 0
    assert ev.get(event="miss") == st["cache_misses"] > 0
    assert ev.get(event="upload") == st["cache_uploads"] > 0
    assert ev.get(event="eviction") == st["cache_evictions"] > 0
    assert ev.get(event="dedup_saved") == st["dedup_saved_fetches"]
    tb = tt.counter("sivf_transfer_bytes_total",
                    labels=("direction", "stage"))
    assert tb.get(direction="h2d", stage="prefetch") == \
        t._tiered.h2d_bytes > 0
    assert tb.get(direction="d2h", stage="prefetch") == \
        4 * t.cfg.n_slabs * t._tiered.d2h_reads
    entries = [e for e in tt.slow_queries() if e["span"] == "index.search"]
    assert entries and {"plan", "prefetch", "scan"} <= \
        set(entries[0]["stages_ms"])


# ---------------------------------------------------------------------------
# the span log: recording rule, the stages inside each call, device times
# ---------------------------------------------------------------------------

def small_index(tel, pq=False, deferred=False, n_lists=NL):
    """A CPU index recording into ``tel`` (PQ: codebooks trained here)."""
    rng = np.random.default_rng(5)
    cfg = sivf_torch.SIVFConfig(
        dim=D, n_lists=n_lists, n_slabs=64, capacity=32, n_max=4096,
        pq=sivf_torch.PQConfig(m=4, nbits=4) if pq else None)
    idx = sivf_torch.Index(cfg, rng.normal(size=(n_lists, D)).astype(
        np.float32), device="cpu", telemetry=tel, deferred=deferred)
    if pq:
        idx.train(rng.normal(size=(512, D)).astype(np.float32))
    return idx, rng


def one_of_each(idx, rng, n=200, start=0):
    """An add of ``n`` new ids, a search of 3 queries, a remove of half."""
    ids = np.arange(start, start + n, dtype=np.int32)
    idx.add(rng.normal(size=(n, D)).astype(np.float32), ids)
    idx.search(rng.normal(size=(3, D)).astype(np.float32), k=5, nprobe=3)
    idx.remove(ids[: n // 2])


def test_a_profiler_session_records_while_the_switch_is_off():
    import torch
    from torch.profiler import ProfilerActivity, profile
    tel = tobs.Telemetry(enabled=False)
    idx, rng = small_index(tel)
    assert tel.recording is False
    one_of_each(idx, rng)
    assert tel.spans() == {"spans": [], "wrapped": False}
    with profile(activities=[ProfilerActivity.CPU]):
        assert tel.recording is True and tel.enabled is False
        one_of_each(idx, rng, start=1000)
    assert tel.recording is False
    names = [r["name"] for r in tel.spans()["spans"]]
    assert names.count("index.search") == 1
    assert names.count("mutation.dispatch") == 2
    counts = stage_counts(tel)
    assert counts["index.search"] == 1 and counts["probe"] == 1
    one_of_each(idx, rng, start=2000)          # outside again: nothing
    assert [r["name"] for r in tel.spans()["spans"]] == names
    assert stage_counts(tel) == counts
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_the_off_path_hands_out_noop_and_makes_no_event(monkeypatch):
    import torch

    def no_event(*a, **k):
        raise AssertionError("a CUDA event on the off path")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(torch.cuda, "synchronize", no_event)
    tel = tobs.Telemetry(enabled=False)
    assert tel.span("probe", device=torch.device("cuda", 0)) is _NOOP
    assert tel.span("index.search", root="auto") is _NOOP
    assert tobs.trace.OFF.span("scan", device=torch.device("cuda")) is _NOOP
    idx, rng = small_index(tel, pq=True)
    one_of_each(idx, rng)
    assert tel.spans()["spans"] == []
    # recording on a CPU device makes no event either
    tel.enabled = True
    one_of_each(idx, rng, start=1000)
    assert tel.spans()["spans"]


CHILDREN = {("index.search", False): ["probe", "tables", "scan"],
            ("index.search", True): ["probe", "tables", "adc", "scan"],
            ("add", False): ["assign", "stage", "decide", "commit",
                             "report"],
            ("remove", False): ["delete", "report"]}


@pytest.mark.parametrize("pq", [False, True])
def test_each_root_holds_its_stages_in_order(pq):
    import time
    tel = tobs.Telemetry(enabled=True)
    idx, rng = small_index(tel, pq=pq)
    assert tel.spans()["spans"] == []        # set-up records no span
    t0 = time.perf_counter_ns()
    one_of_each(idx, rng)
    t1 = time.perf_counter_ns()
    log = tel.spans()
    assert log["wrapped"] is False
    recs = log["spans"]
    roots = [r for r in recs if r["parent"] is None]
    assert [(r["name"], r["attrs"].get("op")) for r in roots] == [
        ("mutation.dispatch", "add"), ("index.search", None),
        ("mutation.dispatch", "remove")]
    for r in roots:
        assert r["root"] == r["id"]
        assert t0 <= r["t0_ns"] <= r["t1_ns"] <= t1
        kids = sorted((c for c in recs if c["parent"] == r["id"]),
                      key=lambda c: c["t0_ns"])
        key = (r["attrs"].get("op", r["name"]),
               pq and r["name"] == "index.search")
        assert [c["name"] for c in kids] == CHILDREN[key]
        prev = r["t0_ns"]
        for c in kids:
            assert c["root"] == r["id"]
            assert prev <= c["t0_ns"] <= c["t1_ns"] <= r["t1_ns"]
            prev = c["t1_ns"]
            assert c["device_ms"] is None       # a CPU device
        assert r["device_ms"] is None
        # nothing below the stages
        assert not [g for g in recs if g["parent"] in
                    {c["id"] for c in kids}]
    assert len(recs) == 3 + sum(len(CHILDREN[k]) for k in (
        ("add", False), ("index.search", pq), ("remove", False)))


def test_the_span_log_is_bounded_and_says_it_wrapped(monkeypatch):
    monkeypatch.setattr(tobs.trace, "SPAN_LOG_SIZE", 8)
    tel = tobs.Telemetry(enabled=True)
    for i in range(5):
        with tel.span("x", root=True, i=i):
            pass
    log = tel.spans()
    assert log["wrapped"] is False
    assert [r["attrs"]["i"] for r in log["spans"]] == list(range(5))
    for i in range(5, 20):
        with tel.span("x", root=True, i=i):
            pass
    log = tel.spans()
    assert log["wrapped"] is True
    assert [r["attrs"]["i"] for r in log["spans"]] == list(range(12, 20))


class FakeEvent:
    """A CUDA event stand-in: ``query()`` reads its completion flag, and
    ``elapsed_time`` the two events' fake timestamps."""
    made = 0
    clock = [0.0]

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.done, self.t = False, None

    def record(self, stream=None):
        self.t, self.done = FakeEvent.clock[0], False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t


def test_device_times_resolve_at_the_root_or_in_spans(monkeypatch):
    import torch
    synced = []
    recorded = []
    monkeypatch.setattr(FakeEvent, "made", 0)
    orig_record = FakeEvent.record

    def record(self, stream=None):
        orig_record(self, stream)
        recorded.append(self)

    monkeypatch.setattr(FakeEvent, "record", record)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda idx=None: idx)

    def synchronize(idx=None):
        synced.append(idx)
        for e in recorded:
            e.done = True

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    dev = torch.device("cuda", 0)
    tel = tobs.Telemetry(enabled=True)

    def call(work_ms, done):
        with tel.span("index.search", root="auto"):
            for name, ms in zip(("probe", "scan"), work_ms):
                with tel.span(name, device=dev):
                    FakeEvent.clock[0] += ms
            with tel.span("decide"):            # a host-only stage
                pass
            for e in recorded:                  # the device catches up
                e.done = e.done or done

    call((1.5, 2.0), done=True)      # complete when the root closes
    by = {r["name"]: r for r in tel.spans()["spans"]}
    assert synced == []              # resolved by query(), no synchronise
    assert by["probe"]["device_ms"] == 1.5 and by["scan"]["device_ms"] == 2.0
    assert by["decide"]["device_ms"] is None
    assert by["index.search"]["device_ms"] is None
    assert FakeEvent.made == 4
    call((0.25, 0.5), done=False)    # still running when the root closes
    recs = tel.spans()["spans"]      # one synchronise resolves them
    assert synced == [0]
    assert [r["device_ms"] for r in recs if r["name"] in ("probe", "scan")
            ] == [1.5, 2.0, 0.25, 0.5]
    assert FakeEvent.made == 4       # the pool gave the first pair back


@pytest.mark.parametrize("deferred", [False, True])
def test_slab_counters_equal_the_slabs_stats_shows_moving(deferred):
    tel = tobs.Telemetry(enabled=True)
    idx, rng = small_index(tel, deferred=deferred, n_lists=4)
    alloc = tel.counter("sivf_slabs_allocated_total")
    recl = tel.counter("sivf_slabs_reclaimed_total")
    used0 = idx.stats()["slabs_used"]
    moves = []
    ids = np.arange(1200, dtype=np.int32)
    vecs = rng.normal(size=(1200, D)).astype(np.float32)
    for op in (lambda: idx.add(vecs[:700], ids[:700]),
               lambda: idx.add(vecs[700:], ids[700:]),
               lambda: idx.add(vecs[:300] + 1.0, ids[:300]),  # overwrites
               lambda: idx.remove(ids[:900]),
               lambda: idx.remove(ids[900:1100]),
               lambda: idx.add(vecs[:50], ids[:50])):
        op()
        idx.flush()
        used = idx.stats()["slabs_used"]
        moves.append((used - used0, alloc.get() - recl.get()))
    assert [m for m, _ in moves] == [c for _, c in moves]
    assert alloc.get() > 0 and recl.get() > 0
    assert recl.get() <= alloc.get()
