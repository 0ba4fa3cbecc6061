"""The port's comparison baselines against the JAX reference, on the CPU.

``repro_torch.baselines`` (Flat, ContiguousIVF, LSH, HNSW-lite) and
``repro_torch.core.ReferenceIndex`` beside ``repro.baselines`` and
``repro.core.ReferenceIndex``. Each twin starts from one state: the
reference engine takes a first batch, and its arrays are carried into the
port's engine through ``interop.load_baseline_state``; at the end the
port's state is carried back into a fresh reference engine, and both go
on. The same ops then run on both, in fixed batch shapes (8 rows, 5
queries) so that the reference compiles each shape once. After every op:

  * every plane ``==`` (buffers, ids, counts, cursors, ``n_relayouts``);
  * the reports ``==``;
  * searches: labels ``==`` and distances allclose(rtol=atol=1e-5) (the
    products sum in another order).

The reference's quirks are part of what is held (``repro_torch.baselines``
numbers them): ``-1`` ids ranked but not stored in ContiguousIVF (a later
row of the batch lands beyond the list's count), ``-1`` rows appended and
counted by Flat, chosen ``+inf`` entries keeping the id stored there, and
the overflow undo deleting earlier copies of the batch's ids.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sivf_torch
from repro import baselines as jb
from repro.baselines import lsh as jlsh
from repro.core.reference import ReferenceIndex as JReferenceIndex
from repro_torch import baselines as tb
from repro_torch import interop
from repro_torch.baselines import lsh as tlsh
from repro_torch.core import ReferenceIndex
from repro_torch.core.api import IndexProtocol
from repro_torch.kernels.topk import topk as topk_kernel

D, B, Q, K = 16, 8, 5, 4
TOL = 1e-5


def report_tuple(r):
    t = dataclasses.astuple(r)
    return t[:5] + (int(r.errors),) + t[6:]


def ref_planes(eng) -> dict:
    """The reference engine's state under the port's plane names."""
    names = interop.BASELINE_PLANES[type(eng).__name__]
    return {n: np.array(getattr(eng, n)) for n in names}


def set_ref_planes(eng, planes: dict):
    for name, a in planes.items():
        cur = getattr(eng, name)
        setattr(eng, name, int(a) if isinstance(cur, int)
                else jnp.asarray(a, cur.dtype))
    return eng


class Twin:
    """A reference engine and the port's on the CPU, one op at a time."""

    def __init__(self, j, t):
        self.j, self.t = j, t
        interop.load_baseline_state(self.t, ref_planes(self.j))
        self.planes_equal("start")

    def planes_equal(self, what: str) -> None:
        jp, tp = ref_planes(self.j), interop.baseline_state_to_numpy(self.t)
        assert set(jp) == set(tp)
        for name in jp:
            np.testing.assert_array_equal(tp[name], jp[name],
                                          err_msg=f"{what}: {name}")

    def add(self, vecs, ids):
        rj, rt = self.j.add(vecs, ids), self.t.add(vecs, ids)
        assert report_tuple(rt) == report_tuple(rj)
        self.planes_equal(f"add {list(ids)}")
        return rt

    def remove(self, ids):
        rj, rt = self.j.remove(ids), self.t.remove(ids)
        assert report_tuple(rt) == report_tuple(rj)
        self.planes_equal(f"remove {list(ids)}")
        return rt

    def search(self, qs, k=K, nprobe=None):
        rj = self.j.search(qs, k, nprobe)
        rt = self.t.search(qs, k, nprobe)
        assert (rt.k, rt.nprobe, rt.padded_to) == (rj.k, rj.nprobe,
                                                   rj.padded_to)
        np.testing.assert_array_equal(rt.labels.numpy(),
                                      np.asarray(rj.labels))
        np.testing.assert_allclose(rt.distances.numpy(),
                                   np.asarray(rj.distances), rtol=TOL,
                                   atol=TOL)
        return rt

    def carried_back(self, fresh_j) -> "Twin":
        """A twin whose reference engine starts from the port's state."""
        set_ref_planes(fresh_j, interop.baseline_state_to_numpy(self.t))
        return Twin(fresh_j, self.t)


def ids_of(*xs) -> np.ndarray:
    return np.array(xs, np.int32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(200, D)).astype(np.float32),
            rng.normal(size=(Q, D)).astype(np.float32),
            rng.normal(size=(4, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# Flat
# ---------------------------------------------------------------------------

def test_flat_matches_the_reference_op_by_op(data):
    x, qs, _ = data
    j = jb.FlatIndex(D, 40)
    j.insert(x[:B], np.arange(B, dtype=np.int32))
    tw = Twin(j, tb.FlatIndex(D, 40, device="cpu"))
    rep = tw.add(x[8:16], ids_of(-1, 8, 9, -1, 10, 11, 12, 13))
    assert (rep.requested, rep.accepted, rep.n_live) == (6, 8, 16)  # quirk 2
    tw.search(qs)
    tw.add(x[16:24], ids_of(8, 8, 20, 21, 22, 23, 24, 25))       # repeats
    rep = tw.remove(ids_of(8, 100, 101, 3, -1, 200, 201, 202))
    assert rep.accepted == 6      # three rows of id 8, 3, two -1 rows
    tw.search(qs)
    reps = [tw.add(x[lo:lo + B], np.arange(lo, lo + B, dtype=np.int32))
            for lo in (24, 32, 40, 48)]                 # past capacity
    assert [r.rejected for r in reps] == [0, 0, 2, B]
    assert tw.t.n_live == 40
    res = tw.search(qs, k=40)                            # every row
    assert np.isfinite(res.distances.numpy()).all()
    tw = tw.carried_back(jb.FlatIndex(D, 40))
    tw.remove(np.arange(20, 28, dtype=np.int32))
    tw.search(qs)


def test_flat_search_picks_inf_with_the_stored_label(data):
    x, qs, _ = data
    tw = Twin(jb.FlatIndex(D, 16), tb.FlatIndex(D, 16, device="cpu"))
    tw.add(x[:B], ids_of(-1, 5, 6, -1, -1, -1, -1, -1))
    res = tw.search(qs, k=K)            # two live rows, then +inf rows
    assert np.isinf(res.distances.numpy()[:, 2:]).all()
    assert (res.labels.numpy()[:, 2:] == -1).all()


# ---------------------------------------------------------------------------
# ContiguousIVF
# ---------------------------------------------------------------------------

def near(cents, li, n, rng, scale=1e-2):
    return (cents[li] + scale * rng.normal(size=(n, D))).astype(np.float32)


def test_contiguous_ivf_matches_the_reference_op_by_op(data):
    x, qs, cents = data
    rng = np.random.default_rng(1)
    j = jb.ContiguousIVF(cents, list_cap=4)
    j.insert(np.concatenate([near(cents, 2, 3, rng), near(cents, 3, 5, rng)]),
             np.arange(B, dtype=np.int32))
    tw = Twin(j, tb.ContiguousIVF(cents, list_cap=4, device="cpu"))
    # quirk 1: the -1 takes rank 0 in list 0, so id 51 lands at slot 2,
    # beyond the list's count of 2, where no search sees it
    rep = tw.add(np.concatenate([near(cents, 0, 3, rng),
                                 near(cents, 1, 5, rng)]),
                 ids_of(-1, 50, 51, 60, 61, -1, -1, -1))
    assert rep.accepted == 4 and rep.requested == 4
    assert tw.t.ids[0, :3].tolist() == [-1, 50, 51]
    assert int(tw.t.counts[0]) == 2
    # quirk 3: with one list probed the +inf slots keep their stored ids
    near0 = near(cents, 0, Q, rng)
    res = tw.search(near0, k=4, nprobe=1)
    assert np.isinf(res.distances.numpy()[:, 2:]).all()
    assert 51 in res.labels.numpy()[:, 2:]
    # list 1 overflows its 4 slots: undo by delete(ids), which also drops
    # the earlier copy of id 61 (quirk 4), grow 2x, retry
    before = tw.t.n_relayouts
    rep = tw.add(near(cents, 1, B, rng), ids_of(61, 70, 71, 72, 73, 74,
                                                75, 76))
    assert tw.t.n_relayouts > before
    assert int((tw.t.ids == 61).sum()) == 1
    tw.search(qs, nprobe=2)
    tw.remove(ids_of(300, 301, -1, 50, 70, 71, 302, 303))   # absent, -1
    tw.search(qs, nprobe=None)
    tw.add(x[:B], np.arange(100, 108, dtype=np.int32))
    tw.search(qs, nprobe=3)
    tw = tw.carried_back(jb.ContiguousIVF(cents, list_cap=4))
    tw.add(x[B:2 * B], np.arange(110, 118, dtype=np.int32))
    tw.remove(np.arange(100, 108, dtype=np.int32))
    tw.search(qs, nprobe=2)
    assert tw.t.stats() == tw.j.stats()


# ---------------------------------------------------------------------------
# LSH
# ---------------------------------------------------------------------------

def lsh_pair(cap=4, bits=2, tables=3):
    j = jb.LSHIndex(jax.random.key(2), D, n_tables=tables, bits=bits,
                    bucket_cap=cap)
    t = tb.LSHIndex(torch.Generator().manual_seed(0), D, n_tables=tables,
                    bits=bits, bucket_cap=cap, device="cpu")
    return j, t


def test_lsh_codes_match_the_reference(data):
    """Codes are signs of plane . x, which may flip where |plane . x| is
    near zero and the sums run in another order: the data here has no
    |plane . x| below 1e-4, so the codes must be ``==``."""
    x, qs, _ = data
    j, t = lsh_pair()
    interop.load_baseline_state(t, ref_planes(j))
    for v in (x, qs):
        dots = np.einsum("lbd,nd->nlb", np.asarray(j.planes, np.float64), v)
        assert np.abs(dots).min() > 1e-4
        np.testing.assert_array_equal(
            tlsh.codes_of(t.planes, torch.from_numpy(v)).numpy(),
            np.asarray(jlsh._codes(j.planes, jnp.asarray(v))))


def test_lsh_matches_the_reference_op_by_op(data):
    x, qs, _ = data
    j, t = lsh_pair()
    j.insert(x[:B], np.arange(B, dtype=np.int32))
    tw = Twin(j, t)
    tw.add(x[8:16], ids_of(-1, 8, 9, -1, 10, 11, 12, 13))
    for lo in (16, 24):                                   # buckets fill up
        rep = tw.add(x[lo:lo + B], np.arange(lo, lo + B, dtype=np.int32))
    assert rep.rejected > 0
    res = tw.search(qs, k=12)        # 3 tables x 4 slots: all candidates
    assert np.isinf(res.distances.numpy()).any()       # deduped / empty
    tw.remove(ids_of(3, 300, -1, 9, 301, 302, 303, 304))
    tw.add(x[32:40], ids_of(3, 3, 40, 41, 42, 43, 44, 45))   # repeats
    tw.search(qs)
    tw = tw.carried_back(lsh_pair()[0])
    tw.remove(np.arange(8, 16, dtype=np.int32))
    tw.search(qs, k=6)


# ---------------------------------------------------------------------------
# HNSW-lite
# ---------------------------------------------------------------------------

def test_hnsw_graph_and_results_match_the_reference(data):
    x, qs, _ = data
    j, t = jb.HNSWLite(8, m=4, ef=8), tb.HNSWLite(8, m=4, ef=8)
    xs = np.ascontiguousarray(x[:40, :8])
    ids = np.arange(40, dtype=np.int32)

    def same(what):
        assert t.links == j.links and t.entry == j.entry, what
        assert list(t.vecs) == list(j.vecs), what
        rj, rt = j.search(qs[:, :8], K), t.search(qs[:, :8], K)
        assert rt.distances.dtype == torch.float32
        assert rt.labels.dtype == torch.int64
        np.testing.assert_array_equal(rt.distances.numpy(), rj.distances)
        np.testing.assert_array_equal(rt.labels.numpy(), rj.labels)

    assert report_tuple(t.add(xs, ids)) == report_tuple(j.add(xs, ids))
    same("add")
    gone = ids[::4]                                      # full rebuild
    assert report_tuple(t.remove(gone)) == report_tuple(j.remove(gone))
    assert t.n_live == 30
    same("remove")


# ---------------------------------------------------------------------------
# the oracle, the protocol, the chunked search
# ---------------------------------------------------------------------------

def test_reference_index_matches_the_reference(data):
    x, qs, cents = data
    j, t = JReferenceIndex(cents), ReferenceIndex(cents)
    ids = np.arange(60)
    ids[5] = -1
    for eng in (j, t):
        eng.insert(x[:60], ids)
        eng.insert(x[60:70], np.arange(10))           # overwrites
        eng.delete([3, 4, 500])
    assert t.n_live == j.n_live == 58
    np.testing.assert_array_equal(t.assign(x), j.assign(x))
    for nprobe in (1, 2, 4):
        for a, b in zip(t.search(qs, K, nprobe), j.search(qs, K, nprobe)):
            np.testing.assert_array_equal(a, b)


def test_index_and_baselines_satisfy_protocol(data):
    x, _, cents = data
    cfg = sivf_torch.SIVFConfig(dim=D, n_lists=4, n_slabs=64, capacity=32,
                                n_max=1 << 10)
    engines = [sivf_torch.Index(cfg, cents, device="cpu"),
               tb.FlatIndex(D, 64, device="cpu"),
               tb.ContiguousIVF(cents, list_cap=32, device="cpu"),
               tb.LSHIndex(torch.Generator().manual_seed(0), D,
                           bucket_cap=64, device="cpu"),
               tb.HNSWLite(D)]
    vecs = x[:20]
    for eng in engines:
        assert isinstance(eng, IndexProtocol), type(eng)
        rep = eng.add(vecs, np.arange(20))
        assert rep.accepted == 20, type(eng)
        d, lab = eng.search(vecs[:3], 4)               # tuple-compat unpack
        assert tuple(d.shape) == tuple(lab.shape) == (3, 4)
        assert eng.remove(np.arange(10)).accepted == 10
        assert eng.stats()["n_live"] == eng.n_live == 10


def test_chunked_search_equals_one_chunk(data, monkeypatch):
    """Queries are cut into chunks from shapes alone; rows are independent,
    so any cut gives the same labels, and distances up to the order in
    which the library's product sums (it may pick it by the chunk's
    shape). The top-k runs its plain version on the CPU: no kernel launch
    is counted."""
    x, qs, cents = data
    engines = [tb.FlatIndex(D, 64, device="cpu"),
               tb.ContiguousIVF(cents, list_cap=16, device="cpu"),
               tb.LSHIndex(torch.Generator().manual_seed(0), D, bits=3,
                           bucket_cap=16, device="cpu")]
    many = np.concatenate([qs, x[100:111]])               # 16 queries
    launches = topk_kernel.launches
    for eng in engines:
        eng.add(x[:48], np.arange(48))
        whole = eng.search(many, K, 2)
        monkeypatch.setattr(tb, "CHUNK_BYTES", 1)        # a query a chunk
        assert len(tb.query_chunks(16, 10)) == 16
        cut = eng.search(many, K, 2)
        monkeypatch.undo()
        assert torch.equal(cut.labels, whole.labels)
        torch.testing.assert_close(cut.distances, whole.distances,
                                   rtol=TOL, atol=TOL)
    assert tb.query_chunks(0, 10) == [slice(0, 0)]
    assert topk_kernel.launches == launches


@pytest.mark.parametrize("nprobe", [None, 2])
def test_search_chunks_follow_query_bytes(data, monkeypatch, nprobe):
    """Every engine sizes a search's chunks by ``query_bytes(nprobe)``
    (``nprobe`` unused by Flat and LSH; ``None`` is every list of a
    ContiguousIVF), so a caller counts the top-k calls a search makes
    from shapes alone."""
    x, qs, cents = data
    from repro_torch.kernels.topk import ops as topk_ops
    calls = []

    def counting(d, lab, k):
        calls.append(tuple(d.shape))
        return topk_ops.topk_ref(d, lab, k)
    many = np.concatenate([qs, x[100:111]])               # 16 queries
    for eng in (tb.FlatIndex(D, 64, device="cpu"),
                tb.ContiguousIVF(cents, list_cap=16, device="cpu"),
                tb.LSHIndex(torch.Generator().manual_seed(0), D, bits=3,
                            bucket_cap=16, device="cpu")):
        eng.add(x[:48], np.arange(48))
        monkeypatch.setattr(tb, "CHUNK_BYTES", 3 * eng.query_bytes(nprobe))
        monkeypatch.setattr(topk_ops, "topk", counting)
        calls.clear()
        eng.search(many, K, nprobe)
        chunks = tb.query_chunks(16, eng.query_bytes(nprobe))
        monkeypatch.undo()
        assert len(calls) == len(chunks) == 6, type(eng)
        assert [c[0] for c in calls] == [3] * 5 + [1], type(eng)


def test_state_crossing_checks_planes_and_dtypes(data):
    _, _, cents = data
    t = tb.ContiguousIVF(cents, list_cap=4, device="cpu")
    planes = interop.baseline_state_to_numpy(t)
    with pytest.raises(ValueError, match="missing"):
        interop.load_baseline_state(t, {"buf": planes["buf"]})
    with pytest.raises(ValueError, match="dtype"):
        interop.load_baseline_state(t, {**planes, "ids": planes["ids"]
                                        .astype(np.int64)})


# ---------------------------------------------------------------------------
# the device: the card by default, the kernel off the CPU
# ---------------------------------------------------------------------------

def device_engines(device, cents):
    return [tb.FlatIndex(D, 64, device=device),
            tb.ContiguousIVF(cents, list_cap=16, device=device),
            tb.LSHIndex(torch.Generator().manual_seed(0), D, bits=3,
                        bucket_cap=16, device=device)]


def test_device_baselines_default_to_the_card(data):
    _, _, cents = data
    if torch.cuda.is_available():
        assert all(e.ids.is_cuda if hasattr(e, "ids") else
                   e.bucket_ids.is_cuda
                   for e in device_engines("cuda", cents))
    else:
        for make in (lambda: tb.FlatIndex(D, 64),
                     lambda: tb.ContiguousIVF(cents, list_cap=16),
                     lambda: tb.LSHIndex(torch.Generator(), D)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


def test_searches_off_the_cpu_reach_the_kernel_wrapper(data, monkeypatch):
    """On a tensor that is not on the CPU (``meta`` here), each device
    baseline's search calls kernel 4's wrapper, never the plain version:
    there is no fallback."""
    _, qs, cents = data
    calls = []

    def wrapper(dists, labels, k):
        calls.append((tuple(dists.shape), dists.device.type))
        q = dists.shape[0]
        return (torch.empty((q, k), device=dists.device),
                torch.empty((q, k), dtype=torch.int32, device=dists.device))

    def plain(*args):
        raise AssertionError("plain top-k reached off the CPU")

    monkeypatch.setattr(topk_kernel, "topk_cuda", wrapper)
    monkeypatch.setattr("repro_torch.kernels.topk.ops.topk_ref", plain)
    for eng in device_engines("meta", cents):
        res = eng.search(torch.from_numpy(qs).to("meta"), K, 2)
        assert tuple(res.labels.shape) == (Q, K)
    assert [dev for _, dev in calls] == ["meta"] * 3
    assert calls[0][0] == (Q, 64) and calls[1][0] == (Q, 2 * 16)
