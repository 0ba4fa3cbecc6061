"""The whole slice: ``sivf.Index`` vs ``sivf_torch.Index(device="cpu")``.

The ``examples/quickstart.py`` flow (10k rows in ragged batches, search,
remove, overwrite, a sliding window, deferred reports resolved by one
flush) runs through both handles on the same numpy inputs and the same
centroids. Reports must be identical, search labels ``==`` and distances
allclose(rtol=atol=1e-5), and at the end every integer plane ``==``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import sivf
import sivf_torch
from repro_torch import interop
from repro_torch.core import api as tapi

from test_torch_state import assert_planes_equal, jax_planes

D, N_LISTS = 64, 32


def report_tuple(r):
    t = dataclasses.astuple(r)
    return t[:5] + (int(r.errors),) + t[6:]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    train = rng.normal(size=(2048, D)).astype(np.float32)
    cents = np.asarray(sivf.train_kmeans(jax.random.key(0), train, N_LISTS))
    kw = dict(dim=D, n_lists=N_LISTS, n_slabs=512, capacity=64,
              n_max=1 << 16, max_chain=128)
    return rng, cents, sivf.SIVFConfig(**kw), sivf_torch.SIVFConfig(**kw)


class Pair:
    def __init__(self, setup, **kw):
        self.rng, cents, jcfg, tcfg = setup
        self.j = sivf.Index(jcfg, cents, **kw)
        self.t = sivf_torch.Index(tcfg, cents, device="cpu", **kw)

    def add(self, vecs, ids):
        rj, rt = self.j.add(vecs, ids), self.t.add(vecs, ids)
        if not self.j.deferred:
            assert report_tuple(rt) == report_tuple(rj)
        return rj, rt

    def remove(self, ids):
        rj, rt = self.j.remove(ids), self.t.remove(ids)
        assert report_tuple(rt) == report_tuple(rj)
        return rt

    def search(self, qs, k, nprobe):
        dj, lj = self.j.search(qs, k=k, nprobe=nprobe)
        res = self.t.search(qs, k=k, nprobe=nprobe)
        assert isinstance(res.labels, torch.Tensor)
        assert np.array_equal(res.labels.numpy(), np.asarray(lj))
        np.testing.assert_allclose(res.distances.numpy(), np.asarray(dj),
                                   rtol=1e-5, atol=1e-5)
        return res

    def planes_equal(self):
        assert_planes_equal(jax_planes(self.j.state),
                            interop.state_to_numpy(self.t.state))


def test_quickstart_flow_matches_reference(setup):
    p = Pair(setup)
    rng = p.rng
    vecs = rng.normal(size=(10_000, D)).astype(np.float32)
    lo = 0
    while lo < 10_000:                       # ragged batches
        n = min(int(rng.integers(300, 2048)), 10_000 - lo)
        _, rt = p.add(vecs[lo:lo + n], np.arange(lo, lo + n, dtype=np.int32))
        assert rt.ok and rt.accepted == n
        lo += n
    queries = rng.normal(size=(4, D)).astype(np.float32)
    res = p.search(queries, 10, 8)
    assert res.padded_to == 64 and res.labels.shape == (4, 10)
    assert p.remove(np.arange(5000, dtype=np.int32)).accepted == 5000
    _, rt = p.add(vecs[:64], np.arange(5000, 5064, dtype=np.int32))
    assert rt.overwritten == 64 and rt.accepted == 0
    next_id = 10_000
    for _ in range(5):                        # sliding window
        batch = rng.normal(size=(1000, D)).astype(np.float32)
        new_ids = np.arange(next_id, next_id + 1000, dtype=np.int32)
        assert p.add(batch, new_ids)[1].ok
        p.remove(new_ids - 5000)
        next_id += 1000
    p.search(queries, 10, 8)
    p.search(torch.from_numpy(queries[:3]), 5, None)    # tensor queries
    p.planes_equal()
    sj, st = p.j.stats(), p.t.stats()
    for key in ("n_live", "slabs_used", "free_slabs", "fill_frac",
                "max_chain_len", "list_occupancy", "device_bytes"):
        assert st[key] == pytest.approx(sj[key]), key
    assert p.t.n_live == len(p.t) == p.j.n_live


def test_deferred_flush_matches_eager_reports(setup):
    p = Pair(setup, deferred=True)
    vecs = p.rng.normal(size=(4096, D)).astype(np.float32)
    futs = []
    for lo in range(0, 4096, 1024):
        futs.append(p.add(vecs[lo:lo + 1024],
                          np.arange(lo, lo + 1024, dtype=np.int32)))
    assert not futs[0][1].done and p.t.pending_count == 4
    assert p.t.epoch == p.j.epoch == 4
    reps_j, reps_t = p.j.flush(), p.t.flush()
    assert [report_tuple(r) for r in reps_t] == \
        [report_tuple(r) for r in reps_j]
    assert futs[-1][1].done and futs[-1][1].accepted == 1024
    assert p.t.flush() == [] and p.t.pending_count == 0


def test_single_flush_is_one_host_copy(setup, monkeypatch):
    """``flush`` resolves the whole queue with one device->host copy."""
    _, cents, _, tcfg = setup
    index = sivf_torch.Index(tcfg, cents, device="cpu", deferred=True)
    vecs = np.ones((8, D), np.float32)
    for i in range(5):
        index.add(vecs, np.arange(8 * i, 8 * i + 8, dtype=np.int32))
    copies = []
    real = tapi._resolve_aux

    def counting(auxes):
        copies.append(len(auxes))
        return real(auxes)

    monkeypatch.setattr(tapi, "_resolve_aux", counting)
    assert len(index.flush()) == 5 and copies == [5]


def test_strict_mode_raises_on_both(setup):
    p = Pair(setup, strict=True)
    bad = np.array([1, 2, 1 << 20], np.int32)
    vecs = np.zeros((3, D), np.float32)
    with pytest.raises(sivf.MutationRejected) as ej:
        p.j.add(vecs, bad)
    with pytest.raises(sivf_torch.MutationRejected) as et:
        p.t.add(vecs, bad)
    assert report_tuple(et.value.report) == report_tuple(ej.value.report)
    rep = p.t.add(vecs, bad, strict=False)
    assert rep.errors == sivf_torch.ErrorCode.ID_RANGE
    with sivf_torch.Index(p.t.cfg, setup[1], device="cpu", strict=True,
                          deferred=True) as d:
        d.add(vecs, bad)
        with pytest.raises(sivf_torch.MutationRejected):
            d.flush()


def test_unported_surface_names_its_roadmap_item(setup, tmp_path):
    """The mesh surface is ported (``core/distributed.py``), a tiered
    pool on a mesh included: what raised naming ROADMAP.md queue 1 item
    10 now works, or raises the reference's own usage errors."""
    _, cents, _, tcfg = setup
    index = sivf_torch.Index(tcfg, cents, device="cpu")
    two = sivf_torch.ShardMesh.virtual(2, "cpu")
    # a sidecar marked as the reference's mesh backend writes it, over a
    # single pool's planes: the reference's error without backend=, and a
    # shape check with one
    index.save(tmp_path)
    side = tmp_path / "index.json"
    meta = json.loads(side.read_text())
    side.write_text(json.dumps({**meta, "backend": "mesh", "n_shards": 2}))
    with pytest.raises(ValueError, match="sharded checkpoint: pass backend"):
        sivf_torch.Index.load(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="2-shard mesh state"):
        sivf_torch.Index.load(tmp_path, backend=two)
    m = sivf_torch.Index(tcfg, cents, backend=two)
    assert (m.backend, m.n_shards, m.stats()["n_shards"]) == ("mesh", 2, 2)
    assert index.reshard(two) is index and index.n_shards == 2
    with pytest.raises(TypeError, match="backend must be"):
        sivf_torch.Index(tcfg, cents, backend="mesh", device="cpu")
    tiered = sivf_torch.Index(dataclasses.replace(tcfg, device_slabs=8),
                              cents, backend=two)
    assert tiered.stats()["per_shard_resident"] == [0, 0]
    index = sivf_torch.Index(tcfg, cents, device="cpu")
    # the PQ and filter surface is ported: on a raw index without
    # attributes these are the reference's usage errors
    with pytest.raises(RuntimeError, match="PQConfig"):
        index.train(np.zeros((4, D)))
    with pytest.raises(ValueError, match="attributes"):
        index.search(np.zeros(D), 1, filter=sivf_torch.Eq("tenant", 1))
    with pytest.raises(ValueError, match="attributes"):
        index.add(np.zeros((1, D)), [0], attrs={})
    assert isinstance(index, sivf_torch.IndexProtocol)
    assert index.bucket_shapes(300) == [64, 128, 256, 512]
