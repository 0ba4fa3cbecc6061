"""Persistence of the port against the JAX reference, on the CPU.

  * ``repro_torch.checkpoint.manager`` as ``tests/test_checkpoint.py``
    holds the reference's: round trip, async save, retention, corruption
    detected, structure mismatch, a ``.tmp`` directory never published;
    and for the same leaves it writes the reference manager's files byte
    for byte;
  * a checkpoint either package's ``Index.save`` writes loads into the
    other (raw, raw with attributes, PQ with attributes): every plane
    ``==`` (``norms`` allclose 1e-6, summation order), labels ``==``, raw
    distances allclose(1e-5) and PQ distances bit for bit through one
    shared ADC table (``tests/parity.py``);
  * format-1 and format-2 checkpoints migrate in both packages alike;
  * a tiered save writes the same array files as an untiered save, and
    as the reference's, of the same op sequence; ``load(device_slabs=)``
    retiers;
  * a sidecar claiming shards its planes lack raises the reference's
    error; a single checkpoint loads onto a one-shard mesh (mesh
    checkpoints themselves: ``tests/test_torch_reshard.py``).

Shapes are ``tests/test_torch_pq.py``'s (dim 16, 4 lists, 24 slabs of
32, 64-row batches), so the reference compiles little.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sivf
import sivf_torch
from repro.checkpoint.manager import CheckpointManager as JManager
from repro import core as jcore
from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import index as tix
from repro_torch.core import state as tst

from test_torch_pq import ATTRS, B, D, NL, POOL, codebooks, jadc, jscan_pq
from test_torch_state import assert_planes_equal, jax_planes

KINDS = {"raw": {}, "raw_attrs": {"attributes": ATTRS},
         "pq_attrs": {"attributes": ATTRS, "pq": (8, 5)}}


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

def _leaves(rng):
    return [rng.normal(size=(8, 4)).astype(np.float32),
            torch.from_numpy(rng.integers(0, 9, (3,)).astype(np.int32)),
            np.float32(1.5) * np.ones((), np.float32),
            np.zeros((5, 0, 2), np.uint8)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_manager_round_trip(tmp_path, rng):
    mgr = CheckpointManager(tmp_path)
    leaves = _leaves(rng)
    mgr.save(7, leaves)
    out = mgr.restore(7, leaves)
    for a, b in zip(leaves, out):
        assert b.dtype == _np(a).dtype and np.array_equal(_np(a), b)
    assert mgr.latest_step() == 7
    assert os.readlink(tmp_path / "latest") == "step_00000007"


def test_manager_async_save_snapshots(tmp_path, rng):
    """A non-blocking save writes the leaves as they were when it was
    called, though the caller goes on mutating them in place."""
    mgr = CheckpointManager(tmp_path)
    leaves = _leaves(rng)
    want = [_np(x).copy() for x in leaves]
    mgr.save(1, leaves, blocking=False)
    leaves[1].add_(100)
    leaves[0] += 100
    mgr.wait()
    assert mgr.latest_step() == 1
    for a, b in zip(want, mgr.restore_arrays(1)):
        assert np.array_equal(a, b)


def test_manager_retention_prunes_old(tmp_path, rng):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    leaves = _leaves(rng)
    for s in (1, 2, 3, 4):
        mgr.save(s, leaves)
    assert sorted(mgr.all_steps()) == [3, 4]


def test_manager_corruption_detected(tmp_path, rng):
    mgr = CheckpointManager(tmp_path)
    leaves = _leaves(rng)
    mgr.save(3, leaves)
    path = tmp_path / "step_00000003" / "arr_00000.npy"
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(3, leaves)
    assert len(mgr.restore_arrays(3, verify=False)) == len(leaves)


def test_manager_structure_mismatch_rejected(tmp_path, rng):
    mgr = CheckpointManager(tmp_path)
    leaves = _leaves(rng)
    mgr.save(1, leaves)
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(1, leaves[:1])


def test_manager_tmp_dir_never_published(tmp_path, rng):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _leaves(rng))
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest_step() == 5


def test_manager_writes_the_reference_files(tmp_path, rng):
    """Same leaves, same files: manifest and every ``.npy`` byte for
    byte; each manager restores the other's step; the sidecars alike."""
    leaves = _leaves(rng)
    CheckpointManager(tmp_path / "t").save(2, leaves)
    JManager(tmp_path / "j").save(2, [jnp.asarray(_np(x)) for x in leaves])
    for name in ["manifest.json"] + [f"arr_{i:05d}.npy"
                                     for i in range(len(leaves))]:
        assert (tmp_path / "t" / "step_00000002" / name).read_bytes() == \
            (tmp_path / "j" / "step_00000002" / name).read_bytes(), name
    for a, b in zip(JManager(tmp_path / "t").restore_arrays(2),
                    CheckpointManager(tmp_path / "j").restore_arrays(2)):
        assert np.array_equal(a, b)
    meta = {"format": 3, "cfg": {"dim": 4}}
    CheckpointManager(tmp_path / "t").save_metadata("index", meta)
    JManager(tmp_path / "j").save_metadata("index", meta)
    assert (tmp_path / "t" / "index.json").read_bytes() == \
        (tmp_path / "j" / "index.json").read_bytes()


# ---------------------------------------------------------------------------
# Index checkpoints across the packages
# ---------------------------------------------------------------------------

def _configs(kind, **extra):
    kw = dict(dim=D, n_lists=NL, **POOL, **extra)
    spec = dict(KINDS[kind])
    pq = spec.pop("pq", None)
    jcfg = sivf.SIVFConfig(pq=None if pq is None else sivf.PQConfig(*pq),
                           **kw, **spec)
    tcfg = sivf_torch.SIVFConfig(
        pq=None if pq is None else sivf_torch.PQConfig(*pq), **kw, **spec)
    return jcfg, tcfg


def _attrs(cfg, rng, n):
    if not cfg.n_attrs:
        return None
    return {"tenant": rng.integers(0, 4, n), "ts": rng.integers(0, 50, n)}


def drive(indexes, cfg, seed=0):
    """Adds, an overwrite, removes (bad ids included), all in ``B``-row
    batches, on every handle alike."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(3 * B, D)).astype(np.float32)
    ops = [("add", vecs[:B], np.arange(B), _attrs(cfg, rng, B)),
           ("add", vecs[B:2 * B], np.arange(B, 2 * B), _attrs(cfg, rng, B)),
           ("add", vecs[2 * B:], np.arange(2 * B, 3 * B),
            _attrs(cfg, rng, B)),
           ("add", vecs[:40] + 1, np.arange(40), _attrs(cfg, rng, 40)),
           ("remove", np.arange(50, 150, 2)),
           ("remove", np.array([5, 5, 9999, -1]))]
    for op in ops:
        for x in indexes:
            if op[0] == "add":
                x.add(op[1], op[2], attrs=op[3])
            else:
                x.remove(op[1])
    return indexes


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request):
    """(kind, reference handle, port handle) after the same ops."""
    kind = request.param
    jcfg, tcfg = _configs(kind)
    rng = np.random.default_rng(11)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    cb = None if jcfg.pq is None else codebooks(rng, jcfg.pq.m,
                                                jcfg.pq.nbits)
    j = sivf.Index(jcfg, jnp.asarray(cents), pq_codebooks=cb, min_bucket=B)
    t = sivf_torch.Index(tcfg, cents, device="cpu", pq_codebooks=cb,
                         min_bucket=B)
    return (kind,) + drive((j, t), tcfg)


def assert_same_search(j, t, rng):
    """Labels ``==``; raw distances allclose(1e-5); PQ distances bit for
    bit when the port's scan is fed the reference's ADC table."""
    qs = rng.normal(size=(6, D)).astype(np.float32)
    for nprobe in (2, NL):
        dj, lj = j.search(qs, 10, nprobe)
        res = t.search(qs, 10, nprobe)
        assert np.array_equal(res.labels.numpy(), np.asarray(lj))
        np.testing.assert_allclose(res.distances.numpy(), np.asarray(dj),
                                   rtol=1e-5, atol=1e-5)
    if t.cfg.pq is None:
        return
    lists = jcore.probe(j.state.centroids, jnp.asarray(qs), NL,
                        t.cfg.metric)
    table = jcore.gather_tables(j.cfg, j.state, lists)
    adc = jadc(j.state.pq_codebooks, jnp.asarray(qs), t.cfg.metric)
    jd, jl = jscan_pq(j.cfg, j.state, jnp.asarray(qs), table, 10, adc=adc)
    td, tl = tix.scan_slabs_topk_pq(
        t.cfg, t.state, torch.from_numpy(qs),
        torch.from_numpy(np.array(table)), 10,
        adc=torch.from_numpy(np.array(adc)))
    assert np.array_equal(td.numpy(), np.asarray(jd))       # bit for bit
    assert np.array_equal(tl.numpy(), np.asarray(jl))


def test_reference_checkpoint_loads_into_port(pair, tmp_path, rng):
    kind, j, t = pair
    j.save(tmp_path)
    loaded = sivf_torch.Index.load(tmp_path, device="cpu")
    assert loaded.cfg == t.cfg and loaded.min_bucket == B
    assert loaded.state.data.device.type == "cpu"
    assert_planes_equal(jax_planes(j.state),
                        interop.state_to_numpy(loaded.state))
    assert_same_search(j, loaded, rng)
    # the loaded handle goes on mutating like the reference's
    more = rng.normal(size=(8, D)).astype(np.float32)
    attrs = _attrs(t.cfg, rng, 8)
    assert loaded.add(more, np.arange(500, 508), attrs=attrs).accepted == 8


def test_port_checkpoint_loads_into_reference(pair, tmp_path, rng):
    kind, j, t = pair
    t.save(tmp_path)
    meta = json.loads((tmp_path / "index.json").read_text())
    assert (meta["format"], meta["impl"], meta["block_q"]) == (3, "xla", 8)
    manifest = json.loads(
        (tmp_path / "step_00000000" / "manifest.json").read_text())
    assert [a["dtype"] for a in manifest["arrays"]][3] == "uint32"
    back = sivf.Index.load(tmp_path)
    assert back.cfg == j.cfg and back.state.bitmap.dtype == jnp.uint32
    assert_planes_equal(jax_planes(back.state),
                        interop.state_to_numpy(t.state))
    assert_same_search(back, t, rng)


@pytest.mark.parametrize("fmt", [1, 2])
def test_old_formats_migrate(tmp_path, rng, fmt):
    """A format-1 (no PQ planes, no attrs) or format-2 (no attrs)
    checkpoint: both packages fill the missing trailing planes fresh and
    load the same state."""
    _, j, t = _raw_pair()
    j.save(tmp_path)
    step = tmp_path / "step_00000000"
    manifest = json.loads((step / "manifest.json").read_text())
    n_miss = {1: 3, 2: 1}[fmt]
    for a in manifest["arrays"][-n_miss:]:
        os.remove(step / a["file"])
    manifest["arrays"] = manifest["arrays"][:-n_miss]
    (step / "manifest.json").write_text(json.dumps(manifest))
    meta = json.loads((tmp_path / "index.json").read_text())
    meta["format"] = fmt
    if fmt == 1:                      # the keys format 2 added
        meta.pop("pq_trained")
        meta.pop("routing")
    (tmp_path / "index.json").write_text(json.dumps(meta))
    mine = sivf_torch.Index.load(tmp_path, device="cpu")
    theirs = sivf.Index.load(tmp_path)
    assert_planes_equal(jax_planes(theirs.state),
                        interop.state_to_numpy(mine.state))
    assert_planes_equal(jax_planes(j.state),
                        interop.state_to_numpy(mine.state))
    assert_same_search(theirs, mine, rng)


_RAW = {}


def _raw_pair():
    """The raw pair, built once for the migration cases."""
    if not _RAW:
        jcfg, tcfg = _configs("raw")
        cents = np.random.default_rng(11).normal(size=(NL, D)).astype(
            np.float32)
        j = sivf.Index(jcfg, jnp.asarray(cents), min_bucket=B)
        t = sivf_torch.Index(tcfg, cents, device="cpu", min_bucket=B)
        _RAW["pair"] = ("raw",) + drive((j, t), tcfg)
    return _RAW["pair"]


def test_tiered_save_writes_the_untiered_arrays(tmp_path, rng):
    """A tiered index (frames churned by searches) saves the same array
    files as an untiered port index and as the reference after the same
    ops; loading retiers either way."""
    jcfg, tcfg = _configs("raw_attrs")
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    it = sivf_torch.Index(dataclasses.replace(tcfg, device_slabs=10), cents, device="cpu", min_bucket=B)
    flat = sivf_torch.Index(tcfg, cents, device="cpu", min_bucket=B)
    j = sivf.Index(jcfg, jnp.asarray(cents), min_bucket=B)
    qs = rng.normal(size=(4, D)).astype(np.float32)
    drive((it, flat, j), tcfg, seed=3)
    it.search(qs, 5, 1)
    assert it.stats()["cache_uploads"] > 0
    for name, x in (("tiered", it), ("flat", flat), ("ref", j)):
        x.save(tmp_path / name)
    files = sorted(os.listdir(tmp_path / "flat" / "step_00000000"))
    assert len(files) == len(tst.PLANES) + 1
    # the reference's norms differ in the last bit (summation order), so
    # its norms file and the manifest holding that file's digest are
    # compared by value
    by_value = {"arr_00002.npy", "manifest.json"}
    for f in files:
        want = (tmp_path / "flat" / "step_00000000" / f).read_bytes()
        for other in ("tiered", "ref"):
            if other == "ref" and f in by_value:
                continue
            got = (tmp_path / other / "step_00000000" / f).read_bytes()
            assert got == want, (other, f)
    norms = [np.load(tmp_path / n / "step_00000000" / "arr_00002.npy")
             for n in ("flat", "ref")]
    np.testing.assert_allclose(norms[0], norms[1], rtol=1e-6)
    side = {n: json.loads((tmp_path / n / "index.json").read_text())
            for n in ("tiered", "flat")}
    assert side["tiered"]["cfg"]["device_slabs"] == 10
    side["tiered"]["cfg"]["device_slabs"] = None
    assert side["tiered"] == side["flat"]
    # retier on load: tiered -> untiered, untiered -> tiered, both ==
    want = flat.search(qs, 10, NL)
    for path, ds in (("tiered", None), ("flat", 12), ("ref", 12)):
        x = sivf_torch.Index.load(tmp_path / path, device="cpu",
                                  device_slabs=ds)
        assert x.cfg.device_slabs == ds
        assert (x.state.data.shape[0] == 0) == (ds is not None)
        res = x.search(qs, 10, NL)
        assert torch.equal(res.labels, want.labels)
        if path == "ref":             # the reference's norms (last bit)
            torch.testing.assert_close(res.distances, want.distances,
                                       rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(res.distances, want.distances)


def test_mesh_checkpoint_raises_naming_item_10(tmp_path):
    """Mesh checkpoints are ported (``tests/test_torch_reshard.py`` loads
    real ones across shard counts). A sidecar that claims shards its
    planes do not have raises the reference's own error in the port; a
    jax mesh is no backend of the port; a single checkpoint loads onto a
    one-shard mesh."""
    jcfg, _ = _configs("raw")
    j = sivf.Index(jcfg, jnp.zeros((NL, D), jnp.float32), min_bucket=B)
    j.save(tmp_path)
    side = tmp_path / "index.json"
    meta = json.loads(side.read_text())
    for patch in ({"backend": "mesh", "n_shards": 2},
                  {"backend": "single", "n_shards": 4}):
        side.write_text(json.dumps({**meta, **patch}))
        with pytest.raises(ValueError) as ej:
            sivf.Index.load(tmp_path)
        with pytest.raises(ValueError) as et:
            sivf_torch.Index.load(tmp_path, device="cpu")
        assert str(et.value) == str(ej.value)
    side.write_text(json.dumps(meta))
    with pytest.raises(TypeError, match="ShardMesh"):
        sivf_torch.Index.load(tmp_path, backend=jax.make_mesh((1,),
                                                              ("data",)),
                              device="cpu")
    m = sivf_torch.Index.load(tmp_path,
                              backend=sivf_torch.ShardMesh.virtual(1, "cpu"))
    assert (m.backend, m.n_shards, m.n_live) == ("mesh", 1, 0)
