"""The port's model-axis plan against the JAX reference, on the CPU.

Every plan of the reference's ``make_plan`` for the ten registered
architectures on both production meshes ((data 16, model 16) and (pod 2,
data 16, model 16)), three shape kinds and global batches 256 and 1 is
``dataclasses.asdict``-``==`` the port's; the reference's plan tests
(``tests/test_sharding.py``) pass through the port; ``spec_for``,
``param_shardings``, ``cache_shardings``, ``input_shardings`` and
``state_specs(zero1=True)`` are ``==`` the reference's ``PartitionSpec``s
read as tuples; ``logical_axes`` names every parameter with the
reference's axes (its period stack's leading ``None`` dropped); the
abstract parameters on the ``meta`` device have the reference's
``jax.eval_shape`` shapes leaf by leaf; the mesh and its collectives.
The reference's specs are built on a ``jax.sharding.AbstractMesh`` of the
production shape, so no device is needed.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.sharding import axes as jaxes
from repro.sharding import rules as jrules
from repro.train import train_step as jts
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.launch.mesh import ModelMesh
from repro_torch.models import model as M
from repro_torch.sharding import axes, rules
from repro_torch.train import train_step as ts

SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
MESHES = {"single": SINGLE, "multi": MULTI}


def jmesh(shape: dict):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def as_tuple(sharding) -> tuple:
    """A reference ``NamedSharding`` / ``PartitionSpec`` read as a tuple."""
    spec = getattr(sharding, "spec", sharding)
    return tuple(spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_plan_equals_the_reference(name, mesh):
    """The cases of ``tests/test_sharding.py:17-75``: every shape kind,
    a shardable and an unshardable global batch."""
    for kind in ("train", "prefill", "decode"):
        for gb in (256, 1, None):
            port = rules.make_plan(get_arch(name), MESHES[mesh], kind, gb)
            ref = jrules.make_plan(JARCHS[name], MESHES[mesh], kind, gb)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), \
                (name, mesh, kind, gb)
            assert port.rules_dict == ref.rules_dict
            assert port.group_size == ref.group_size


@pytest.mark.parametrize("arch,hq,hkv,kv_sharded", [
    ("llama3-8b", 32, 8, False),
    ("qwen3-14b", 48, 8, False),
    ("phi3-medium-14b", 48, 12, False),     # candidate A (g = 4)
    ("llava-next-34b", 64, 8, False),
    ("granite-moe-3b-a800m", 32, 8, False),  # candidate B, 24 -> 32
    ("moonshot-v1-16b-a3b", 16, 16, True),
    ("minicpm3-4b", 48, 48, True),
    ("rwkv6-3b", 48, 48, True),
    ("jamba-v0.1-52b", 32, 8, False),
    ("whisper-base", 16, 16, True),
])
def test_head_padding_policy(arch, hq, hkv, kv_sharded):
    """The reference's table (``tests/test_sharding.py:17-49``)."""
    cfg = get_arch(arch)
    plan = rules.make_plan(cfg, SINGLE, "train", 256)
    assert (plan.n_heads_padded, plan.n_kv_heads_padded,
            plan.kv_sharded) == (hq, hkv, kv_sharded)
    assert plan.n_heads_padded % plan.n_kv_heads_padded == 0
    assert plan.n_heads_padded >= cfg.n_heads
    assert plan.vocab_padded % (16 * 128) == 0
    assert plan.vocab_padded >= cfg.vocab_size
    if cfg.moe:
        assert plan.n_experts_padded % 16 == 0
        assert plan.n_experts_padded >= cfg.n_experts


def test_decode_cache_shards_exactly_one_model_axis():
    for name, cfg in ARCHS.items():
        if cfg.attention == "none" and cfg.block == "rwkv":
            continue
        r = rules.make_plan(cfg, SINGLE, "decode", 128).rules_dict
        head_rule = r["heads" if cfg.attention == "mla" else "kv_heads"]
        on_model = [x for x in (head_rule, r["kv_dh"]) if x == "model"]
        assert len(on_model) == 1, name
        assert r["kv_seq"] is None
    r = rules.make_plan(get_arch("jamba-v0.1-52b"), MULTI, "decode",
                        1).rules_dict
    assert r["batch"] is None and r["kv_dh"] == "model"


def test_plans_of_the_model_axis_phase():
    """The chip's cells: Granite on (1, 16) and (2, 8), Phi-3 on (1, 16)."""
    g = get_arch("granite-moe-3b-a800m")
    p = rules.make_plan(g, {"data": 1, "model": 16}, "decode", 1)
    assert (p.n_heads_padded, p.n_kv_heads_padded, p.kv_sharded,
            p.vocab_padded, p.n_experts_padded) == (32, 8, False, 51200, 48)
    assert p.rules_dict["kv_dh"] == "model"
    p = rules.make_plan(g, {"data": 2, "model": 8}, "decode", 1)
    assert (p.n_heads_padded, p.n_kv_heads_padded, p.kv_sharded,
            p.vocab_padded, p.n_experts_padded) == (24, 8, True, 50176, 40)
    assert p.rules_dict["batch"] is None
    p = rules.make_plan(get_arch("phi3-medium-14b"),
                        {"data": 1, "model": 16}, "prefill", 1)
    assert (p.n_heads_padded, p.n_kv_heads_padded, p.kv_sharded) == \
        (48, 12, False)
    from repro_torch.models.attention import _maybe_repeat_kv
    assert _maybe_repeat_kv(p, p.group_size)


def test_spec_resolution_and_rules_context():
    r = rules.make_plan(get_arch("llama3-8b"), SINGLE, "train",
                        256).rules_dict
    assert axes.spec_for(("embed", "mlp"), r) == (None, "model")
    assert axes.spec_for(("batch", "seq_sp", None), r) == \
        ("data", "model", None)
    assert axes.spec_for((None, None), r) == (None, None)
    assert axes.spec_for(("embed",)) == ()
    with axes.use_rules(r):
        assert axes.current_rules() is r
        assert axes.spec_for(("vocab", "embed")) == ("model", None)
        assert axes.specs_tree({"w": ("embed", "heads")}) == \
            {"w": (None, "model")}
    assert axes.current_rules() is None
    jr = jrules.make_plan(JARCHS["llama3-8b"], SINGLE, "train",
                          256).rules_dict
    for ax in (("embed", "mlp"), ("batch", "seq_sp", None),
               (None, "batch", "kv_seq", "kv_heads", "kv_dh"),
               ("expert", None, None)):
        assert axes.spec_for(ax, r) == as_tuple(jaxes.spec_for(ax, jr))


def ref_axes(name: str, plan):
    """The reference's annotated abstract tree of ``name`` (full size)."""
    return jspecs.abstract_params(JARCHS[name], plan, max_seq=16)


def port_path_in_ref(cfg, name: str) -> tuple:
    """A port parameter name -> (path in the reference's tree, whether the
    reference stacks it)."""
    parts = name.split(".")
    if parts[0] == "layers":
        li = int(parts[1])
        return ("layers", li % cfg.layer_period, *parts[2:]), True
    if parts[:2] == ["encoder", "layers"]:
        return ("encoder", "layers", *parts[3:]), True
    return tuple(parts), False


def ref_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_logical_axes_and_abstract_params_match_the_reference(name):
    """Every port parameter carries the reference's logical axes and its
    abstract (``meta``) shape; the two trees hold the same leaves."""
    cfg = get_arch(name)
    for mesh in (None, SINGLE):
        plan = rules.make_plan(cfg, mesh, "train", 256)
        jplan = jrules.make_plan(JARCHS[name], mesh, "train", 256)
        jtree = ref_axes(name, jplan)
        params = specs.abstract_params(cfg, plan, max_seq=16,
                                       dtype=torch.float32)
        assert all(p.device.type == "meta" for p in params.parameters())
        ax = axes.logical_axes(params)
        seen = set()
        for pname, p in params.named_parameters():
            path, stacked = port_path_in_ref(cfg, pname)
            leaf = ref_leaf(jtree, path)
            want_ax, want_shape = leaf.ax, leaf.v.shape
            if stacked:
                assert want_ax[0] is None
                want_ax, want_shape = want_ax[1:], want_shape[1:]
            assert ax[pname] == want_ax, pname
            assert tuple(p.shape) == tuple(want_shape), pname
            assert p.dtype == torch.float32
            assert leaf.v.dtype == np.float32
            seen.add(path)
        n_ref = len(jax.tree.leaves(jaxes.strip(jtree)))
        assert len(seen) == n_ref
        if mesh is not None:
            want = jspecs.param_shardings(jtree, jmesh(mesh),
                                          jplan.rules_dict)
            got = specs.param_shardings(params, ModelMesh.virtual(
                mesh, "meta"), plan.rules_dict)
            for pname, spec in got.items():
                path, stacked = port_path_in_ref(cfg, pname)
                w = as_tuple(ref_leaf(want, path))
                assert spec == (w[1:] if stacked else w), pname


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_and_input_shardings_match_the_reference(name):
    cfg, jcfg = get_arch(name), JARCHS[name]
    for mesh in (SINGLE, MULTI):
        for shape in ("decode_32k", "long_500k", "train_4k", "prefill_32k"):
            sh, jsh = SHAPES[shape], JSHAPES[shape]
            assert dataclasses.asdict(sh) == dataclasses.asdict(jsh)
            plan = rules.make_plan(cfg, mesh, sh.kind, sh.global_batch)
            jplan = jrules.make_plan(jcfg, mesh, jsh.kind, jsh.global_batch)
            got = specs.input_shardings(cfg, sh, plan)
            want = jspecs.input_shardings(jcfg, jsh, jplan, jmesh(mesh))
            assert got == {k: as_tuple(v) for k, v in want.items()}
            if sh.kind != "decode":
                continue
            cache_abs = jspecs.abstract_decode_cache(jcfg, jplan, 2, 64)
            want = jspecs.cache_shardings(jcfg, jplan, cache_abs,
                                          jmesh(mesh))
            got = specs.cache_shardings(cfg, plan)
            assert got == [tuple(as_tuple(s) for s in e) for e in want]


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "phi3-medium-14b",
                                  "minicpm3-4b", "jamba-v0.1-52b"])
def test_zero1_state_specs_match_the_reference(name):
    """``state_specs`` on the reference's own tree (its specs as tuples,
    its shapes as ``meta`` tensors) is ``==`` the reference's, leaf by
    leaf; on the port's parameters the unstacked leaves' moments are the
    reference's, and a layer's shard its first free dim over ``data``
    (the reference's stack dim has no counterpart in the port's layers)."""
    from jax.sharding import PartitionSpec as P
    cfg, jcfg = get_arch(name), JARCHS[name]
    for mesh in (SINGLE, MULTI):
        plan = rules.make_plan(cfg, mesh, "train", 256)
        jplan = jrules.make_plan(jcfg, mesh, "train", 256)
        jtree = ref_axes(name, jplan)
        jparam_specs = jaxes.specs_tree(jtree, jplan.rules_dict)
        jabs = jaxes.strip(jtree)
        paths, _ = jax.tree_util.tree_flatten_with_path(
            jparam_specs, is_leaf=lambda x: isinstance(x, P))
        leaves = jax.tree.leaves(jabs)
        names = [jax.tree_util.keystr(k) for k, _ in paths]
        port_specs = {n: as_tuple(sp) for n, (_, sp) in zip(names, paths)}
        port_abs = {n: torch.empty(leaf.shape, device="meta")
                    for n, leaf in zip(names, leaves)}
        for zero1 in (True, False):
            want = jts.state_specs(jparam_specs, jabs, jplan.batch_axes,
                                   mesh, zero1=zero1)
            got = ts.state_specs(port_specs, port_abs, plan.batch_axes,
                                 mesh, zero1=zero1)
            wm = jax.tree.leaves(want["opt"]["mu"],
                                 is_leaf=lambda x: isinstance(x, P))
            assert [got["opt"]["mu"][n] for n in names] == \
                [as_tuple(w) for w in wm]
            assert got["opt"]["nu"] == got["opt"]["mu"]
            assert got["params"] == port_specs
            assert got["opt"]["step"] == as_tuple(want["opt"]["step"])

            params = specs.abstract_params(cfg, plan, max_seq=16)
            mine = ts.mesh_state_specs(params, plan,
                                       ModelMesh.virtual(mesh, "meta"),
                                       zero1)
            for pname, spec in mine["opt"]["mu"].items():
                path, stacked = port_path_in_ref(cfg, pname)
                if not stacked:
                    assert spec == as_tuple(ref_leaf(want["opt"]["mu"],
                                                     path)), pname
            wq = next(n for n in mine["opt"]["mu"]
                      if n.endswith("attn.wq") or n.endswith("attn.w_uq")
                      or n.endswith("tm.w_r"))
            if zero1:
                assert mine["opt"]["mu"][wq] == (plan.rules_dict["batch"],
                                                 "model")


def test_padded_heads_are_inert():
    """The reference's poison test (``tests/test_sharding.py:78-102``)
    through the port: padding heads' q columns and out-projection rows
    at 99 change no logit."""
    cfg = get_arch("llama3-8b").reduced()
    plan = dataclasses.replace(rules.unpadded_plan(cfg), n_heads_padded=6)
    params = M.init_params(cfg, plan, seed=0, device="cpu", max_seq=16)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))}
    with torch.no_grad():
        l1, _, _ = M.forward(params, cfg, plan, batch, impl="ref")
        att = params.layers[0]["attn"]
        att["wq"][:, cfg.n_heads * cfg.head_dim:] = 99.0
        att["wo"][cfg.n_heads * cfg.head_dim:, :] = 99.0
        l2, _, _ = M.forward(params, cfg, plan, batch, impl="ref")
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-6, atol=1e-6)


def test_model_mesh_coordinates_and_groups():
    mesh = ModelMesh.virtual({"data": 2, "model": 4}, "cpu")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.coord(6) == {"data": 1, "model": 2}
    assert mesh.index({"data": 1, "model": 2}) == 6
    assert mesh.groups("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.groups(("data", "model")) == [list(range(8))]
    assert mesh.position(6, ("data", "model")) == 6
    assert mesh.position(6, ()) == 0
    assert mesh_mod.mesh_axes_dict(mesh) == {"data": 2, "model": 4}
    assert ModelMesh.virtual({"model": 2, "data": 1}).devices[0].type == \
        "cuda"
    assert mesh_mod.make_production_mesh().shape == SINGLE
    prod = mesh_mod.make_production_mesh(multi_pod=True)
    assert prod.shape == MULTI and prod.size == 512
    assert prod.devices[0].type == "meta"
    with pytest.raises(ValueError):
        ModelMesh((("model", 2), ("data", 2)), ("cpu",) * 4)
    with pytest.raises(ValueError):
        ModelMesh((("data", 2), ("model", 2)), ("cpu",) * 3)


def test_collectives_follow_the_reference_semantics():
    mesh = ModelMesh.virtual({"data": 2, "model": 3}, "cpu")
    xs = [torch.arange(12.0).reshape(6, 2) * (s + 1) for s in range(6)]
    ar = mesh_mod.collective("all_reduce", xs, mesh, "model")
    assert torch.equal(ar[1], xs[0] + xs[1] + xs[2])
    assert torch.equal(ar[4], xs[3] + xs[4] + xs[5])
    ag = mesh_mod.collective("all_gather", xs, mesh, "data", dim=1)
    assert torch.equal(ag[4], torch.cat([xs[1], xs[4]], 1))
    rs = mesh_mod.collective("reduce_scatter", xs, mesh, "model", dim=0)
    assert torch.equal(rs[2], (xs[0] + xs[1] + xs[2])[4:6])
    mx = mesh_mod.collective("max", [-x for x in xs], mesh, "model")
    assert torch.equal(mx[0], -xs[0])
    a2a = mesh_mod.collective("all_to_all", xs, mesh, "model", dim=0,
                              concat_dim=1)
    # member k receives chunk k of every sender, in sender order
    for k, s in enumerate((3, 4, 5)):
        want = torch.cat([xs[src][2 * k:2 * k + 2] for src in (3, 4, 5)], 1)
        assert torch.equal(a2a[s], want)
    back = mesh_mod.collective("all_to_all", a2a, mesh, "model", dim=1,
                               concat_dim=0)
    assert all(torch.equal(b, x) for b, x in zip(back, xs))
    with pytest.raises(ValueError):
        mesh_mod.collective("psum", xs, mesh, "model")


def test_shard_and_gather_params_round_trip():
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").reduced(),
                              n_heads=6, n_kv_heads=2, vocab_size=500,
                              n_experts=6)
    mesh = ModelMesh.virtual({"data": 2, "model": 4}, "cpu")
    plan = rules.make_plan(cfg, mesh.shape, "train", 2)
    params = M.init_params(cfg, plan, seed=1, device="cpu", max_seq=16)
    sp = specs.param_shardings(params, mesh, plan.rules_dict)
    shards = specs.shard_params(params, sp, mesh)
    wq = params.layers[1]["attn"]["wq"]
    blk = shards[6]["layers"][1]["attn"]["wq"]          # model 2 of 4
    assert blk.shape == (cfg.d_model, 2 * cfg.head_dim)
    assert blk.data_ptr() == wq[:, 4 * cfg.head_dim:].data_ptr()
    assert shards[1]["embed"]["table"].shape == (128, cfg.d_model)
    assert shards[3]["layers"][0]["moe"]["w_up"].shape[0] == 2
    back = specs.gather_params(shards, sp, mesh)
    for name, p in params.named_parameters():
        assert torch.equal(back[name], p), name
    with pytest.raises(ValueError):
        specs.param_shardings(params, ModelMesh.virtual(
            {"data": 2, "model": 4}, "cpu"), {**plan.rules_dict,
                                              "heads": "pod"})
