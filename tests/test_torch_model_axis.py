"""The port's tensor-parallel LM on a virtual model mesh against the JAX
reference's GSPMD-partitioned step, on the CPU.

The port runs on ``ModelMesh.virtual({"data": 2, "model": 4}, "cpu")``
(eight shards in turn). The reference runs once per module, in a
subprocess with eight fake CPU devices
(``--xla_force_host_platform_device_count=8``, ``JAX_PLATFORMS=cpu``), on
a (data 2, model 4) mesh of ``AxisType.Auto`` axes (``jax.make_mesh``'s
default ``Explicit`` axes turn the reference's sharding constraints into
asserts), under ``set_mesh_compat`` and ``use_rules(plan.rules_dict)``:
``jax.jit`` of ``forward``, ``decode_step`` and ``make_train_step``.
Both sides start from the same float32 parameters (the port's
``init_params`` crossed by ``interop.params_to_numpy``) and tokens.

Four reduced variants make every padding fire at model 4:

  * ``granite``: 6 q heads over 2 KV heads -> 8 / 2 by candidate B (KV
    replicated, so decode shards ``head_dim``), 6 experts top-2 -> 8,
    vocab 500 -> 512;
  * ``phi3``: 10 over 5 -> 12 / 6 by candidate A, KV repeated in prefill
    (``_maybe_repeat_kv``), ``head_dim`` decode;
  * ``moon``: Moonlight's shared experts, 8 over 4 heads (KV heads shard:
    the per-shard paged decode), 6 experts -> 8;
  * ``mla``: MiniCPM3's MLA, 6 heads -> 8.

Prefill runs 64 tokens a row (16 a shard's MoE: local capacity drops
pairs that ``apply_moe`` over the batch keeps). What each comparison
holds (float32): logits within ``TOL`` of the largest; the train step's
loss within ``TOL``, its moments within ``TOL`` of each leaf's largest and
the updated parameters within ``TOL`` where the moment is above 1e-3 of
its largest (elsewhere AdamW's first step moves a weight by up to ``lr``
in the sign of a gradient at rounding level, so within ``2 * LR``); decode
caches within ``TOL``; every shard's MoE dispatch buffers (the expert
choices, their ranks and the drops) ``==``, each slot's token within
``TOL``.

The same parameters off the mesh (the padded plan on one device) are held
to the reference's off-mesh functions, whose MoE takes ``apply_moe``
(``MOE_IMPL = "gspmd"``: with a mesh plan and no mesh its shard map reads
an empty mesh, ``KeyError: 'data'``). The sequence-sharded decode runs
under rules set by hand (``kv_seq: "model"``), on both sides.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import ModelMesh
from repro_torch.launch.specs import assemble
from repro_torch.models import model as M
from repro_torch.models import parallel
from repro_torch.sharding.rules import make_plan
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

REPO = Path(__file__).resolve().parent.parent
SHAPE = {"data": 2, "model": 4}
B, S, MAX_SEQ, STEPS = 2, 64, 16, 3
TOL = 2e-5
LR = 1e-2
VARIANTS = {
    "granite": ("granite-moe-3b-a800m",
                dict(n_heads=6, n_kv_heads=2, vocab_size=500, n_experts=6,
                     moe_top_k=2)),
    "phi3": ("phi3-medium-14b", dict(n_heads=10, n_kv_heads=5,
                                     vocab_size=500)),
    "moon": ("moonshot-v1-16b-a3b",
             dict(n_heads=8, n_kv_heads=4, vocab_size=500, n_experts=6,
                  moe_top_k=2)),
    "mla": ("minicpm3-4b", dict(n_heads=6, n_kv_heads=6, vocab_size=500)),
}
SEQ_VARIANT = "granite"       # the hand-set sequence-sharded decode

ORACLE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ARCHS
from repro.models import model as M
from repro.models import mlp as jmlp
from repro.sharding.axes import use_rules
from repro.sharding.rules import make_plan
from repro.train.optimizer import OptConfig
from repro.train.train_step import (TrainConfig, init_train_state,
                                    loss_fn, make_train_step)
from repro.utils import set_mesh_compat

out_dir = sys.argv[1]
spec = json.load(open(os.path.join(out_dir, "spec.json")))
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
SHAPE = {"data": 2, "model": 4}
records = []
a2a = jax.lax.all_to_all


def recording_a2a(x, *a, **k):
    jax.debug.callback(
        lambda d, m, v: records.append((int(d), int(m), np.asarray(v))),
        jax.lax.axis_index("data"), jax.lax.axis_index("model"), x)
    return a2a(x, *a, **k)


jax.lax.all_to_all = recording_a2a


def unflatten(z):
    tree = {}
    for key in z.files:
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(z[key])
    tree["layers"] = [tree["layers"][str(i)]
                      for i in range(len(tree["layers"]))]
    return tree


def flat(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) \
        else tree.items()
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


for name, (arch, traits) in spec["variants"].items():
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **traits)
    params = unflatten(np.load(os.path.join(out_dir, f"params_{name}.npz")))
    io = np.load(os.path.join(out_dir, f"inputs_{name}.npz"))
    toks, labels = jnp.asarray(io["tokens"]), jnp.asarray(io["labels"])
    res = {}
    plans = {k: make_plan(cfg, SHAPE, k, spec["batch"])
             for k in ("prefill", "decode", "train")}

    def run_decode(plan, steps, on_mesh):
        cache = M.init_decode_cache(cfg, plan, spec["batch"],
                                    spec["max_seq"], jnp.float32)
        step = jax.jit(lambda p, t, c, pos: M.decode_step(p, cfg, plan, t,
                                                          c, pos))
        logits = []
        for pos in range(steps):
            lg, cache = step(params, toks[:, pos:pos + 1], cache,
                             jnp.int32(pos))
            logits.append(np.asarray(lg))
        return np.stack(logits), cache

    pp = plans["prefill"]
    with set_mesh_compat(mesh), use_rules(pp.rules_dict):
        del records[:]
        lg, aux, _ = jax.jit(lambda p, b: M.forward(p, cfg, pp, b))(
            params, {"tokens": toks})
        res["fwd_logits"], res["fwd_aux"] = np.asarray(lg), np.asarray(aux)
        jax.effects_barrier()
        for i, (d, m, v) in enumerate(records):
            res[f"a2a/{d}/{m}/{i}"] = v
    pd = plans["decode"]
    with set_mesh_compat(mesh), use_rules(pd.rules_dict):
        res["dec_logits"], cache = run_decode(pd, spec["steps"], True)
        for i, c in enumerate(cache[0]):
            res[f"dec_cache/{i}"] = np.asarray(c)
    pt = plans["train"]
    tcfg = TrainConfig(opt=OptConfig(lr=spec["lr"], warmup_steps=1))
    batch = {"tokens": toks, "labels": labels}
    with set_mesh_compat(mesh), use_rules(pt.rules_dict):
        state = init_train_state(params)
        state, met = jax.jit(make_train_step(cfg, pt, tcfg))(state, batch)
        res["train_loss"] = np.asarray(met["loss"])
        res["train_aux"] = np.asarray(met["aux"])
        res["train_grad_norm"] = np.asarray(met["grad_norm"])
        for k, v in flat(state["params"]).items():
            res[f"train_params/{k}"] = v
        for k, v in flat(state["opt"]["mu"]).items():
            res[f"train_mu/{k}"] = v
    # the padded plan off the mesh: the MoE through apply_moe
    jmlp.MOE_IMPL = "gspmd"
    lg, aux, _ = jax.jit(lambda p, b: M.forward(p, cfg, pp, b))(
        params, {"tokens": toks})
    res["off_logits"], res["off_aux"] = np.asarray(lg), np.asarray(aux)
    res["off_dec_logits"], _ = run_decode(pd, spec["steps"], False)
    state = init_train_state(params)
    state, met = jax.jit(make_train_step(cfg, pt, tcfg))(state, batch)
    res["off_train_loss"] = np.asarray(met["loss"])
    for k, v in flat(state["params"]).items():
        res[f"off_train_params/{k}"] = v
    for k, v in flat(state["opt"]["mu"]).items():
        res[f"off_train_mu/{k}"] = v
    jmlp.MOE_IMPL = "shardmap"
    if name == spec["seq_variant"]:
        r = dict(pd.rules_dict, kv_seq="model", kv_dh=None)
        ps = dataclasses.replace(pd, rules=tuple(sorted(r.items())))
        with set_mesh_compat(mesh), use_rules(ps.rules_dict):
            res["seq_logits"], cache = run_decode(ps, spec["steps"], True)
            res["seq_cache/0"] = np.asarray(cache[0][0])
    np.savez(os.path.join(out_dir, f"out_{name}.npz"), **res)
print(json.dumps({"ok": True}))
"""


def variant(name: str):
    arch, traits = VARIANTS[name]
    return dataclasses.replace(get_arch(arch).reduced(), **traits)


def flatten(tree, prefix="") -> dict:
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        key = f"{prefix}{k}"
        out.update(flatten(v, key + "/") if isinstance(v, (dict, list))
                   else {key: v})
    return out


def inputs(name: str) -> dict:
    cfg = variant(name)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :5] = -1
    return {"tokens": toks, "labels": labels}


def params_of(name: str):
    """The variant's padded float32 parameters on the CPU (seeded)."""
    cfg = variant(name)
    plan = make_plan(cfg, SHAPE, "train", B)
    return M.init_params(cfg, plan, seed=3, device="cpu", max_seq=MAX_SEQ,
                         dtype=torch.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run the reference once for every variant; ``{name: npz}``."""
    out = tmp_path_factory.mktemp("model_axis")
    for name in VARIANTS:
        tree = interop.params_to_numpy(variant(name), params_of(name))
        np.savez(out / f"params_{name}.npz", **flatten(tree))
        np.savez(out / f"inputs_{name}.npz", **inputs(name))
    (out / "spec.json").write_text(json.dumps({
        "variants": VARIANTS, "batch": B, "max_seq": MAX_SEQ,
        "steps": STEPS, "lr": LR, "seq_variant": SEQ_VARIANT}))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", ORACLE, str(out)],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    return {name: np.load(out / f"out_{name}.npz") for name in VARIANTS}


MESH = ModelMesh.virtual(SHAPE, "cpu")


def close(got, want, tol=TOL, scale=None):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = want > -1e29                     # the padded vocab's -1e30
    assert np.array_equal(fin, got > -1e29)
    s = np.abs(want[fin]).max() if scale is None else scale
    err = np.abs(got[fin] - want[fin]).max() / max(s, 1e-30)
    assert err <= tol, err


def same_dispatch(mine: np.ndarray, theirs: np.ndarray) -> bool:
    """Two ``[E, cap, d]`` dispatch buffers hold the same tokens in the
    same slots: the occupied slots ``==`` (the choices, ranks and drops),
    each slot's token within ``TOL`` (the streams' rounding differs; two
    tokens differ by far more)."""
    occ = np.abs(mine).sum(-1) > 0
    if mine.shape != theirs.shape or \
            not np.array_equal(occ, np.abs(theirs).sum(-1) > 0):
        return False
    return bool(np.abs(mine - theirs).max() <= TOL * np.abs(theirs).max())


class Recorder:
    """Every shard's input to each first ``all_to_all`` (the dispatch
    buffers), through the port's one collective function."""

    def __init__(self, monkeypatch):
        self.bufs = []
        orig = mesh_mod.collective

        def rec(op, xs, mesh, axes, dim=0, concat_dim=None):
            if op == "all_to_all" and dim == 0:
                self.bufs.append([x.clone() for x in xs])
            return orig(op, xs, mesh, axes, dim, concat_dim)
        monkeypatch.setattr(mesh_mod, "collective", rec)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_mesh_forward_matches_the_reference(name, ref, monkeypatch):
    cfg, want = variant(name), ref[name]
    plan = make_plan(cfg, SHAPE, "prefill", B)
    rec = Recorder(monkeypatch)
    with torch.no_grad():
        logits, aux, _ = M.forward(params_of(name), cfg, plan,
                                   {"tokens": torch.from_numpy(
                                       inputs(name)["tokens"])},
                                   impl="kernel", mesh=MESH)
    assert logits.shape == (B, S, plan.vocab_padded)
    close(logits, want["fwd_logits"])
    assert abs(float(aux) - float(want["fwd_aux"])) <= TOL * max(
        1.0, abs(float(want["fwd_aux"])))
    # the dispatch buffers: one per MoE layer and shard, == the
    # reference's for that shard (as a multiset over its layers)
    ref_bufs = {}
    for key in want.files:
        if key.startswith("a2a/"):
            _, d, m, _ = key.split("/")
            if want[key].shape[0] == plan.n_experts_padded:   # the first
                ref_bufs.setdefault((int(d), int(m)), []).append(want[key])
    if not cfg.moe:
        assert not rec.bufs and not ref_bufs
        return
    assert len(rec.bufs) == cfg.n_layers
    kept = 0
    for s in range(MESH.size):
        c = MESH.coord(s)
        theirs = ref_bufs[(c["data"], c["model"])]
        assert len(theirs) == cfg.n_layers
        for layer in rec.bufs:
            mine = layer[s].numpy()
            assert any(same_dispatch(mine, t) for t in theirs), (name, s)
            kept += int((np.abs(mine).sum(-1) > 0).sum())
    # local capacity dropped pairs that apply_moe over the batch keeps
    n_pairs = cfg.n_layers * B * S * cfg.moe_top_k
    assert kept < n_pairs
    with torch.no_grad():
        off, _, _ = M.forward(params_of(name), cfg, plan, {
            "tokens": torch.from_numpy(inputs(name)["tokens"])}, impl="ref")
    assert float((off - logits).abs().max()) > 1e-2


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_mesh_decode_matches_the_reference(name, ref):
    """``STEPS`` decode steps from zero caches laid out by
    ``cache_shardings``: logits at each step and the caches after."""
    cfg, want = variant(name), ref[name]
    plan = make_plan(cfg, SHAPE, "decode", B)
    params = params_of(name)
    toks = torch.from_numpy(inputs(name)["tokens"])
    caches = M.init_decode_cache(cfg, plan, B, MAX_SEQ, mesh=MESH)
    for pos in range(STEPS):
        logits, caches = M.decode_step(params, cfg, plan,
                                       toks[:, pos:pos + 1], caches, pos,
                                       mesh=MESH)
        close(logits, want["dec_logits"][pos])
    spec = parallel.cache_spec(cfg, plan)
    full = []
    for which in (0, 1):
        blocks = {}
        for s in range(MESH.size):
            key = tuple(0 if e is None else MESH.position(s, e)
                        for e in spec)
            blocks.setdefault(key, caches[s]["attn"][which])
        full.append(assemble(blocks, spec))
    if cfg.attention == "mla":
        lat = cfg.kv_lora_rank
        close(full[0][..., 0, :lat], want["dec_cache/0"])
        close(full[0][..., 0, lat:], want["dec_cache/1"])
        assert torch.equal(full[1][..., 0, :], full[0][..., 0, :lat])
    else:
        assert plan.rules_dict["kv_heads" if name == "moon" else
                               "kv_dh"] == "model"
        close(full[0], want["dec_cache/0"])
        close(full[1], want["dec_cache/1"])


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_mesh_train_step_matches_the_reference(name, ref):
    """One AdamW step on the mesh with ZeRO-1 moments."""
    cfg, want = variant(name), ref[name]
    plan = make_plan(cfg, SHAPE, "train", B)
    params = params_of(name)
    specs = ts.mesh_state_specs(params, plan, MESH, zero1=True)
    state = ts.init_train_state(params, MESH, specs["opt"]["mu"])
    step = ts.make_train_step(cfg, plan, ts.TrainConfig(
        opt=opt.OptConfig(lr=LR, warmup_steps=1)), mesh=MESH)
    batch = {k: torch.from_numpy(v) for k, v in inputs(name).items()}
    state, met = step(state, batch)
    assert abs(float(met["loss"]) - float(want["train_loss"])) <= TOL * \
        abs(float(want["train_loss"]))
    close(met["grad_norm"].reshape(1), want["train_grad_norm"].reshape(1))
    mu = state["opt"]["mu"]
    # ZeRO-1: a layer's wq moment is split over data and model
    wq = "layers.0.attn." + ("w_uq" if cfg.attention == "mla" else "wq")
    assert specs["opt"]["mu"][wq] == ("data", "model")
    full_bytes = state["params"].get_parameter(wq).nbytes
    assert mu.blocks[wq][(0, 0)].nbytes * 8 == full_bytes
    assert all(mu.shard_bytes(s) == mu.shard_bytes(0) for s in range(8))
    got_mu = {pname: assemble(blocks, mu.specs[pname])
              for pname, blocks in mu.blocks.items()}
    check_step(cfg, state["params"], got_mu, want, "train")


def check_step(cfg, params, mu: dict, want, tag: str,
               mu_tol: dict | None = None) -> None:
    """The updated parameters and first moments (by name) against the
    reference's ``{tag}_params`` / ``{tag}_mu`` trees; the moments within
    ``TOL`` of each leaf's largest, or ``mu_tol[key]`` where given."""
    tree = flatten(interop.params_to_numpy(cfg, params))
    mu_tree = flatten(interop.params_to_numpy(cfg, _as_module(params, mu)))
    for key, got in tree.items():
        w, m_ref = want[f"{tag}_params/{key}"], want[f"{tag}_mu/{key}"]
        big = np.abs(m_ref) > 1e-3 * max(np.abs(m_ref).max(), 1e-30)
        assert np.abs(got - w)[big].max(initial=0.0) <= TOL, key
        assert np.abs(got - w).max() <= 2.1 * LR, key
        assert np.abs(mu_tree[key] - m_ref).max() <= (mu_tol or {}).get(
            key, TOL) * max(np.abs(m_ref).max(), 1e-30), key


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_padded_train_step_off_the_mesh_matches_the_reference(name, ref):
    """The single-device trainer under the padded plan against the
    reference's off-mesh step (its MoE through ``apply_moe``): a layer's
    norm scales decay, as the reference's stacked (2-D) leaves do."""
    cfg, want = variant(name), ref[name]
    plan = make_plan(cfg, SHAPE, "train", B)
    params = params_of(name)
    state = ts.init_train_state(params)
    step = ts.make_train_step(cfg, plan, ts.TrainConfig(
        opt=opt.OptConfig(lr=LR, warmup_steps=1)))
    batch = {k: torch.from_numpy(v) for k, v in inputs(name).items()}
    state, met = step(state, batch)
    assert abs(float(met["loss"]) - float(want["off_train_loss"])) <= \
        TOL * abs(float(want["off_train_loss"]))
    check_step(cfg, state["params"], state["opt"]["mu"], want, "off_train")


def _as_module(params, values: dict):
    """A copy of ``params`` holding ``values`` by name (to cross a
    moment tree with ``interop.params_to_numpy``)."""
    import copy
    out = copy.deepcopy(params)
    with torch.no_grad():
        for n, p in out.named_parameters():
            p.copy_(values[n])
    return out


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_padded_model_off_the_mesh_matches_the_reference(name, ref):
    """The mesh plan's padded model on one device: forward (its MoE
    through ``apply_moe``) and decode, against the reference's off-mesh
    functions on the same padded parameters; and the padded engine's
    prefill against the padded forward."""
    cfg, want = variant(name), ref[name]
    params = params_of(name)
    toks = torch.from_numpy(inputs(name)["tokens"])
    plan = make_plan(cfg, SHAPE, "prefill", B)
    with torch.no_grad():
        logits, aux, _ = M.forward(params, cfg, plan, {"tokens": toks})
        again = interop.params_from_numpy(
            cfg, interop.params_to_numpy(cfg, params), device="cpu")
        assert torch.equal(M.forward(again, cfg, plan, {"tokens": toks})[0],
                           logits)
    close(logits, want["off_logits"])
    assert abs(float(aux) - float(want["off_aux"])) <= TOL * max(
        1.0, abs(float(want["off_aux"])))
    pd = make_plan(cfg, SHAPE, "decode", B)
    caches = M.init_decode_cache(cfg, pd, B, MAX_SEQ, device="cpu")
    for pos in range(STEPS):
        lg, caches = M.decode_step(params, cfg, pd, toks[:, pos:pos + 1],
                                   caches, pos)
        close(lg, want["off_dec_logits"][pos])
    from repro_torch.serve.paged_lm import PagedLMEngine
    eng = PagedLMEngine(cfg, pd, params, page_size=8, n_pages=16,
                        max_seqs=1, max_pages_per_seq=4, device="cpu")
    assert eng.k_pool.shape[3] == (1 if cfg.attention == "mla" else
                                   pd.n_kv_heads_padded)
    assert eng.admit(0, toks[0, :8].numpy())
    step, _ = eng.decode(toks[:1, 8:9])
    with torch.no_grad():
        one, _, _ = M.forward(params, cfg, pd, {"tokens": toks[:1, :9]})
    close(step[0, 0], one[0, -1].numpy())


def test_sequence_sharded_decode_matches_the_reference(ref):
    """Rules set by hand put ``kv_seq`` on ``model``: the owner writes the
    token, each shard attends over its slots, the log-sum-exp merge."""
    cfg, want = variant(SEQ_VARIANT), ref[SEQ_VARIANT]
    pd = make_plan(cfg, SHAPE, "decode", B)
    r = dict(pd.rules_dict, kv_seq="model", kv_dh=None)
    plan = dataclasses.replace(pd, rules=tuple(sorted(r.items())))
    params = params_of(SEQ_VARIANT)
    toks = torch.from_numpy(inputs(SEQ_VARIANT)["tokens"])
    caches = M.init_decode_cache(cfg, plan, B, MAX_SEQ, mesh=MESH)
    assert caches[0]["attn"][0].shape[2] == MAX_SEQ // 4
    for pos in range(STEPS):
        logits, caches = M.decode_step(params, cfg, plan,
                                       toks[:, pos:pos + 1], caches, pos,
                                       mesh=MESH)
        close(logits, want["seq_logits"][pos])
    # slots 0..3 live on model shard 0 of each data row
    spec = parallel.cache_spec(cfg, plan)
    assert spec == (None, "data", "model", None, None)
    blocks = {}
    for s in range(MESH.size):
        key = tuple(0 if e is None else MESH.position(s, e) for e in spec)
        blocks.setdefault(key, caches[s]["attn"][0])
    close(assemble(blocks, spec), want["seq_cache/0"])
    assert float(caches[1]["attn"][0].abs().max()) == 0.0


def test_prefill_caches_fill_the_mesh_decode_cache():
    """``forward(collect_cache=True)`` on the mesh, written into the mesh
    decode cache by ``fill_decode_cache``, then one step: the unsharded
    padded model's step over the same K, V put together (the MoE layers'
    local routing in the mesh prefill makes its K, V its own), for the
    ``head_dim`` (granite) and KV-head (moon) layouts."""
    for name in ("granite", "moon"):
        cfg = variant(name)
        params = params_of(name)
        toks = torch.from_numpy(inputs(name)["tokens"])[:, :9]
        pp = make_plan(cfg, SHAPE, "prefill", B)
        pd = make_plan(cfg, SHAPE, "decode", B)
        with torch.no_grad():
            _, _, kvs = M.forward(params, cfg, pp, {"tokens": toks[:, :8]},
                                  mesh=MESH, collect_cache=True)
        caches = parallel.fill_decode_cache(
            M.init_decode_cache(cfg, pd, B, MAX_SEQ, mesh=MESH), kvs, cfg,
            pd, MESH)
        dense = M.init_decode_cache(cfg, pd, B, MAX_SEQ, device="cpu")
        for which in (0, 1):
            rows = []
            for d in range(SHAPE["data"]):
                row = [kvs[MESH.index({"data": d, "model": j})][0][which]
                       for j in range(SHAPE["model"])]
                rows.append(torch.cat(row, 3) if pd.kv_sharded else row[0])
            dense["attn"][which][:, :, :8] = torch.cat(rows, 1)
        got, _ = M.decode_step(params, cfg, pd, toks[:, 8:9], caches, 8,
                               mesh=MESH)
        want, _ = M.decode_step(params, cfg, pd, toks[:, 8:9], dense, 8)
        close(got, want.numpy())


def test_mesh_paths_refuse_what_they_do_not_run():
    """RWKV6 runs on the mesh now (its forward's shape here; its numbers
    in ``test_torch_model_axis_families.py``). Still refused: Whisper's
    decode under rules set by hand that keep its KV heads off ``model``
    (its cross cache would lie on ``head_dim``); a plan not made for the
    mesh; a batch the data axis does not split."""
    cfg = get_arch("rwkv6-3b").reduced()
    plan = make_plan(cfg, SHAPE, "prefill", B)
    rw = M.init_params(cfg, plan, seed=0, device="cpu", max_seq=MAX_SEQ)
    with torch.no_grad():
        logits, _, _ = M.forward(rw, cfg, plan, {
            "tokens": torch.zeros((2, 4), dtype=torch.int32)}, mesh=MESH)
    assert logits.shape == (2, 4, plan.vocab_padded)
    wh = get_arch("whisper-base").reduced()
    pd = make_plan(wh, SHAPE, "decode", B)
    r = dict(pd.rules_dict, kv_heads=None, kv_dh="model")
    hand = dataclasses.replace(pd, rules=tuple(sorted(r.items())))
    with pytest.raises(NotImplementedError, match="off the KV heads"):
        M.init_decode_cache(wh, hand, B, MAX_SEQ, mesh=MESH)
    with pytest.raises(NotImplementedError, match="off the KV heads"):
        M.decode_step(None, wh, hand, torch.zeros((2, 1), dtype=torch.int32),
                      None, 0, mesh=MESH)
    cfg = variant("phi3")
    params = params_of("phi3")
    with pytest.raises(ValueError, match="mesh plan"):
        M.forward(params, cfg, make_plan(cfg, None), {
            "tokens": torch.zeros((2, 4), dtype=torch.int32)}, mesh=MESH)
    with pytest.raises(ValueError, match="does not split"):
        M.forward(params, cfg, make_plan(cfg, SHAPE, "prefill"), {
            "tokens": torch.zeros((3, 4), dtype=torch.int32)}, mesh=MESH)
