"""RWKV6, the Jamba hybrid and Whisper on the port's virtual model mesh
against the JAX reference's GSPMD-partitioned step, on the CPU.

As ``test_torch_model_axis.py`` does for the attention LMs: the port runs
on ``ModelMesh.virtual({"data": 2, "model": 4}, "cpu")``, the reference
once per module in a subprocess with eight fake CPU devices, on a (data
2, model 4) mesh of ``AxisType.Auto`` axes under ``set_mesh_compat`` and
``use_rules(plan.rules_dict)``: ``jax.jit`` of ``forward``,
``decode_step`` and ``make_train_step``, from the same float32
parameters (the port's ``init_params`` crossed by
``interop.params_to_numpy``) and inputs.

Three reduced variants keep each family's traits at model 4:

  * ``rwkv``: RWKV6 at ``d_model`` 96, six WKV heads of 16 -> 8 (two a
    shard, the padded heads on the last shard), vocab 500 -> 512;
  * ``jamba``: one 8-layer period (Mamba, GQA at position 4, MoE on the
    odd positions), 8 q heads over 4 KV heads (KV heads shard: kernel 5 a
    shard in decode), 8 experts top-2 (two a shard), ``di`` 128 (32
    channels a shard);
  * ``whisper``: 6 heads -> 8 (KV heads shard), 18 encoder frames (not a
    multiple of 4: the encoder's stream stays replicated while the
    decoder's 32 tokens are sequence-parallel), vocab 500 -> 512.

What each comparison holds (float32), as the attention LMs' file does:
logits within ``TOL`` of the largest; every shard's MoE dispatch buffers;
the decode caches after ``STEPS`` steps shard block by shard block (the
recurrent states of each shard against the reference's slice of its rows
and heads or channels); the train step's loss, moments (RWKV6's ``w_o``
and channel-mix ``w_r`` within ``MU_TOL``) and updated parameters. Whisper's cross caches on both sides
are filled from the encoder's output before the decode (``cross_kv``, as
``tests/test_torch_whisper.py`` fills them).
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
from repro_torch.launch import specs
from repro_torch.models import model as M
from repro_torch.models import parallel
from repro_torch.sharding.rules import make_plan
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from test_torch_model_axis import (
    LR,
    MESH,
    SHAPE,
    TOL,
    Recorder,
    check_step,
    close,
    flatten,
    same_dispatch,
)

REPO = Path(__file__).resolve().parent.parent
B, S, MAX_POS, MAX_SEQ, STEPS = 2, 32, 64, 16, 3
VARIANTS = {
    "rwkv": ("rwkv6-3b", dict(d_model=96, n_heads=6, n_kv_heads=6,
                              vocab_size=500)),
    "jamba": ("jamba-v0.1-52b", dict(n_heads=8, n_kv_heads=4,
                                     vocab_size=500, n_experts=8)),
    "whisper": ("whisper-base", dict(n_heads=6, n_kv_heads=6,
                                     vocab_size=500, enc_seq=18)),
}

# the first moments' bound, by leaf, where it is not ``TOL`` (of each
# leaf's largest): RWKV6's ``w_o`` and channel-mix ``w_r`` read 2.56e-5
# and 2.95e-5 from the reference (the WKV recurrence's backward through
# the per-head group norm; every other RWKV6 leaf within 1.6e-5, Jamba's
# within 1.1e-5, Whisper's within 8e-7), held at about twice that
MU_TOL = {"rwkv": {"layers/0/tm/w_o": 6e-5, "layers/0/cm/w_r": 6e-5}}

ORACLE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ARCHS
from repro.models import attention as JA
from repro.models import model as M
from repro.sharding.axes import use_rules
from repro.sharding.rules import make_plan
from repro.train.optimizer import OptConfig
from repro.train.train_step import (TrainConfig, init_train_state,
                                    make_train_step)
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
    batch = {"tokens": toks}
    if cfg.enc_dec:
        batch["enc_frames"] = jnp.asarray(io["enc_frames"])
    res = {}
    plans = {k: make_plan(cfg, SHAPE, k, spec["batch"])
             for k in ("prefill", "decode", "train")}
    pp = plans["prefill"]
    with set_mesh_compat(mesh), use_rules(pp.rules_dict):
        del records[:]
        lg, aux, _ = jax.jit(lambda p, b: M.forward(p, cfg, pp, b))(
            params, batch)
        res["fwd_logits"], res["fwd_aux"] = np.asarray(lg), np.asarray(aux)
        jax.effects_barrier()
        for i, (d, m, v) in enumerate(records):
            res[f"a2a/{d}/{m}/{i}"] = v
    pd = plans["decode"]
    with set_mesh_compat(mesh), use_rules(pd.rules_dict):
        cache = M.init_decode_cache(cfg, pd, spec["batch"], spec["max_seq"],
                                    jnp.float32)
        if cfg.enc_dec:
            enc = jax.jit(lambda p, f: M._encode(p, cfg, pd, f, "xla"))(
                params, batch["enc_frames"])
            lp = params["layers"][0]["xattn"]
            kv = [JA.cross_kv(jax.tree.map(lambda a: a[i], lp), cfg, pd, enc)
                  for i in range(cfg.n_layers)]
            cache[0] = cache[0][:2] + (jnp.stack([k for k, _ in kv]),
                                       jnp.stack([v for _, v in kv]))
        step = jax.jit(lambda p, t, c, pos: M.decode_step(p, cfg, pd, t, c,
                                                          pos))
        logits = []
        for pos in range(spec["steps"]):
            lg, cache = step(params, toks[:, pos:pos + 1], cache,
                             jnp.int32(pos))
            logits.append(np.asarray(lg))
        res["dec_logits"] = np.stack(logits)
        for i, entry in enumerate(cache):
            for j, c in enumerate(entry):
                res[f"dec_cache/{i}/{j}"] = np.asarray(c)
    pt = plans["train"]
    tcfg = TrainConfig(opt=OptConfig(lr=spec["lr"], warmup_steps=1))
    tbatch = dict(batch, labels=labels)
    with set_mesh_compat(mesh), use_rules(pt.rules_dict):
        state = init_train_state(params)
        state, met = jax.jit(make_train_step(cfg, pt, tcfg))(state, tbatch)
        res["train_loss"] = np.asarray(met["loss"])
        res["train_grad_norm"] = np.asarray(met["grad_norm"])
        for k, v in flat(state["params"]).items():
            res[f"train_params/{k}"] = v
        for k, v in flat(state["opt"]["mu"]).items():
            res[f"train_mu/{k}"] = v
    np.savez(os.path.join(out_dir, f"out_{name}.npz"), **res)
print(json.dumps({"ok": True}))
"""


def variant(name: str):
    arch, traits = VARIANTS[name]
    return dataclasses.replace(get_arch(arch).reduced(), **traits)


def inputs(name: str) -> dict:
    cfg = variant(name)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :5] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.enc_dec:
        out["enc_frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def batch_of(name: str, train: bool = False) -> dict:
    io = {k: torch.from_numpy(v) for k, v in inputs(name).items()}
    if not train:
        io.pop("labels")
    return io


def params_of(name: str):
    """The variant's padded float32 parameters on the CPU (seeded)."""
    cfg = variant(name)
    plan = make_plan(cfg, SHAPE, "train", B)
    return M.init_params(cfg, plan, seed=5, device="cpu", max_seq=MAX_POS,
                         dtype=torch.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run the reference once for every variant; ``{name: npz}``."""
    out = tmp_path_factory.mktemp("model_axis_families")
    for name in VARIANTS:
        tree = interop.params_to_numpy(variant(name), params_of(name))
        np.savez(out / f"params_{name}.npz", **flatten(tree))
        np.savez(out / f"inputs_{name}.npz", **inputs(name))
    (out / "spec.json").write_text(json.dumps({
        "variants": VARIANTS, "batch": B, "max_seq": MAX_SEQ,
        "steps": STEPS, "lr": LR}))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", ORACLE, str(out)],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    return {name: np.load(out / f"out_{name}.npz") for name in VARIANTS}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_family_forward_matches_the_reference(name, ref, monkeypatch):
    cfg, want = variant(name), ref[name]
    plan = make_plan(cfg, SHAPE, "prefill", B)
    rec = Recorder(monkeypatch)
    with torch.no_grad():
        logits, aux, _ = M.forward(params_of(name), cfg, plan,
                                   batch_of(name), impl="kernel", mesh=MESH)
    assert logits.shape == (B, S, plan.vocab_padded)
    close(logits, want["fwd_logits"])
    assert abs(float(aux) - float(want["fwd_aux"])) <= TOL * max(
        1.0, abs(float(want["fwd_aux"])))
    n_moe = sum(cfg.is_moe_layer(i % cfg.layer_period)
                for i in range(cfg.n_layers))
    assert len(rec.bufs) == n_moe
    ref_bufs = {}
    for key in want.files:
        if key.startswith("a2a/") and \
                want[key].shape[0] == plan.n_experts_padded:      # the first
            _, d, m, _ = key.split("/")
            ref_bufs.setdefault((int(d), int(m)), []).append(want[key])
    for s in range(MESH.size):
        c = MESH.coord(s)
        theirs = ref_bufs.get((c["data"], c["model"]), [])
        assert len(theirs) == n_moe
        for layer in rec.bufs:
            assert any(same_dispatch(layer[s].numpy(), t) for t in theirs), s


def _rows_and(mesh, s, spec, shape) -> tuple:
    """Shard ``s``'s slice of a global array of ``shape`` under ``spec``."""
    out = []
    for d, e in enumerate(spec):
        if e is None:
            out.append(slice(None))
        else:
            size = shape[d] // mesh.extent(e)
            k = mesh.position(s, e)
            out.append(slice(k * size, (k + 1) * size))
    return tuple(out)


def ref_state_entries(cfg, want) -> dict:
    """The reference's decode caches after the steps, as the port's kinds
    stack them: ``{kind: [stack, ...]}`` in layer order."""
    by_kind: dict = {}
    for li, kind in enumerate(M.layer_kinds(cfg)):
        pos = li % cfg.layer_period
        n = len([k for k in want.files if k.startswith(f"dec_cache/{pos}/")])
        entries = [want[f"dec_cache/{pos}/{j}"][li // cfg.layer_period]
                   for j in range(n)]
        by_kind.setdefault(kind, []).append(entries)
    return {k: [np.stack(e) for e in zip(*v)] for k, v in by_kind.items()}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_family_decode_matches_the_reference(name, ref):
    """``STEPS`` decode steps from zero caches laid out by
    ``cache_shardings`` (Whisper's cross caches filled first): logits at
    each step, then every shard's block of every cache stack against the
    reference's slice of it."""
    cfg, want = variant(name), ref[name]
    plan = make_plan(cfg, SHAPE, "decode", B)
    params = params_of(name)
    io = batch_of(name)
    toks = io["tokens"]
    caches = M.init_decode_cache(cfg, plan, B, MAX_SEQ, mesh=MESH)
    if cfg.enc_dec:
        with torch.no_grad():
            enc = M.encode(params, cfg, plan, io["enc_frames"], mesh=MESH)
        M.fill_cross_cache(params, cfg, plan, caches, enc, mesh=MESH)
    for pos in range(STEPS):
        logits, caches = M.decode_step(params, cfg, plan,
                                       toks[:, pos:pos + 1], caches, pos,
                                       mesh=MESH)
        close(logits, want["dec_logits"][pos])
    shapes = parallel.cache_shapes(cfg, plan, B, MAX_SEQ, torch.float32)
    theirs = ref_state_entries(cfg, want)
    assert set(shapes) == set(theirs) == set(caches[0])
    for kind, entries in shapes.items():
        for j, (_, _, spec) in enumerate(entries):
            full = theirs[kind][j]
            for s in range(MESH.size):
                got = caches[s][kind][j]
                blk = full[_rows_and(MESH, s, spec, full.shape)]
                close(got, blk, scale=max(np.abs(full).max(), 1e-30))
    if name == "rwkv":       # the last model shard holds the padded heads
        assert plan.n_heads_padded == 8 and cfg.n_rwkv_heads == 6
        assert caches[3]["rwkv"][1].shape[2] == 2


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_family_train_step_matches_the_reference(name, ref):
    """One AdamW step on the mesh with ZeRO-1 moments."""
    cfg, want = variant(name), ref[name]
    plan = make_plan(cfg, SHAPE, "train", B)
    params = params_of(name)
    spx = ts.mesh_state_specs(params, plan, MESH, zero1=True)
    state = ts.init_train_state(params, MESH, spx["opt"]["mu"])
    step = ts.make_train_step(cfg, plan, ts.TrainConfig(
        opt=opt.OptConfig(lr=LR, warmup_steps=1)), mesh=MESH)
    state, met = step(state, batch_of(name, train=True))
    assert abs(float(met["loss"]) - float(want["train_loss"])) <= TOL * \
        abs(float(want["train_loss"]))
    close(met["grad_norm"].reshape(1), want["train_grad_norm"].reshape(1))
    mu = state["opt"]["mu"]
    got_mu = {n: specs.assemble(blocks, mu.specs[n])
              for n, blocks in mu.blocks.items()}
    check_step(cfg, state["params"], got_mu, want, "train",
               MU_TOL.get(name))
    # the blocks the moments hold: the master tensors' standard chunks
    # (Mamba's w_in too: AdamW is elementwise), split over data by ZeRO-1
    if name == "jamba":
        assert mu.specs["layers.0.mamba.w_in"] == ("data", "model")
    if name == "rwkv":
        assert spx["params"]["layers.0.cm.w_r"] == (None, None)
        assert mu.specs["layers.0.cm.w_r"] == ("data", None)


def test_mamba_w_in_and_rwkv_head_blocks_are_the_reference_slices():
    """Each shard's blocks of the reference's own parameters (the arrays
    the oracle reads): Mamba's ``w_in`` holds its ``di/m`` columns of
    ``xin`` and of ``z`` (the slices GSPMD places on it after the split
    and ``constrain(xin, "mlp")``), two views of the padded weights, no
    copy; RWKV's head blocks its two heads of
    every ``heads`` leaf, the channel mix's ``w_r`` whole."""
    for name in ("jamba", "rwkv"):
        cfg = variant(name)
        plan = make_plan(cfg, SHAPE, "prefill", B)
        params = params_of(name)
        tree = flatten(interop.params_to_numpy(cfg, params))
        sps = parallel.sharded(params, plan, MESH)
        m = SHAPE["model"]
        for s in range(MESH.size):
            j = MESH.position(s, "model")
            lay0 = sps[s]["layers"][0]
            if name == "jamba":
                di, c = cfg.mamba_d_inner, cfg.mamba_d_inner // m
                w = tree["layers/0/mamba/w_in"][0]
                w_x, w_z = lay0["mamba"]["w_in"]
                assert np.array_equal(w_x.numpy(), w[:, j * c:(j + 1) * c])
                assert np.array_equal(w_z.numpy(),
                                      w[:, di + j * c:di + (j + 1) * c])
                master = dict(params.named_parameters())["layers.0.mamba.w_in"]
                for part in (w_x, w_z):
                    assert part.untyped_storage().data_ptr() == \
                        master.untyped_storage().data_ptr()
                a = tree["layers/0/mamba/a_log"][0]
                assert np.array_equal(lay0["mamba"]["a_log"].numpy(),
                                      a[j * c:(j + 1) * c])
            else:
                hs = cfg.rwkv_head_size
                c = plan.n_heads_padded // m * hs
                for leaf in ("w_r", "w_k", "w_v", "w_g", "w_lora_b"):
                    w = tree[f"layers/0/tm/{leaf}"][0]
                    assert np.array_equal(lay0["tm"][leaf].numpy(),
                                          w[:, j * c:(j + 1) * c]), leaf
                u = tree["layers/0/tm/u"][0]
                assert np.array_equal(lay0["tm"]["u"].numpy(),
                                      u[2 * j:2 * j + 2])
                assert np.array_equal(lay0["cm"]["w_r"].numpy(),
                                      tree["layers/0/cm/w_r"][0])
        back = specs.gather_params(sps, specs.param_shardings(
            params, MESH, plan.rules_dict), MESH)
        for n, p in params.named_parameters():
            assert torch.equal(back[n], p), n


def test_prefill_states_fill_the_mesh_decode_cache():
    """``forward(collect_cache=True)`` on the mesh, written by
    ``fill_decode_cache``: each shard's recurrent states are its blocks of
    the unsharded padded model's; then one step on both sides."""
    for name in ("rwkv", "jamba"):
        cfg = variant(name)
        params = params_of(name)
        toks = batch_of(name)["tokens"][:, :9]
        pp = make_plan(cfg, SHAPE, "prefill", B)
        pd = make_plan(cfg, SHAPE, "decode", B)
        with torch.no_grad():
            _, _, kvs = M.forward(params, cfg, pp, {"tokens": toks[:, :8]},
                                  mesh=MESH, collect_cache=True)
            _, _, one = M.forward(params, cfg, pp, {"tokens": toks[:, :8]},
                                  collect_cache=True)
        caches = parallel.fill_decode_cache(
            M.init_decode_cache(cfg, pd, B, MAX_SEQ, mesh=MESH), kvs, cfg,
            pd, MESH)
        dense = M.init_decode_cache(cfg, pd, B, MAX_SEQ, device="cpu")
        shapes = parallel.cache_shapes(cfg, pd, B, MAX_SEQ, torch.float32)
        for kind, stacks in zip(M.kinds_present(cfg), one):
            for j, t in enumerate(stacks):
                if kind == "attn":
                    dense[kind][j][:, :, :8] = t
                    continue
                dense[kind][j].copy_(t)
                spec = shapes[kind][j][2]
                for s in range(MESH.size):
                    # local MoE capacity in the mesh prefill changes the
                    # stream after the first MoE layer (jamba: layer 1):
                    # the first Mamba layer's states are the same function
                    n = 1 if name == "jamba" else t.shape[0]
                    close(caches[s][kind][j][:n],
                          t[_rows_and(MESH, s, spec, t.shape)][:n].numpy())
        if name == "jamba":   # its streams differ from layer 1 on
            continue
        got, _ = M.decode_step(params, cfg, pd, toks[:, 8:9], caches, 8,
                               mesh=MESH)
        want, _ = M.decode_step(params, cfg, pd, toks[:, 8:9], dense, 8)
        close(got, want.numpy())


def test_whisper_encoder_layout_follows_its_own_frames():
    """The encoder's 18 frames do not split over model 4: its stream stays
    replicated while the decoder's 32 tokens are sequence-parallel; the
    mesh's encoder output equals the unsharded one on every shard."""
    cfg = variant("whisper")
    plan = make_plan(cfg, SHAPE, "prefill", B)
    assert not parallel.Layout.of(MESH, plan, B, cfg.enc_seq).sp
    assert parallel.Layout.of(MESH, plan, B, S).sp
    params = params_of("whisper")
    frames = batch_of("whisper")["enc_frames"]
    with torch.no_grad():
        outs = M.encode(params, cfg, plan, frames, mesh=MESH)
        one = M.encode(params, cfg, plan, frames)
    for s, o in enumerate(outs):
        d = MESH.position(s, "data")
        close(o, one[d:d + 1].numpy())
